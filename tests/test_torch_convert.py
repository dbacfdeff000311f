"""The port's LanguageBind checkpoint converter and LoRA injection
(missm_tpu_torch.compat.convert, models.tower.inject_lora,
cli.common.init_params) against the JAX package's
(missm_tpu.compat.convert.convert_tower_state_dict,
missm_tpu.models.tower.inject_lora), on the committed fixture checkpoints
tests/fixtures/lb_ckpt (five tiny towers and the reference towers'
activations, expected.npz).

- The port's conversion equals from_jax(JAX conversion) leaf for leaf,
  exactly (the same transposes and the same f32 resize matrices).
- The converted towers, through the production path init_params (convert,
  then inject LoRA), reproduce expected.npz at the tolerances of
  tests/test_checkpoint_fixture.py:61, 75, 80 (atol 5e-5, rtol 2e-4); the
  injected LoRA is a zero delta and sits where JAX puts it
  (test_checkpoint_fixture.py:83).
"""
import os

import jax
import numpy as np
import pytest
import torch

from missm_tpu.compat import convert as jconvert
from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import tower as jtower
from missm_tpu_torch.cli.common import (_load_torch_state_dict,
                                        build_model_config, init_params)
from missm_tpu_torch.compat import convert as tconvert
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import tower as ttower

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "lb_ckpt")
MODS = ["image", "video", "audio", "depth", "thermal"]
NAMES = {"image": "LanguageBind_Image", "video": "LanguageBind_Video",
         "audio": "LanguageBind_Audio", "depth": "LanguageBind_Depth",
         "thermal": "LanguageBind_Thermal"}
ATOL, RTOL = 5e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny, and the suite's workers
    share the cores (torch's default of one thread a core each makes them
    spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Args:
    modality_types = ["language", "image", "video", "audio", "depth",
                      "thermal"]
    model_scale = "tiny"
    init = "checkpoint"
    checkpoint_dir = FIX
    fusion_type = "sum"
    feature_dims = 24
    fusion_dim = 8
    dropout_prob = 0.1
    bf16 = False
    remat = False
    device = "cpu"


def _sd(modality):
    return torch.load(os.path.join(FIX, NAMES[modality], "pytorch_model.bin"),
                      map_location="cpu", weights_only=True)


def _assert_same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


@pytest.fixture(scope="module")
def converted():
    cfg = build_model_config(Args(), num_classes=3)
    params = init_params(Args(), cfg, seed=0)
    exp = dict(np.load(os.path.join(FIX, "expected.npz")))
    return cfg, params, exp


@pytest.mark.parametrize("modality", MODS)
def test_conversion_equals_jax(modality):
    sd = _sd(modality)
    want = from_jax(jax.tree_util.tree_map(
        np.asarray, jconvert.convert_tower_state_dict(
            sd, jax_tiny_tower(modality))), device="cpu")
    got = tconvert.convert_tower_state_dict(sd, tiny_tower(modality),
                                            device="cpu")
    _assert_same_tree(got, want)


def test_peft_names_and_lora_equal_jax():
    """A peft-wrapped state dict (`base_model.model.` prefix, base_layer,
    the default adapter's lora_A/lora_B) converts as JAX converts it, LoRA
    included."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in _sd("image").items():
        if "vision_model.encoder.layers" in k and ".self_attn.q_proj." in k:
            k = k.replace(".q_proj.", ".q_proj.base_layer.")
        sd["base_model.model." + k] = v
    for i in range(2):
        lp = f"base_model.model.vision_model.encoder.layers.{i}.self_attn.q_proj"
        sd[lp + ".lora_A.default.weight"] = torch.as_tensor(
            rng.standard_normal((2, 32)).astype(np.float32))
        sd[lp + ".lora_B.default.weight"] = torch.as_tensor(
            rng.standard_normal((32, 2)).astype(np.float32))
    want = from_jax(jax.tree_util.tree_map(
        np.asarray, jconvert.convert_tower_state_dict(
            sd, jax_tiny_tower("image"))), device="cpu")
    got = tconvert.convert_tower_state_dict(sd, tiny_tower("image"),
                                            device="cpu")
    _assert_same_tree(got, want)
    assert "lora_a" in got["vision"]["blocks"][1]["attn"]["q"]


@pytest.mark.parametrize("grid", [(2, 3), (3, 5), (4, 4), (6, 2)])
def test_resize_position_embedding_equals_jax(grid):
    pos = np.random.default_rng(1).standard_normal((1 + 16, 8)).astype(
        np.float32)
    want = jconvert.resize_position_embedding(pos, grid)
    got = tconvert.resize_position_embedding(torch.as_tensor(pos), grid)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_safetensors_checkpoint_converts_like_the_bin(tmp_path):
    from safetensors.torch import save_file

    sd = _sd("depth")
    os.makedirs(tmp_path / "LanguageBind_Depth")
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "LanguageBind_Depth" / "model.safetensors"))
    loaded = _load_torch_state_dict(str(tmp_path / "LanguageBind_Depth"))
    _assert_same_tree(
        tconvert.convert_tower_state_dict(loaded, tiny_tower("depth"),
                                          device="cpu"),
        tconvert.convert_tower_state_dict(sd, tiny_tower("depth"),
                                          device="cpu"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _load_torch_state_dict(str(tmp_path))


def test_tube3d_target_inflates_the_2d_checkpoint():
    """A Conv2d checkpoint into the tube-3D embedding (tube 2): the 2-D
    weights in tube slot 0, the next slot zero, the CLS token repeated a
    tube, exactly as JAX's converter inflates it
    (missm_tpu/compat/convert.py:144-158)."""
    sd = _sd("video")
    want = from_jax(jax.tree_util.tree_map(
        np.asarray, jconvert.convert_tower_state_dict(
            sd, jax_tiny_tower("video", use_tube3d=True, tube_size=2))),
        device="cpu")
    got = tconvert.convert_tower_state_dict(
        sd, tiny_tower("video", use_tube3d=True, tube_size=2), device="cpu")
    _assert_same_tree(got, want)
    w = got["vision"]["patch_embedding"]["w"].reshape(3, 2, 16, 16, -1)
    assert torch.equal(w[:, 0].reshape(3 * 16 * 16, -1),
                       tconvert.convert_tower_state_dict(
                           sd, tiny_tower("video"), device="cpu")
                       ["vision"]["patch_embedding"]["w"])
    assert not w[:, 1].any()
    assert got["vision"]["class_embedding"].shape == (2, 32)


@pytest.mark.parametrize("modality", MODS)
def test_vision_activation_parity(converted, modality):
    cfg, params, exp = converted
    tp = params["encoder"][modality]
    got = ttower.vision_features(tp["vision"], cfg.tower_dict[modality].vision,
                                 torch.as_tensor(exp[modality]),
                                 projection=tp["proj"])
    np.testing.assert_allclose(got.numpy(), exp[f"{modality}_features"],
                               atol=ATOL, rtol=RTOL)


def test_text_activation_parity(converted):
    """The language encoder aliases the last tower's (thermal's) text
    model, and not the others'."""
    cfg, params, exp = converted
    lp = params["encoder"]["language"]
    _, got = ttower.text_features(lp["text"], cfg.tower_dict["thermal"].text,
                                  torch.as_tensor(exp["ids"]),
                                  projection=lp["proj"])
    np.testing.assert_allclose(got.numpy(), exp["thermal_text_features"],
                               atol=ATOL, rtol=RTOL)
    for other in ("image", "video", "audio", "depth"):
        assert not np.allclose(got.numpy(), exp[f"{other}_text_features"],
                               atol=1e-3)


@pytest.mark.parametrize("modality", MODS)
def test_injected_lora_is_zero_delta_where_jax_puts_it(converted, modality):
    """B starts at zero (the converted forward is the LoRA-free reference's,
    checked above), A within peft's U(+-1/sqrt(fan_in)), and the adapters
    sit on the leaves and at the shapes JAX's inject_lora gives."""
    cfg, params, _ = converted
    tcfg = jax_tiny_tower(modality)
    jv = jtower.inject_lora(
        jax.random.PRNGKey(0),
        jconvert.convert_tower_state_dict(_sd(modality), tcfg)["vision"],
        tcfg.vision)
    want = from_jax(jax.tree_util.tree_map(np.asarray, jv), device="cpu")
    got = params["encoder"][modality]["vision"]

    def walk(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}[{i}]")
        else:
            assert g.shape == w.shape, path
            if path.endswith("lora_b"):
                assert not g.any(), path
            elif path.endswith("lora_a"):
                assert g.abs().max() <= 1 / np.sqrt(g.shape[0]), path
                assert g.any(), path
            else:
                assert torch.equal(g, w), path
    walk(got, want, modality)
    n_lora = sum("lora_a" in leaf for b in got["blocks"]
                 for mod in b.values() if isinstance(mod, dict)
                 for leaf in mod.values() if isinstance(leaf, dict))
    assert n_lora == 4 * len(got["blocks"])
    # each block draws its own A
    q = [b["tattn" if modality == "video" else "attn"]["q"]["lora_a"]
         for b in got["blocks"]]
    assert not torch.equal(q[0], q[1])
