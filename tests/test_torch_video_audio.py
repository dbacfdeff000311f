"""The port's video+audio+language `sum` eval step (bench.py's eval3 model at
tiny size) against the JAX package's, and its video and audio towers.

Tiny towers: `tiny_tower("video")` (T=4 frames of 2x2 patches, temporal
attention, without and with the temporal MLP) and `tiny_tower("audio")` (a
rectangular 2x3 grid); the language tower is the audio tower's text tower.
Params are built once in JAX and bridged into the port, inputs made with
numpy. Held against missm_tpu.train.step.make_eval_step,
missm_tpu.models.finetune.model_forward and
missm_tpu.models.tower.vision_features on the CPU, where the port's kernel
wrappers run their plain versions: f32 to 2e-5 abs / 1e-4 rel (the
summation order of the products differs), bf16 to 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models import tower as jtower
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train.step import make_eval_step as jax_make_eval_step
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models import tower as ttower
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train.step import make_eval_step

B, L, T = 6, 16, 4
ATOL, RTOL = 2e-5, 1e-4
FUSION = dict(fusion_type="sum", modality_types=("language", "video", "audio"),
              output_dims=3, feature_dims=24, fusion_dim=16)
MODS = ("video", "audio")

_jax_forward = jax.jit(jft.model_forward, static_argnums=1)
_jax_vision = jax.jit(jtower.vision_features, static_argnums=1)


def _configs(compute_dtype="float32"):
    jcfg = jft.ModelConfig(towers=tuple((m, jax_tiny_tower(m)) for m in MODS),
                           fusion=JaxFusionConfig(**FUSION),
                           compute_dtype=compute_dtype)
    tcfg = tft.ModelConfig(towers=tuple((m, tiny_tower(m)) for m in MODS),
                           fusion=FusionConfig(**FUSION),
                           compute_dtype=compute_dtype)
    return jcfg, tcfg


def _redrawn(tree, seed):
    """Every zero/one-initialised leaf (biases, LoRA B, LN) redrawn, so that
    each of them reaches the output."""
    rng = np.random.default_rng(seed)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(redraw, tree)


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _configs()
    tree = _redrawn(jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg)), 1)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax(tree, device="cpu"))


@pytest.fixture(scope="module")
def jax_eval_step():
    """One jitted JAX eval step for the module (one compile per input
    structure)."""
    return jax_make_eval_step(_configs()[0])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    ids = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    for i, n in enumerate(rng.integers(3, L + 1, size=B)):
        ids[i, 0] = 97
        ids[i, 1:n - 1] = rng.integers(1, 97, size=n - 2)
        ids[i, n - 1] = 98  # EOT: the highest id
        mask[i, :n] = 1
    mask[::2, 1] = 0  # so that the key bias reaches the pooled token
    video = rng.standard_normal((B, 3, T, 32, 32)).astype(np.float32)
    audio = rng.standard_normal((B, 3, 32, 48)).astype(np.float32)
    labels = rng.integers(0, 3, size=B).astype(np.int32)
    return ids, mask, video, audio, labels


def _missing(code):
    if code == "mixed":
        return np.array([0, 1, 2, 3, 2, 0], np.int32)
    return np.full(B, code, np.int32)


def _data(inputs, lang):
    ids, mask, video, audio, _ = inputs
    language = ids if lang == "ids" else {"input_ids": ids,
                                          "attention_mask": mask}
    return {"language": language, "video": video, "audio": audio}


def _jax(data):
    return jax.tree_util.tree_map(jnp.asarray, data)


@pytest.mark.parametrize("lang", ["ids", "mask"])
@pytest.mark.parametrize("code", [0, 1, 2, 3, "mixed"])
def test_eval3_step_matches_jax(params, inputs, jax_eval_step, code, lang):
    jparams, tparams = params
    jcfg, tcfg = _configs()
    data = _data(inputs, lang)
    labels, missing = inputs[4], _missing(code)

    ref_logits, _ = _jax_forward(jparams, jcfg, _jax(data),
                                 jnp.asarray(missing))
    got_logits, _ = tft.model_forward(tparams, tcfg, data, missing,
                                      device="cpu")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL, rtol=RTOL)

    ref = jax_eval_step(jparams, _jax(data), jnp.asarray(labels),
                        jnp.asarray(missing))
    got = make_eval_step(tcfg, device="cpu")(tparams, data, labels, missing)
    for key in ("loss", "loss_sum", "count", "probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_array_equal(got["preds"].numpy(),
                                  np.asarray(ref["preds"]))


def test_eval3_bf16_encoder_matches_jax(params, inputs):
    """bf16 encoder: the two frameworks round at other places, so the logits
    are held to 2e-2 (as the image+text model's, tests/test_torch_model.py)."""
    jparams, tparams = params
    jcfg, tcfg = _configs("bfloat16")
    data = _data(inputs, "mask")
    missing = _missing("mixed")
    ref, _ = _jax_forward(jparams, jcfg, _jax(data), jnp.asarray(missing))
    got, _ = tft.model_forward(tparams, tcfg, data, missing, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=2e-2)


def test_uint8_video_and_audio_dequantize_matches_jax(params, inputs):
    """uint8 [B, 3, T, H, W] video (and [B, 3, H, W] audio) through the
    dequantize path: channel axis 1."""
    jparams, tparams = params
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    data = {"language": inputs[0],
            "video": rng.integers(0, 256, size=(B, 3, T, 32, 32),
                                  dtype=np.uint8),
            "audio": rng.integers(0, 256, size=(B, 3, 32, 48),
                                  dtype=np.uint8)}
    missing = _missing("mixed")
    ref, _ = _jax_forward(jparams, jcfg, _jax(data), jnp.asarray(missing))
    got, _ = tft.model_forward(tparams, tcfg, data, missing, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 3, 5, 4), (2, 3, 4, 5, 6),
                                   (1, 2, 2, 2, 3, 4, 5)])
def test_dequantize_channel_axis_matches_jax(shape):
    """The channel axis is 1, but 4 for the 7-D retrieval-pair layout."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    ref = jft._dequantize(jnp.asarray(x), jnp.float32)
    got = tft._dequantize(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def _tower_params(modality, **overrides):
    jcfg = jax_tiny_tower(modality, **overrides)
    tree = jax.tree_util.tree_map(np.asarray, jtower.init_tower_params(
        jax.random.PRNGKey(5), jcfg))
    tree = _redrawn(tree, 6)
    return (jcfg, tiny_tower(modality, **overrides),
            jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax(tree, device="cpu"))


@pytest.mark.parametrize("temporal_mlp", [False, True])
@pytest.mark.parametrize("frames", [4, 2, 1])
def test_video_tower_matches_jax(temporal_mlp, frames):
    """vision_features of the video tower: [B, 3, T, H, W] input (T = the
    configured 4 frames, and 2, which takes the first 2 rows of the temporal
    embedding), and 4-D input as one frame (T = 1: no temporal embedding);
    LoRA on the temporal modules, none on the spatial attention."""
    jcfg, tcfg, jp, tp = _tower_params("video", temporal_mlp=temporal_mlp)
    block = tp["vision"]["blocks"][0]
    assert "lora_a" in block["tattn"]["q"] and "lora_a" not in block["attn"]["q"]
    assert ("tmlp" in block) == temporal_mlp
    if temporal_mlp:
        assert "lora_a" in block["tmlp"]["fc1"]
    rng = np.random.default_rng(7)
    shape = (3, 3, 32, 32) if frames == 1 else (3, 3, frames, 32, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    ref = _jax_vision(jp["vision"], jcfg.vision, jnp.asarray(x),
                      projection=jp["visual_projection"])
    got = ttower.vision_features(tp["vision"], tcfg.vision,
                                 torch.from_numpy(x),
                                 projection=tp["visual_projection"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_audio_tower_matches_jax():
    """The rectangular 2x3 grid (7 tokens) of the audio tower."""
    jcfg, tcfg, jp, tp = _tower_params("audio")
    assert tcfg.vision.seq_len == 7
    x = np.random.default_rng(8).standard_normal((3, 3, 32, 48)).astype(
        np.float32)
    ref = _jax_vision(jp["vision"], jcfg.vision, jnp.asarray(x),
                      projection=jp["visual_projection"])
    got = ttower.vision_features(tp["vision"], tcfg.vision,
                                 torch.from_numpy(x),
                                 projection=tp["visual_projection"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_video_tower_remat_matches_no_remat_with_grads():
    """Full per-block remat through the temporal branch changes nothing:
    the same output and the same gradients of the temporal LoRA factors."""
    _, tcfg, _, tp = _tower_params("video", temporal_mlp=True)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 3, T, 32, 32)).astype(np.float32))

    def run(remat):
        p = tft.tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
        out = ttower.vision_features(p["vision"], tcfg.vision, x, remat=remat,
                                     projection=p["visual_projection"])
        out.square().sum().backward()
        blocks = p["vision"]["blocks"]
        return out.detach(), [blocks[i][m][n]["lora_a"].grad
                              for i in range(len(blocks))
                              for m, n in (("tattn", "q"), ("tmlp", "fc2"))]

    out0, g0 = run(False)
    out1, g1 = run(True)
    torch.testing.assert_close(out1, out0, atol=0, rtol=0)
    for a, b in zip(g1, g0):
        assert a.abs().sum() > 0
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_tube3d_and_7d_input_run_as_jax():
    """The tube-3D video tower (tube 2 over the 4 frames: 2 tubes, a CLS
    each) and 7-D retrieval-pair input [b, pair, T, bs, C, H, W] on the video
    tower, against the JAX towers (tests/test_torch_towers.py holds their
    gradients and patch dropout)."""
    cfg = dataclasses.replace(tiny_tower("video").vision, use_tube3d=True,
                              tube_size=2)
    init = ttower.init_vision_params(torch.Generator(), cfg)
    assert init["class_embedding"].shape == (2, 32)
    assert init["patch_embedding"]["w"].shape == (3 * 2 * 16 * 16, 32)
    rng = np.random.default_rng(12)
    for overrides, shape in (
            (dict(use_tube3d=True, tube_size=2), (2, 3, 4, 32, 32)),
            ({}, (1, 2, 4, 2, 3, 32, 32))):
        jcfg, tcfg, jp, tp = _tower_params("video", **overrides)
        x = rng.standard_normal(shape).astype(np.float32)
        ref = _jax_vision(jp["vision"], jcfg.vision, jnp.asarray(x),
                          projection=jp["visual_projection"])
        got = ttower.vision_features(tp["vision"], tcfg.vision,
                                     torch.from_numpy(x),
                                     projection=tp["visual_projection"])
        videos = shape[0] * shape[1] * shape[3] if len(shape) == 7 else shape[0]
        assert got.shape == (videos, 24)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)
