"""Export in the port against the JAX package's, on the CPU:

- compat/export.py::export_tower_state_dict on bridged params equals
  missm_tpu/compat/export.py::export_tower_state_dict's output exactly
  (image, video with the temporal MLP, tube-3D), and the port's converter
  takes it back to the same params;
- eval/artifact.py: the port's artifact (torch.export, exported on the
  CPU) equals the port's Predictor bit for bit, and holds against the JAX
  artifact (missm_tpu/eval/artifact.py, StableHLO) on the same inputs:
  preds equal, probs within 1e-5 (the two frameworks' matmuls sum in
  another order). Every one of the 13 fusion heads, a full batch with
  mixed missing codes, a partial batch, and the default missing index.
- the kernel ops: torch.library.opcheck of every `missm` op on the CPU
  (schema, fake, autograd registration, traced dispatch), the fakes'
  shapes and types against the real CPU outputs on each route, and the
  ops' gradients against the JAX kernels run as the JAX package's own
  tests run them on the CPU (interpret mode);
- the cli.export -> cli.predict --artifact pair: tests/test_torch_cli.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.compat import export as jexport
from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.eval import artifact as jartifact
from missm_tpu.kernels import flash_attention as jflash
from missm_tpu.models import finetune as jft
from missm_tpu.models import fusion as jfusion
from missm_tpu.models import tower as jtower
from missm_tpu_torch.compat import convert as tconvert
from missm_tpu_torch.compat.export import export_tower_state_dict
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.eval import artifact as tartifact
from missm_tpu_torch.eval.predictor import Predictor
from missm_tpu_torch.kernels import attention as kernels
from missm_tpu_torch.kernels import ops
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig

B = 4
PROBS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# export_tower_state_dict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("modality,overrides", [
    ("image", {}), ("video", dict(temporal_mlp=True)),
    ("video", dict(use_tube3d=True, tube_size=2))],
    ids=["image", "video_tmlp", "tube3d"])
def test_export_tower_state_dict_equals_jax_and_round_trips(modality,
                                                            overrides):
    jcfg = jax_tiny_tower(modality, **overrides)
    tree = jax.tree_util.tree_map(np.asarray, jtower.init_tower_params(
        jax.random.PRNGKey(2), jcfg))
    want = jexport.export_tower_state_dict(tree, jcfg)
    tcfg = tiny_tower(modality, **overrides)
    params = from_jax(tree, device="cpu")
    got = export_tower_state_dict(params, tcfg)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    back = tconvert.convert_tower_state_dict(got, tcfg, device="cpu")
    flat_back = dict(_leaves(back))
    flat = dict(_leaves(params))
    assert set(flat_back) == set(flat)
    for k, t in flat.items():
        assert torch.equal(flat_back[k], t), k


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# Serving artifacts
# ---------------------------------------------------------------------------


def _configs(ftype):
    kw = dict(fusion_type=ftype, modality_types=("language", "image"),
              output_dims=3, feature_dims=24, fusion_dim=16)
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=jfusion.FusionConfig(**kw))
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**kw))
    return jcfg, tcfg


def _data(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 97, (B, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    for i, n in enumerate((16, 9, 12, 5)):
        ids[i, n - 1] = 98
        ids[i, n:] = 0
        mask[i, n:] = 0
    return {"language": {"input_ids": ids, "attention_mask": mask},
            "image": rng.integers(0, 256, (B, 3, 32, 32)).astype(np.uint8)}


@pytest.mark.parametrize("ftype", jfusion.FUSION_TYPES)
def test_artifact_equals_predictor_and_jax_artifact(ftype, tmp_path):
    """Each head's artifact: a full batch with mixed codes, a partial batch
    of 3 and the default missing index (all complete)."""
    jcfg, tcfg = _configs(ftype)
    tree = jax.tree_util.tree_map(np.asarray, jft.init_model_params(
        jax.random.PRNGKey(1), jcfg))
    params = from_jax(tree, device="cpu")
    data = _data(3)
    tartifact.export_artifact(params, tcfg, data, str(tmp_path / "t"),
                              device="cpu")
    jartifact.export_artifact(tree, jcfg, data, str(tmp_path / "j"))
    art = tartifact.load_artifact(str(tmp_path / "t"), device="cpu")
    jart = jartifact.load_artifact(str(tmp_path / "j"))
    pred = Predictor(params, tcfg, batch_size=B, device="cpu")
    part = {"language": {k: v[:3] for k, v in data["language"].items()},
            "image": data["image"][:3]}
    for batch, codes in ((data, np.array([0, 1, 4, 0], np.int32)),
                         (part, np.array([4, 0, 1], np.int32)),
                         (data, None)):
        preds, probs = art.predict_arrays(batch, codes)
        want_preds, want_probs = pred.predict_arrays(batch, codes)
        np.testing.assert_array_equal(preds, want_preds)
        np.testing.assert_array_equal(probs, want_probs)
        j_preds, j_probs = jart.predict_arrays(batch, codes)
        np.testing.assert_array_equal(preds, j_preds)
        np.testing.assert_allclose(probs, j_probs, rtol=0, atol=PROBS_ATOL)
    assert preds.shape == (B,) and probs.shape == (B, 3)
    assert art.manifest["num_classes"] == 3
    assert art.manifest["inputs"]["image"] == {"shape": [B, 3, 32, 32],
                                               "dtype": "uint8"}


class _DataMesh:
    """A mesh stand-in with a data axis of 3 (the check raises before any
    collective)."""
    mesh_dim_names = ("data", "model")

    def size(self, i):
        return 3 if i == 0 else 1


def test_artifact_rejects_what_it_cannot_serve(tmp_path):
    """A multi-device artifact needs a batch that its data axis divides,
    and as many ranks to serve it as it was exported for (JAX's
    messages); a batch past the artifact's size raises."""
    import json
    import os

    _, tcfg = _configs("sum")
    params = tft.init_model_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="batch 4 not divisible by the "
                                         "mesh's data axis 3"):
        tartifact.export_artifact(params, tcfg, _data(0), str(tmp_path),
                                  mesh=_DataMesh(), device="cpu")
    tartifact.export_artifact(params, tcfg, _data(0), str(tmp_path),
                              device="cpu")
    art = tartifact.load_artifact(str(tmp_path), device="cpu")
    big = {"language": {k: np.concatenate([v, v]) for k, v in
                        _data(0)["language"].items()},
           "image": np.concatenate([_data(0)["image"]] * 2)}
    with pytest.raises(ValueError, match="batch_size 4"):
        art.predict_arrays(big)
    manifest = os.path.join(str(tmp_path), tartifact.MANIFEST_FILE)
    with open(manifest) as f:
        m = json.load(f)
    assert m["num_devices"] == 1 and m["data_axis"] == "data"
    with open(manifest, "w") as f:
        json.dump(dict(m, num_devices=2), f)
    with pytest.raises(ValueError, match="exported for 2 devices; only 1 "
                                         "available"):
        tartifact.load_artifact(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------


def _qkv(rng, b, n, d, requires_grad=True):
    return [torch.from_numpy(rng.standard_normal((b, n, d)).astype(
        np.float32)).requires_grad_(requires_grad) for _ in range(3)]


def _pad_bias(b, n):
    kb = torch.zeros(b, 1, n)
    kb[0, 0, n - 3:] = torch.finfo(torch.float32).min
    return kb


def _op_cases():
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 9, 32)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    g = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    out, lse = torch.ops.missm.attention(qd, kd, vd, 2, True)
    x = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    ln = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((32,), (32,), (32, 16), (16,))]
    return {
        "attention-lse": ("attention", (q, k, v, 2, True)),
        "attention-nolse": ("attention", (qd, kd, vd, 2, False)),
        "attention_bwd": ("attention_bwd", (qd, kd, vd, out, lse, g, 2)),
        "causal_attention-kbias": ("causal_attention",
                                   (q, k, v, _pad_bias(2, 9).requires_grad_(),
                                    2)),
        "causal_attention-none": ("causal_attention", (q, k, v, None, 2)),
        "short_attention": ("short_attention", (q, k, v, 2)),
        "short_attention_bwd": ("short_attention_bwd", (qd, kd, vd, g, 2)),
        "ln_linear-bias": ("ln_linear", (x.requires_grad_(),
                                         *[t.requires_grad_() for t in ln],
                                         1e-5)),
        "ln_linear-nobias": ("ln_linear", (x, *ln[:3], None, 1e-5)),
    }


OP_CASES = tuple(_op_cases())


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck(case):
    name, args = _op_cases()[case]
    assert name in ops.OPS
    torch.library.opcheck(getattr(torch.ops.missm, name).default, args)


@pytest.mark.parametrize("case", OP_CASES)
def test_fake_shapes_and_types_equal_the_cpu_outputs(case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    name, args = _op_cases()[case]
    op = getattr(torch.ops.missm, name).default
    args = [a.detach() if torch.is_tensor(a) else a for a in args]
    real = op(*args)
    mode = FakeTensorMode()
    fakes = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
    with mode:
        fake = op(*fakes)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype) for t in fake] == [(t.shape, t.dtype)
                                                  for t in real]


def _interpret(monkeypatch):
    """The JAX kernels in Pallas interpret mode, as the JAX package's own
    tests run them on the CPU."""
    import jax.experimental.pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **kw: real(*a, **dict(kw, interpret=True)))


def test_op_gradients_match_the_jax_kernels(monkeypatch):
    """The gradients through missm::attention (K1's route: N = 257, heads of
    64 in pairs) and missm::causal_attention (with the key bias) against
    jax.grad of fused_attention_cls_ad / fused_attention_causal_ad in
    interpret mode."""
    _interpret(monkeypatch)
    rng = np.random.default_rng(4)
    b, n, h, d = 1, 257, 2, 128
    q, k, v = _qkv(rng, b, n, d)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))

    def jcls(q, k, v):
        out = jflash.fused_attention_cls_ad(q, k[:, :1], k[:, 1:], v[:, :1],
                                            v[:, 1:], h)
        return jnp.sum(out * g)

    want = jax.grad(jcls, argnums=(0, 1, 2))(jq, jk, jv)
    got = torch.autograd.grad(kernels.attention(q, k, v, h), (q, k, v),
                              torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-4)

    n = 77
    q, k, v = _qkv(rng, 2, n, d)
    kb = _pad_bias(2, n)
    g = rng.standard_normal((2, n, d)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t.detach().numpy()) for t in (q, k, v))

    def jcausal(q, k, v):
        return jnp.sum(jflash.fused_attention_causal_ad(
            q, k, v, jnp.asarray(kb.numpy()), h) * g)

    want = jax.grad(jcausal, argnums=(0, 1, 2))(jq, jk, jv)
    got = torch.autograd.grad(kernels.causal_attention(q, k, v, kb, h),
                              (q, k, v), torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-4)


def test_short_op_gradients_match_the_jax_kernel(monkeypatch):
    """missm::short_attention's gradient against jax.grad of the JAX
    package's block-diagonal kernel (fused_attention_ad(block_diag=T)) on
    the same instances packed 128 / T to a row, interpret mode."""
    _interpret(monkeypatch)
    rng = np.random.default_rng(5)
    m, t, h, d = 32, 8, 2, 128
    q, k, v = _qkv(rng, m, t, d)
    g = rng.standard_normal((m, t, d)).astype(np.float32)

    def packed(x):
        return x.reshape(m * t // 128, 128, d)

    def jshort(q, k, v):
        out = jflash.fused_attention_ad(packed(q), packed(k), packed(v), h, t)
        return jnp.sum(out.reshape(m, t, d) * g)

    want = jax.grad(jshort, argnums=(0, 1, 2))(
        *(jnp.asarray(x.detach().numpy()) for x in (q, k, v)))
    got = torch.autograd.grad(kernels.short_attention(q, k, v, h), (q, k, v),
                              torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=1e-4)
