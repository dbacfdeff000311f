"""The port's fused LayerNorm -> linear (missm_tpu_torch.kernels.ln_linear,
K5) against the JAX package's (missm_tpu.kernels.ln_linear), on the CPU.

The JAX kernel runs in interpret mode; the port's wrapper runs its plain
version through the same autograd Function (and backward) that the card
runs. Inputs are made with numpy. Tolerances are the JAX package's own for
its kernel (tests/test_ln_linear.py): f32 forward 1e-4 abs / 1e-5 rel
(summation order), bf16 3e-2 (a bf16 ulp of the output, with the rounding
of the normalised activation at the same point on both sides), gradients
2e-3 abs / 1e-4 rel. The model tests run a tiny image+text model whose
widths pass the gate (hidden 128, FF 256) with the switch on, against the
JAX model_forward (2e-5 abs / 1e-4 rel, as tests/test_torch_model.py) and
against the port's own unfused train step (1e-5 of each leaf's largest
gradient, plus 1e-8 for the leaves whose true gradient is zero: f32, where
only the summation order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.kernels import ln_linear as jlnl
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.kernels import ln_linear as lnl
from missm_tpu_torch.kernels.launches import LAUNCHES
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train import step as tstep
from missm_tpu_torch.train.trainability import leaves

M, D, F = 64, 256, 512
EPS = 1e-5
F32_TOL = dict(atol=1e-4, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
GRAD_TOL = dict(atol=2e-3, rtol=1e-4)
# |grad| of a leaf whose true gradient is zero (the attention key bias:
# softmax ignores a per-query shift), as tests/test_torch_train.py
NOISE = 1e-8


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return dict(x=rng.standard_normal((M, D)).astype(np.float32),
                gamma=rng.standard_normal(D).astype(np.float32),
                beta=rng.standard_normal(D).astype(np.float32),
                w=(rng.standard_normal((D, F)) * 0.05).astype(np.float32),
                b=(rng.standard_normal(F) * 0.1).astype(np.float32))


def _params(a, bias, to):
    ln = {"scale": to(a["gamma"]), "bias": to(a["beta"])}
    lin = {"w": to(a["w"])}
    if bias:
        lin["b"] = to(a["b"])
    return ln, lin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_forward_matches_jax_kernel(arrays, bias, rank, dtype):
    """The plain version and the wrapper's forward against the JAX kernel in
    interpret mode, with and without bias, on [M, D] and [4, M/4, D]."""
    shape = (M, D) if rank == 2 else (4, M // 4, D)
    x = arrays["x"].reshape(shape)
    jdt = getattr(jnp, dtype)
    jln, jlin = _params(arrays, bias, lambda v: jnp.asarray(v, jdt))
    ref = jlnl.ln_linear(jnp.asarray(x, jdt), jln, jlin, eps=EPS,
                         interpret=True)
    tdt = getattr(torch, dtype)
    tln, tlin = _params(arrays, bias, lambda v: torch.from_numpy(v).to(tdt))
    xt = torch.from_numpy(x).to(tdt)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for fn in (lnl.ln_linear_plain, lnl.ln_linear):
        got = fn(xt, tln, tlin, EPS)
        assert got.dtype == tdt and got.shape == (*shape[:-1], F)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("bias", [True, False])
def test_gradients_match_jax(arrays, bias):
    """dx, dgamma, dbeta, dW and db of the wrapper against jax.grad through
    the JAX kernel's custom VJP (interpret mode), loss sum(sin(y))."""
    jln, jlin = _params(arrays, bias, jnp.asarray)

    def jloss(x, ln, lin):
        return jnp.sum(jnp.sin(jlnl.ln_linear(x, ln, lin, eps=EPS,
                                              interpret=True)))

    jx, jg_ln, jg_lin = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(arrays["x"]), jln, jlin)
    tln, tlin = _params(arrays, bias,
                        lambda v: torch.from_numpy(v).requires_grad_())
    x = torch.from_numpy(arrays["x"]).requires_grad_()
    torch.sin(lnl.ln_linear(x, tln, tlin, EPS)).sum().backward()
    pairs = [(x, jx), (tln["scale"], jg_ln["scale"]),
             (tln["bias"], jg_ln["bias"]), (tlin["w"], jg_lin["w"])]
    if bias:
        pairs.append((tlin["b"], jg_lin["b"]))
    for got, want in pairs:
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_frozen_weight_gets_no_weight_gradient(arrays):
    """A W without requires_grad gets no dW, and the backward runs one
    product (dln = dy W^T), not two: the frozen towers never pay for dW."""
    tln, tlin = _params(arrays, True, torch.from_numpy)
    x = torch.from_numpy(arrays["x"]).requires_grad_()
    y = lnl.ln_linear(x, tln, tlin, EPS)
    with FlopCounterMode(display=False) as flops:
        torch.sin(y).sum().backward()
    assert tlin["w"].grad is None and x.grad is not None
    assert flops.get_total_flops() == 2 * M * D * F


GATE_CASES = [((64, 256), 512, False), ((4, 16, 256), 512, False),
              ((64, 200), 512, False), ((64, 256), 500, False),
              ((60, 256), 512, False), ((3, 5, 128), 128, False),
              ((8, 128), 128, False), ((64, 256), 512, True),
              ((16, 77, 768), 3072, False), ((64, 257, 1024), 4096, False)]


@pytest.mark.parametrize("shape,f,lora", GATE_CASES)
def test_gate_matches_the_jax_shape_rule(monkeypatch, shape, f, lora):
    """ln_linear_available against the JAX package's rule, with the JAX
    package told it runs on a TPU (the clause the port drops)."""
    monkeypatch.setattr(jlnl.jax, "default_backend", lambda: "tpu")
    lin = {"w": np.zeros((shape[-1], f), np.float32)}
    if lora:
        lin.update(lora_a=np.zeros((shape[-1], 2), np.float32),
                   lora_b=np.zeros((2, f), np.float32))
    want = jlnl.ln_linear_available(np.zeros(shape, np.float32), lin)
    tlin = {k: torch.from_numpy(v) for k, v in lin.items()}
    assert lnl.ln_linear_available(torch.zeros(shape), tlin) == want


def test_switch_defaults_off():
    assert lnl.FUSE_LN2_FC1 is False and jlnl.FUSE_LN2_FC1 is False


# ---------------------------------------------------------------------------
# The block path: a tiny image+text model with the switch on
# ---------------------------------------------------------------------------

B, L = 8, 16       # image rows 8 * 5 = 40 and text rows 8 * 16: both % 8 == 0
FUSION = dict(fusion_type="sum", modality_types=("language", "image"),
              output_dims=3, feature_dims=24, fusion_dim=16, dropout_prob=0.0)
WIDE = dict(hidden_size=128, intermediate_size=256)  # passes the gate


def _configs(width):
    def tower(tiny):
        t = tiny("image", **(WIDE if width == 128 else {}))
        if width == 128:
            t = dataclasses.replace(t, text=dataclasses.replace(t.text, **WIDE))
        return t
    jcfg = jft.ModelConfig(towers=(("image", tower(jax_tiny_tower)),),
                           fusion=JaxFusionConfig(**FUSION))
    tcfg = tft.ModelConfig(towers=(("image", tower(tiny_tower)),),
                           fusion=FusionConfig(**FUSION))
    return jcfg, tcfg


def _tree(jcfg):
    """JAX init (numpy leaves) with every zero/one leaf redrawn, so biases,
    LN affines and LoRA B all reach the logits."""
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(redraw, tree)


def _batch():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 98, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate(rng.integers(4, L + 1, size=B)):
        ids[i, n - 1] = 98
        mask[i, n:] = 0
    mask[::2, 1] = 0
    data = {"language": {"input_ids": ids, "attention_mask": mask},
            "image": rng.standard_normal((B, 3, 32, 32)).astype(np.float32)}
    return (data, rng.integers(0, 3, size=B).astype(np.int32),
            np.array([0, 1, 4, 0, 4, 0, 1, 0], np.int32))


@pytest.fixture
def fused(monkeypatch):
    """The switch on, and a count of the fused calls the blocks make."""
    calls = []
    inner = lnl.ln_linear

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return inner(*args, **kwargs)

    monkeypatch.setattr(lnl, "ln_linear", counted)
    monkeypatch.setattr(lnl, "FUSE_LN2_FC1", True)
    return calls


def test_fused_model_matches_jax(fused):
    """Width 128 with the switch on: every block of both towers takes the
    fused path, and the f32 logits match the JAX model_forward's."""
    jcfg, tcfg = _configs(128)
    tree = _tree(jcfg)
    data, _, missing = _batch()
    ref, _ = jax.jit(jft.model_forward, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        jax.tree_util.tree_map(jnp.asarray, data), jnp.asarray(missing))
    got, _ = tft.model_forward(from_jax(tree, device="cpu"), tcfg, data,
                               missing, device="cpu")
    assert len(fused) == 4     # 2 image blocks + 2 text blocks
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-4)


def _grads(tree, tcfg):
    """The port's gradients of one f32 train step, leaf by leaf (None for
    a frozen leaf)."""
    params = from_jax(tree, device="cpu")
    state, tx = tstep.init_train_state(params, tcfg)
    step = tstep.make_train_step(tcfg, tx, accum_steps=1, device="cpu")
    data, labels, missing = _batch()
    step(state, data, labels, missing, 1e-3, torch.Generator().manual_seed(0))
    return [None if t.grad is None else t.grad.numpy().copy()
            for t in leaves(params)]


def test_fused_train_step_gradients_match_unfused(monkeypatch, fused):
    """Width 128: the train step's gradients with the switch on (the fused
    forward and its plain backward, dW of the text tower's fc1 among them)
    against the unfused step's, in f32."""
    jcfg, tcfg = _configs(128)
    tree = _tree(jcfg)
    on = _grads(tree, tcfg)
    assert len(fused) == 4
    monkeypatch.setattr(lnl, "FUSE_LN2_FC1", False)
    off = _grads(tree, tcfg)
    assert len(fused) == 4
    assert [g is None for g in on] == [g is None for g in off]
    assert sum(g is not None for g in on) > 0
    for i, (a, b) in enumerate(zip(on, off)):
        if b is not None:
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()) + NOISE,
                err_msg=str(i))


def test_switch_takes_no_fused_path_at_tiny_width(fused):
    """At tiny_tower's width 32 the gate refuses every block: the switch
    makes no fused call and changes nothing."""
    jcfg, tcfg = _configs(32)
    params = from_jax(_tree(jcfg), device="cpu")
    data, _, missing = _batch()
    LAUNCHES["ln_linear"] = 0
    got, _ = tft.model_forward(params, tcfg, data, missing, device="cpu")
    assert fused == [] and LAUNCHES["ln_linear"] == 0
    lnl.FUSE_LN2_FC1 = False
    ref, _ = tft.model_forward(params, tcfg, data, missing, device="cpu")
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# kernels.ln_linear.plan: what each bf16 launch of csrc/ln_linear.cu computes
# ---------------------------------------------------------------------------

# every ln2fc1 path's shape: eval image and text, train image and ragged text
PATH_SHAPES = [(16448, 1024, 4096), (4928, 768, 3072), (4112, 1024, 4096),
               (1232, 768, 3072)]
PLAN_M = (8, 56, 64, 72, 120, 128, 136, 1232, 4112, 16448)
PLAN_D = (128, 768, 1024)
PLAN_F = (128, 384, 3072, 4096)


def _check_plan(m, d, f):
    p = lnl.plan(m, d, f)
    assert p.fits and 2 <= p.stages <= lnl.MAX_STAGES
    assert p.smem_bytes <= lnl.SMEM_LIMIT
    assert p.stages == lnl.MAX_STAGES or lnl._smem(d, p.bn, p.stages + 1) \
        > lnl.SMEM_LIMIT
    assert f % p.bn == 0 and p.groups in lnl.ACTIVE_CLUSTERS
    # row tiles cover M once, the last ragged
    rows = [r for r0, n in p.row_tiles for r in range(r0, r0 + n)]
    assert rows == list(range(m)) and all(n <= lnl.ROWS for _, n in p.row_tiles)
    assert p.grid == len(p.row_tiles) * p.groups
    # the groups of a cluster walk every column tile once, and take every
    # row's statistics once
    cols = sorted(c for g in range(p.groups) for c in p.col_tiles(g))
    assert cols == list(range(0, f, p.bn))
    stats = sorted(r for g in range(p.groups) for r in p.stats_rows(g))
    assert stats == list(range(lnl.ROWS))
    assert all(len(p.col_tiles(g)) >= 1 for g in range(p.groups))
    return p


@pytest.mark.parametrize("m,d,f", PATH_SHAPES)
def test_plan_at_each_path_shape(m, d, f):
    _check_plan(m, d, f)


@pytest.mark.parametrize("m", PLAN_M)
@pytest.mark.parametrize("d", PLAN_D)
@pytest.mark.parametrize("f", PLAN_F)
def test_plan_fits_and_covers_every_tile_edge_once(m, d, f):
    _check_plan(m, d, f)


def test_plan_figures_of_the_source_note():
    """csrc/ln_linear.cu's note: the eval image shape takes 129 blocks of one
    row tile each, 16 column tiles of 256, three stages; the ragged train
    text [1232, 768] -> 3072 clusters of 8 with 128-wide tiles."""
    p = lnl.plan(16448, 1024, 4096)
    assert (p.bn, p.groups, p.stages, p.grid) == (256, 1, 3, 129)
    assert len(p.col_tiles(0)) == 16
    assert p.smem_bytes == 225_360
    p = lnl.plan(1232, 768, 3072)
    assert (p.bn, p.groups, p.grid) == (128, 8, 80)
    assert [len(p.col_tiles(g)) for g in range(8)] == [3] * 8
    assert lnl.plan(4928, 768, 3072).groups == 3


def test_plan_refuses_what_the_kernel_does_not_take():
    for m, d, f in ((0, 128, 128), (8, 200, 128), (8, 128, 300)):
        with pytest.raises(ValueError):
            lnl.plan(m, d, f)
    # gamma and beta as f32 grow with D: past ~16k columns two stages no
    # longer fit, and the wrapper raises on such a launch
    assert not lnl.plan(8, 16384, 256).fits
    assert lnl.plan(8, 8192, 256).fits
