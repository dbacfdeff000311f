"""The port's distillation losses and train steps (MTD_stu with its EMA
teacher, KL_stu, self_distill) against the JAX package's.

The losses: missm_tpu_torch.train.losses against missm_tpu.train.losses on
rows whose softmax(teacher / 0.15) underflows to exact zeros, value and
gradient. The steps: the tiny image+text model of tests/test_torch_train.py
in f32 on the CPU, params built once in JAX (every zero/one leaf redrawn,
so LoRA B is non-zero) and bridged into the port, head dropout off, two
Adam steps against missm_tpu.train.step.make_train_step with a `valid` mask
that pads rows (microbatch counts 3 and 2 at accum_steps 2). The four JAX
train steps compile once each, module-scoped.

Tolerances: the losses, 1e-5 relative; their gradients 1e-5 of the largest
|grad|. The steps, as tests/test_torch_train.py: the loss to 1e-5
relative; every param to 0.1 of one step (lr), except leaves whose
gradient is float noise (< 1e-8, the attention key bias), whose Adam steps
may take either sign, held to the steps taken; the EMA teacher to 1e-6
absolute, and to its own update rule t * 0.999 + s * 0.001 within 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.models.fusion import init_fusion as jax_init_fusion
from missm_tpu.train import losses as jlosses
from missm_tpu.train import step as jstep
from missm_tpu_torch.compat.from_jax import from_jax, to_numpy
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train import losses as tlosses
from missm_tpu_torch.train import step as tstep
from missm_tpu_torch.train.trainability import leaves

B, L = 8, 16
LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
NOISE = 1e-8
PARAM_ATOL = 0.1 * LR
EMA_ATOL = 1e-6
FUSION = dict(modality_types=("language", "image"), output_dims=3,
              feature_dims=24, fusion_dim=16, dropout_prob=0.0)
VALID = np.array([1, 1, 1, 0, 1, 1, 0, 0], bool)  # counts 3, 2 at A = 2
# (fusion type, accum_steps): four JAX compiles
CASES = [("MTD_stu", 2), ("KL_stu", 1), ("self_distill", 1),
         ("self_distill", 2)]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_inputs():
    """Student and teacher [6, 10]; teacher rows 0-3 spread so widely that
    softmax(t / 0.15) holds exact zeros."""
    rng = np.random.default_rng(0)
    s = rng.standard_normal((6, 10)).astype(np.float32)
    t = rng.standard_normal((6, 10)).astype(np.float32)
    t[:4] *= 40.0
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    return s, t, mask


LOSSES = {
    "kl_distill_loss": lambda m, s, t, mask: m.kl_distill_loss(s, t),
    "mse_loss": lambda m, s, t, mask: m.mse_loss(s, t),
    "masked_mse_loss": lambda m, s, t, mask: m.masked_mse_loss(s, t, mask),
    "masked_kl_distill": lambda m, s, t, mask: m.masked_kl_distill(s, t, mask),
}


def test_teacher_softmax_underflows():
    _, t, _ = _loss_inputs()
    p = torch.softmax(torch.from_numpy(t) / tlosses.KL_TEMPERATURE, dim=1)
    assert (p[:4] == 0).any(dim=1).all()


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name):
    s, t, mask = _loss_inputs()
    fn = LOSSES[name]
    want, (jgs, jgt) = jax.value_and_grad(
        lambda a, b: fn(jlosses, a, b, jnp.asarray(mask)), argnums=(0, 1))(
            jnp.asarray(s), jnp.asarray(t))
    ts = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    got = fn(tlosses, ts, tt, torch.from_numpy(mask))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    assert torch.isfinite(ts.grad).all()
    jgs = np.asarray(jgs)
    np.testing.assert_allclose(ts.grad.numpy(), jgs, rtol=0,
                               atol=GRAD_RTOL * np.abs(jgs).max())
    # the teacher is detached in both
    assert tt.grad is None and not np.asarray(jgt).any()


def test_masked_losses_of_an_empty_mask_are_zero():
    s, t, _ = _loss_inputs()
    none = torch.zeros(6, dtype=torch.bool)
    for fn in (tlosses.masked_mse_loss, tlosses.masked_kl_distill):
        out = fn(torch.from_numpy(s), torch.from_numpy(t), none)
        assert out.item() == 0.0


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def _configs(ftype):
    kw = dict(FUSION, fusion_type=ftype)
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**kw))
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**kw))
    return jcfg, tcfg


def _redraw(tree, seed):
    rng = np.random.default_rng(seed)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(redraw, tree)


@pytest.fixture(scope="module")
def trees():
    """{fusion type: (params, teacher_fusion or None)} as numpy JAX trees;
    MTD_stu and KL_stu share the distillation head's init."""
    out = {}
    for ft in ("MTD_stu", "self_distill"):
        jcfg, _ = _configs(ft)
        out[ft] = _redraw(jax.tree_util.tree_map(
            np.asarray, jft.init_model_params(jax.random.PRNGKey(0), jcfg)), 1)
    teacher = jax.tree_util.tree_map(np.asarray, jax_init_fusion(
        jax.random.PRNGKey(7),
        JaxFusionConfig(**dict(FUSION, fusion_type="Distill_tea"))))
    return {"MTD_stu": (out["MTD_stu"], teacher),
            "KL_stu": (out["MTD_stu"], teacher),
            "self_distill": (out["self_distill"], None)}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 98, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate(rng.integers(4, L + 1, size=B)):
        ids[i, n - 1] = 98  # EOT: the highest id
        mask[i, n:] = 0
    data = {"language": {"input_ids": ids, "attention_mask": mask},
            "image": rng.standard_normal((B, 3, 32, 32)).astype(np.float32)}
    labels = rng.integers(0, 3, size=B).astype(np.int32)
    missing = np.array([0, 1, 4, 0, 4, 0, 1, 0], np.int32)
    return data, labels, missing


def _flat(tree, prefix=""):
    """{path: array}, each [L, ...] block stack unrolled into L layers."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if k == "blocks":
            for p, a in _flat(v).items():
                for i in range(a.shape[0]):
                    out[f"{path}/{i}/{p}"] = a[i]
        elif isinstance(v, dict):
            out.update(_flat(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def jax_runs(trees, batch):
    """{(type, A): [(loss, params, teacher or None) after each step]}."""
    data, labels, missing = batch
    jd = jax.tree_util.tree_map(jnp.asarray, data)
    runs = {}
    for ft, A in CASES:
        jcfg, _ = _configs(ft)
        tree, teacher = trees[ft]
        state, tx = jstep.init_train_state(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
            teacher_fusion=None if teacher is None else
            jax.tree_util.tree_map(jnp.asarray, teacher))
        step = jstep.make_train_step(jcfg, tx, accum_steps=A)
        out = []
        for i in range(2):
            state, m = step(state, jd, jnp.asarray(labels),
                            jnp.asarray(missing), LR, jax.random.PRNGKey(i),
                            valid=jnp.asarray(VALID))
            # copy out before the next step donates the state's buffers
            out.append((float(m["loss"]), _flat(_copy(state.params)),
                        None if state.teacher_fusion is None
                        else _flat(_copy(state.teacher_fusion))))
        runs[(ft, A)] = out
    return runs


def _port_steps(ftype, A, trees, batch):
    """Two port steps: ([(loss, params, teacher)], the first step's grads,
    [teacher before each step])."""
    _, tcfg = _configs(ftype)
    tree, teacher = trees[ftype]
    params = from_jax(tree, device="cpu")
    state, tx = tstep.init_train_state(
        params, tcfg, teacher_fusion=None if teacher is None
        else from_jax(teacher, device="cpu"))
    step = tstep.make_train_step(tcfg, tx, accum_steps=A, device="cpu")
    gen = torch.Generator().manual_seed(0)
    data, labels, missing = batch
    out, grads, before = [], None, []
    for i in range(2):
        before.append(None if state.teacher_fusion is None
                      else _flat(to_numpy(state.teacher_fusion)))
        state, m = step(state, data, labels, missing, LR, gen, VALID)
        if i == 0:
            grads = _flat(to_numpy(tft.tree_map(
                lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                params)))
        out.append((float(m["loss"]), _flat(to_numpy(params)),
                    None if state.teacher_fusion is None
                    else _flat(to_numpy(state.teacher_fusion))))
    return out, grads, before


@pytest.mark.parametrize("ftype,A", CASES)
def test_distill_step_matches_jax(ftype, A, trees, batch, jax_runs):
    got, grads, before = _port_steps(ftype, A, trees, batch)
    want = jax_runs[(ftype, A)]
    for i, ((gl, gp, gt), (wl, wp, wt)) in enumerate(zip(got, want,
                                                         strict=True)):
        assert np.isfinite(gl)
        assert gl == pytest.approx(wl, rel=LOSS_RTOL), i
        assert set(gp) == set(wp)
        for path, w in wp.items():
            zero = float(np.abs(grads[path]).max()) < NOISE
            np.testing.assert_allclose(
                gp[path], w, rtol=0, err_msg=path,
                atol=(i + 1) * 2 * LR if zero else PARAM_ATOL)
        assert (gt is None) == (wt is None)
        if gt is None:
            continue
        assert set(gt) == set(wt)
        for path, w in wt.items():
            np.testing.assert_allclose(gt[path], w, rtol=0, atol=EMA_ATOL,
                                       err_msg=path)
            if ftype == "MTD_stu":  # the EMA toward the updated student
                np.testing.assert_allclose(
                    gt[path], before[i][path] * 0.999
                    + gp["fusion/" + path] * 0.001, rtol=0, atol=1e-7,
                    err_msg=path)
            else:  # KL_stu's teacher is fixed
                np.testing.assert_array_equal(gt[path], before[0][path])
    # frozen leaves never move
    w = "encoder/image/vision/blocks/1/mlp/fc1/w"
    np.testing.assert_array_equal(got[-1][1][w], _flat(trees[ftype][0])[w])


def test_teacher_is_a_copy_that_never_needs_a_gradient(trees, batch):
    """The state's teacher shares no storage with the student's params and
    needs no gradient; a teacher type without a teacher raises."""
    _, tcfg = _configs("MTD_stu")
    params = from_jax(trees["MTD_stu"][0], device="cpu")
    state, tx = tstep.init_train_state(params, tcfg,
                                       teacher_fusion=params["fusion"])
    for t, s in zip(leaves(state.teacher_fusion), leaves(params["fusion"])):
        assert not t.requires_grad and t.data_ptr() != s.data_ptr()
        assert torch.equal(t, s.detach())
    state, tx = tstep.init_train_state(params, tcfg)
    step = tstep.make_train_step(tcfg, tx, device="cpu")
    with pytest.raises(ValueError, match="teacher"):
        step(state, *batch, LR, torch.Generator())


def test_teacher_forward_records_nothing(trees, batch, monkeypatch):
    """The teacher's forward runs under no_grad: its attention calls see no
    tensor that needs a gradient, so nothing is recorded for them."""
    from missm_tpu_torch.kernels import attention as K

    recorded = []

    def spy(wrapper):
        def call(q, k, v, *a, **kw):
            recorded.append(torch.is_grad_enabled() and q.requires_grad)
            return wrapper(q, k, v, *a, **kw)
        return call

    # the wrappers, where autograd still sees the call (inside the custom
    # op's kernel it never does)
    monkeypatch.setattr(K, "attention", spy(K.attention))
    monkeypatch.setattr(K, "causal_attention", spy(K.causal_attention))
    _, tcfg = _configs("MTD_stu")
    tree, teacher = trees["MTD_stu"]
    params = from_jax(tree, device="cpu")
    state, tx = tstep.init_train_state(
        params, tcfg, teacher_fusion=from_jax(teacher, device="cpu"))
    data, labels, missing = batch
    tstep.make_train_step(tcfg, tx, device="cpu")(
        state, data, labels, missing, LR, torch.Generator())
    # 2 image + 2 text layers for the student and for the teacher
    assert len(recorded) == 8
    assert recorded.count(False) == 4
