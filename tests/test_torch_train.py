"""The port's train step (missm_tpu_torch.train) against the JAX package's.

Tiny image+text `sum` model in f32 on the CPU, params built once in JAX
(every zero/one-initialised leaf redrawn, so LoRA B is non-zero and every
LoRA A gradient is too) and bridged into the port; inputs made with numpy;
head dropout off so that both frameworks run the same function. Held
against missm_tpu.ops.basic.linear's exact-rank LoRA VJP,
missm_tpu.train.trainability and missm_tpu.train.step.make_train_step. The
JAX references are built once per module: each tiny JAX train step takes
tens of seconds to compile.

Tolerances: gradients differ only by the matmuls' summation order (f32), so
each leaf is held to 1e-4 of its own largest value, plus 1e-8 absolute for
the leaves whose true gradient is zero (the attention key projection's bias:
softmax ignores a per-query shift), which hold float noise of ~1e-10. The
loss is held to 1e-5 relative. Adam's update g / (sqrt(v) + eps) turns the
gradient noise into an error of the same relative size, except at elements
whose gradient is near zero, where the step can take either sign: the
updated params are held to 0.1 of one step (lr), and the zero-gradient
leaves only to the steps taken.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.ops.basic import linear as jax_linear
from missm_tpu.train import step as jstep
from missm_tpu.train import trainability as jtrain
from missm_tpu_torch.compat.from_jax import from_jax, to_numpy
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.ops.basic import dropout, linear
from missm_tpu_torch.train import step as tstep
from missm_tpu_torch.train import trainability as ttrain

B, L = 8, 16
LR = 1e-3
GRAD_RTOL = 1e-4      # of each leaf's largest |grad|
NOISE = 1e-8          # |grad| of a leaf whose true gradient is zero
PARAM_ATOL = 0.1 * LR
LOSS_RTOL = 1e-5
FUSION = dict(fusion_type="sum", modality_types=("language", "image"),
              output_dims=3, feature_dims=24, fusion_dim=16, dropout_prob=0.0)


def _configs(**fusion):
    kw = dict(FUSION, **fusion)
    jcfg = jft.ModelConfig(towers=(("image", jax_tiny_tower("image")),),
                           fusion=JaxFusionConfig(**kw))
    tcfg = tft.ModelConfig(towers=(("image", tiny_tower("image")),),
                           fusion=FusionConfig(**kw))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tree():
    """JAX init (numpy leaves) with every zero/one leaf redrawn."""
    jcfg, _ = _configs()
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


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 98, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate(rng.integers(4, L + 1, size=B)):
        ids[i, n - 1] = 98  # EOT: the highest id
        mask[i, n:] = 0
    mask[::2, 1] = 0       # a masked token before EOT reaches the logits
    data = {"language": {"input_ids": ids, "attention_mask": mask},
            "image": rng.standard_normal((B, 3, 32, 32)).astype(np.float32)}
    labels = rng.integers(0, 3, size=B).astype(np.int32)
    missing = np.array([0, 1, 4, 0, 4, 0, 1, 0], np.int32)
    return data, labels, missing


VALID = np.array([1, 1, 1, 1, 1, 0, 0, 0], bool)  # micro counts 2, 2, 1, 0


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


@pytest.fixture(scope="module")
def jax_runs(tree, batch):
    """The JAX package's gradient at the initial params and two Adam steps
    at accum_steps 1 and 4 (the second with and without a valid mask):
    {case: (grads, [(loss, params) after each step])}, all numpy."""
    jcfg, _ = _configs()
    data, labels, missing = batch
    jd = jax.tree_util.tree_map(jnp.asarray, data)
    jl, jm = jnp.asarray(labels), jnp.asarray(missing)
    params = jax.tree_util.tree_map(jnp.asarray, tree)

    treedef, trainable, frozen = jstep.partition_trainable(params, jcfg)

    @jax.jit
    def grads(trainable):
        def loss(tr):
            p = jstep.combine_params(treedef, tr, frozen)
            return jstep.compute_loss(p, None, jcfg, jd, jl, jm,
                                      jax.random.PRNGKey(0))[0]
        g = jax.grad(loss)(trainable)
        return jstep.combine_params(
            treedef, g, [None if f is None else jnp.zeros_like(f)
                         for f in frozen])

    runs = {"grads": _flat(jax.tree_util.tree_map(np.asarray,
                                                  grads(trainable)))}
    for case, A, valid in (("A1", 1, None), ("A4", 4, None),
                           ("A4_valid", 4, VALID)):
        state, tx = jstep.init_train_state(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg)
        step = jstep.make_train_step(jcfg, tx, accum_steps=A)
        kw = {} if valid is None else {"valid": jnp.asarray(valid)}
        out = []
        for i in range(2):
            state, m = step(state, jd, jl, jm, LR, jax.random.PRNGKey(i),
                            **kw)
            # copy out before the next step donates the state's buffers
            out.append((float(m["loss"]), _flat(jax.tree_util.tree_map(
                lambda a: np.array(a, copy=True), state.params))))
        runs[case] = out
    return runs


def _port_steps(tree, batch, A, valid=None, *, cfg=None, n=2, seed=0):
    """Two port steps from the bridged params: (grads of the first step,
    [(loss, params) after each step])."""
    tcfg = cfg or _configs()[1]
    params = from_jax(tree, device="cpu")
    state, tx = tstep.init_train_state(params, tcfg)
    step = tstep.make_train_step(tcfg, tx, accum_steps=A, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    data, labels, missing = batch
    out, grads = [], None
    for i in range(n):
        state, m = step(state, data, labels, missing, LR, gen, valid)
        if i == 0:
            grads = _flat(to_numpy(tft.tree_map(
                lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                params)))
        out.append((float(m["loss"]), _flat(to_numpy(params))))
    return grads, out


def _assert_grads(got, want):
    assert set(got) == set(want)
    for path, w in want.items():
        atol = GRAD_RTOL * float(np.abs(w).max()) + NOISE
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=path)


def _assert_steps(got, want, grads):
    for i, ((gl, gp), (wl, wp)) in enumerate(zip(got, want, strict=True)):
        assert gl == pytest.approx(wl, rel=LOSS_RTOL)
        assert set(gp) == set(wp)
        for path, w in wp.items():
            zero = float(np.abs(grads[path]).max()) < NOISE
            np.testing.assert_allclose(
                gp[path], w, rtol=0, err_msg=path,
                atol=(i + 1) * 2 * LR if zero else PARAM_ATOL)


# ---------------------------------------------------------------------------
# LoRA VJP and labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_trainable", [True, False])
def test_lora_linear_grads_match_jax(w_trainable):
    """ops.basic.linear's exact-rank LoRA VJP: dx, da, db (and the bias
    gradient) against jax.grad of missm_tpu.ops.basic.linear, and dw only
    when w is trainable; a frozen w costs no [in, out] product."""
    rng = np.random.default_rng(7)
    n_rows, d_in, d_out, r = 10, 16, 12, 2
    x, w, a, b, bias, cot = (
        rng.standard_normal(s).astype(np.float32) * c for s, c in
        (((2, 5, d_in), 1), ((d_in, d_out), .1), ((d_in, r), .1),
         ((r, d_out), .1), ((d_out,), .1), ((2, 5, d_out), 1)))

    def jloss(x, w, a, b, bias):
        p = {"w": w, "b": bias, "lora_a": a, "lora_b": b}
        return (jax_linear(p, x, lora_scaling=8.0) * cot).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(x, w, a, b, bias)
    t = [torch.from_numpy(v).requires_grad_() for v in (x, w, a, b, bias)]
    t[1].requires_grad_(w_trainable)
    with FlopCounterMode(display=False) as flops:
        y = linear({"w": t[1], "b": t[4], "lora_a": t[2], "lora_b": t[3]},
                   t[0], lora_scaling=8.0)
        (y * torch.from_numpy(cot)).sum().backward()
    for i, (got, ref) in enumerate(zip(t, want)):
        if i == 1 and not w_trainable:
            assert got.grad is None
            continue
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)
    # fold a@b and x@w_eff forward; dx, the fold again, da (2), db (2) and,
    # with w trainable, dw = x^T dy: 2 * n_rows * d_in * d_out FLOP
    base = 2 * (d_in * r * d_out * 2 + n_rows * d_in * d_out * 2
                + n_rows * d_out * r + n_rows * d_in * r
                + n_rows * d_in * r + n_rows * r * d_out)
    dw = 2 * n_rows * d_in * d_out
    assert flops.get_total_flops() == base + (dw if w_trainable else 0)


def test_param_labels_and_counts_match_jax(tree):
    jcfg, tcfg = _configs()
    jlabels = {}

    def walk(node, prefix, out):
        items = enumerate(node) if isinstance(node, list) else node.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v, f"{prefix}{k}/", out)
            else:
                out[f"{prefix}{k}"] = v

    # the JAX labels hold one label per [L, ...] stack
    walk(jtrain.param_labels(tree, jcfg), "", jlabels)
    params = from_jax(tree, device="cpu")
    labels = ttrain.param_labels(params, tcfg)
    flat = {}
    walk(labels, "", flat)
    assert set(flat) == set(_flat(tree))
    for path, label in flat.items():
        assert label == jlabels[re.sub(r"/blocks/\d+/", "/blocks/", path)]
    assert ttrain.count_params(params) == jtrain.count_params(tree)
    assert ttrain.count_trainable(params, labels) == jtrain.count_trainable(
        tree, jtrain.param_labels(tree, jcfg))
    # inside the LoRA'd blocks only lora_a / lora_b train
    block = labels["encoder"]["image"]["vision"]["blocks"][0]
    assert block["attn"]["q"] == {"w": "frozen", "b": "frozen",
                                  "lora_a": "train", "lora_b": "train"}
    assert block["mlp"]["fc1"] == {"w": "frozen", "b": "frozen"}


def test_cast_frozen_params_stores_only_frozen_leaves_in_bf16(tree):
    _, tcfg = _configs()
    params = from_jax(tree, device="cpu")
    with pytest.raises(ValueError):
        ttrain.cast_frozen_params(params, tcfg)  # compute_dtype float32
    cast = ttrain.cast_frozen_params(
        params, dataclasses.replace(tcfg, compute_dtype="bfloat16"))
    q = cast["encoder"]["image"]["vision"]["blocks"][1]["attn"]["q"]
    assert q["w"].dtype == torch.bfloat16 and q["lora_a"].dtype == torch.float32
    assert cast["fusion"]["head"]["fc1"]["w"].dtype == torch.float32
    assert cast["encoder"]["language"]["text"]["token_embedding"].dtype == (
        torch.float32)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("A", [1, 4])
def test_train_step_matches_jax(tree, batch, jax_runs, A):
    """Grads of the first step (accum 1 and 4 give the full-batch mean),
    then the loss and every param after each of two Adam steps."""
    grads, steps = _port_steps(tree, batch, A)
    _assert_grads(grads, jax_runs["grads"])
    _assert_steps(steps, jax_runs[f"A{A}"], jax_runs["grads"])
    # frozen leaves never move
    p0 = _flat(tree)
    w = "encoder/image/vision/blocks/1/mlp/fc1/w"
    np.testing.assert_array_equal(steps[-1][1][w], p0[w])


def test_train_step_valid_mask_matches_jax(tree, batch, jax_runs):
    """accum 4 with padded rows: microbatch counts 2, 2, 1, 0, each
    microbatch's mean weighted by its count (an all-padded microbatch
    weighs nothing)."""
    _, steps = _port_steps(tree, batch, 4, VALID)
    _assert_steps(steps, jax_runs["A4_valid"], jax_runs["grads"])


def test_train_step_rejects_a_batch_accum_does_not_divide(tree, batch):
    with pytest.raises(ValueError, match="not divisible"):
        _port_steps(tree, batch, 3, n=1)


def test_remat_gives_the_same_step(tree, batch):
    """Full remat and bench.py's train policy (save_attn_mlp_qkv_kern)
    change what the backward keeps, not the step."""
    _, tcfg = _configs()
    g0, s0 = _port_steps(tree, batch, 2)
    for remat in (True, "save_attn_mlp_qkv_kern"):
        g1, s1 = _port_steps(tree, batch, 2,
                             cfg=dataclasses.replace(tcfg, remat=remat))
        for path in g0:
            np.testing.assert_allclose(g1[path], g0[path], rtol=1e-6,
                                       atol=1e-9, err_msg=path)
        for (l0, p0), (l1, p1) in zip(s0, s1):
            assert l1 == pytest.approx(l0, rel=1e-6)
            for path in p0:
                np.testing.assert_allclose(p1[path], p0[path], rtol=0,
                                           atol=1e-2 * LR, err_msg=path)


# ---------------------------------------------------------------------------
# Head dropout: the port's generator, pinned by statistics
# ---------------------------------------------------------------------------


def test_head_dropout_same_seed_same_step(tree, batch):
    cfg = _configs(dropout_prob=0.1)[1]
    _, a = _port_steps(tree, batch, 2, cfg=cfg, seed=5)
    _, b = _port_steps(tree, batch, 2, cfg=cfg, seed=5)
    _, c = _port_steps(tree, batch, 2, cfg=cfg, seed=6)
    assert [loss for loss, _ in a] == [loss for loss, _ in b]
    for path in a[-1][1]:
        np.testing.assert_array_equal(a[-1][1][path], b[-1][1][path])
    assert [loss for loss, _ in a] != [loss for loss, _ in c]


def test_head_dropout_keep_rate_and_generator_only():
    n, rate = 200_000, 0.1
    state = torch.get_rng_state()
    gen = torch.Generator().manual_seed(0)
    y = dropout(torch.ones(n), rate, deterministic=False, generator=gen)
    assert torch.equal(torch.get_rng_state(), state)  # no global draw
    kept = int((y != 0).sum())
    # binomial(n, 0.9): 6 standard deviations
    assert abs(kept - n * (1 - rate)) <= 6 * (n * rate * (1 - rate)) ** 0.5
    assert torch.allclose(y[y != 0], torch.full((kept,), 1 / (1 - rate)))
    with pytest.raises(ValueError, match="Generator"):
        dropout(torch.ones(4), rate, deterministic=False)
