"""The port's train step on the video+audio+language `sum` model (bench.py's
train3 at tiny size) against the JAX package's, and the per-tower remat
spec.

Tiny towers: `tiny_tower("video")` (T=4 frames of 2x2 patches, temporal
attention with LoRA, frozen spatial attention without it) and
`tiny_tower("audio")` (a rectangular 2x3 grid); the language tower is the
audio tower's text tower and trains in full. Params are built once in JAX
(every zero/one-initialised leaf redrawn, so LoRA B is non-zero and every
LoRA A gradient is too) and bridged into the port; inputs are made with
numpy; head dropout is off so that both frameworks run the same function.
Held against missm_tpu.train.step.make_train_step at accum_steps 1,
missm_tpu.train.trainability and missm_tpu.models.encoder._remat_for on the
CPU, where the port's kernel wrappers run their plain versions (the
temporal attention's gradient is short_attention_bwd_plain's).

Tolerances, as tests/test_torch_train.py's: each gradient to 1e-4 of its
leaf's largest value plus 1e-8 absolute (leaves whose true gradient is zero
hold float noise), the loss to 1e-5 relative, the params after each Adam
step to 0.1 of one step (lr).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models.encoder import _remat_for as jax_remat_for
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train import step as jstep
from missm_tpu.train import trainability as jtrain
from missm_tpu_torch.compat.from_jax import from_jax, to_numpy
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.kernels import attention as kernels
from missm_tpu_torch.models import finetune as tft
from missm_tpu_torch.models.encoder import _remat_for
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train import step as tstep
from missm_tpu_torch.train import trainability as ttrain

B, L, T = 4, 16, 4
LR = 1e-3
GRAD_RTOL = 1e-4      # of each leaf's largest |grad|
NOISE = 1e-8          # |grad| of a leaf whose true gradient is zero
PARAM_ATOL = 0.1 * LR
LOSS_RTOL = 1e-5
MODS = ("video", "audio")
FUSION = dict(fusion_type="sum", modality_types=("language", "video", "audio"),
              output_dims=3, feature_dims=24, fusion_dim=16, dropout_prob=0.0)


def _configs(**model):
    jcfg = jft.ModelConfig(towers=tuple((m, jax_tiny_tower(m)) for m in MODS),
                           fusion=JaxFusionConfig(**FUSION))
    tcfg = tft.ModelConfig(towers=tuple((m, tiny_tower(m)) for m in MODS),
                           fusion=FusionConfig(**FUSION), **model)
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
    """bench.py's train3 batch at tiny size: ids without a mask, f32 media,
    every missing code of the three modalities."""
    rng = np.random.default_rng(2)
    ids = np.zeros((B, L), np.int32)
    for i, n in enumerate(rng.integers(3, L + 1, size=B)):
        ids[i, 0] = 97
        ids[i, 1:n - 1] = rng.integers(1, 97, size=n - 2)
        ids[i, n - 1] = 98  # EOT: the highest id
    data = {"language": ids,
            "video": rng.standard_normal((B, 3, T, 32, 32)).astype(np.float32),
            "audio": rng.standard_normal((B, 3, 32, 48)).astype(np.float32)}
    labels = rng.integers(0, 3, size=B).astype(np.int32)
    missing = np.array([0, 1, 2, 3], np.int32)
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


@pytest.fixture(scope="module")
def jax_run(tree, batch):
    """The JAX package's gradient at the initial params, then two Adam steps
    at accum_steps 1: (grads, [(loss, params) after each step]), numpy."""
    jcfg, _ = _configs()
    data, labels, missing = batch
    jd = jax.tree_util.tree_map(jnp.asarray, data)
    jl, jm = jnp.asarray(labels), jnp.asarray(missing)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    treedef, trainable, frozen = jstep.partition_trainable(params, jcfg)

    def loss(tr):
        p = jstep.combine_params(treedef, tr, frozen)
        return jstep.compute_loss(p, None, jcfg, jd, jl, jm,
                                  jax.random.PRNGKey(0))[0]

    g = jax.jit(jax.grad(loss))(trainable)
    grads = _flat(jax.tree_util.tree_map(np.asarray, jstep.combine_params(
        treedef, g, [None if f is None else jnp.zeros_like(f)
                     for f in frozen])))
    state, tx = jstep.init_train_state(params, jcfg)
    step = jstep.make_train_step(jcfg, tx, accum_steps=1)
    out = []
    for i in range(2):
        state, m = step(state, jd, jl, jm, LR, jax.random.PRNGKey(i))
        # copy out before the next step donates the state's buffers
        out.append((float(m["loss"]), _flat(jax.tree_util.tree_map(
            lambda a: np.array(a, copy=True), state.params))))
    return grads, out


def _port_steps(tree, batch, cfg=None, n=2):
    """n port steps from the bridged params at accum_steps 1: (grads of the
    first step, [(loss, params) after each step])."""
    cfg = cfg or _configs()[1]
    params = from_jax(tree, device="cpu")
    state, tx = tstep.init_train_state(params, cfg)
    step = tstep.make_train_step(cfg, tx, accum_steps=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    data, labels, missing = batch
    out, grads = [], None
    for i in range(n):
        state, m = step(state, data, labels, missing, LR, gen)
        if i == 0:
            grads = _flat(to_numpy(tft.tree_map(
                lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
                params)))
        out.append((float(m["loss"]), _flat(to_numpy(params))))
    return grads, out


def test_train3_step_matches_jax(tree, batch, jax_run):
    """The first step's gradient of every leaf (frozen ones zero), then the
    loss and every param after each of two Adam steps; the frozen leaves
    (the video tower's spatial attention among them) never move, and each
    tower's trainable leaves do."""
    want_grads, want_steps = jax_run
    kernels.reset_launches()
    grads, steps = _port_steps(tree, batch)
    assert sum(kernels.LAUNCHES.values()) == 0  # CPU: the plain versions
    assert set(grads) == set(want_grads)
    for path, w in want_grads.items():
        atol = GRAD_RTOL * float(np.abs(w).max()) + NOISE
        np.testing.assert_allclose(grads[path], w, rtol=0, atol=atol,
                                   err_msg=path)
    for i, ((gl, gp), (wl, wp)) in enumerate(zip(steps, want_steps,
                                                 strict=True)):
        assert gl == pytest.approx(wl, rel=LOSS_RTOL)
        assert set(gp) == set(wp)
        for path, w in wp.items():
            zero = float(np.abs(want_grads[path]).max()) < NOISE
            np.testing.assert_allclose(
                gp[path], w, rtol=0, err_msg=path,
                atol=(i + 1) * 2 * LR if zero else PARAM_ATOL)
    p0, p2 = _flat(tree), steps[-1][1]
    v0 = "encoder/video/vision/blocks/0/"
    for frozen in (v0 + "attn/q/w", v0 + "tattn/q/w", v0 + "mlp/fc1/w",
                   "encoder/audio/vision/blocks/1/attn/out/w"):
        np.testing.assert_array_equal(p2[frozen], p0[frozen])
    for moved in (v0 + "tattn/q/lora_b", "encoder/video/vision/blocks/1/"
                  "tattn/out/lora_b", "encoder/audio/vision/blocks/0/attn/q/"
                  "lora_b", "encoder/video/vision/patch_embedding/w",
                  "encoder/audio/vision/patch_embedding/w",
                  "encoder/language/text/blocks/0/attn/q/w",
                  "fusion/proj/video/w", "fusion/proj/audio/w"):
        assert not np.array_equal(p2[moved], p0[moved]), moved


SPECS = [False, True, "save_attn_mlp", (("video", True),),
         (("video", "save_attn_mlp_qkv"), ("audio", "save_attn_mlp_kern"),
          ("language", "save_attn_mlp")),
         (("video", True), ("default", False)),
         {"audio": "save_attn", "default": False}, {"video": False}, ()]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_remat_for_matches_jax(spec):
    """One policy for every tower, a tuple of (modality, policy) pairs or a
    Mapping, with and without "default": the port resolves each tower's
    policy (and the language tower's) as the JAX package does."""
    for modality in ("video", "audio", "image", "language"):
        assert _remat_for(spec, modality) == jax_remat_for(spec, modality)


@pytest.mark.parametrize("spec", [(("video", True),),
                                  (("video", True), ("default", False))],
                         ids=["video_only_named", "video_only"])
def test_per_tower_remat_gives_the_same_step(tree, batch, spec):
    """A per-tower spec changes what is kept for the backward, not the step:
    the first gradient, the losses and the params of two steps equal those
    without remat (`(("video", True),)` remats every tower, since a tower
    the spec does not name gets True)."""
    _, tcfg = _configs()
    g0, s0 = _port_steps(tree, batch)
    g1, s1 = _port_steps(tree, batch, dataclasses.replace(tcfg, remat=spec))
    for path in g0:
        np.testing.assert_allclose(g1[path], g0[path], rtol=1e-6, atol=1e-9,
                                   err_msg=path)
    for (l0, p0), (l1, p1) in zip(s0, s1):
        assert l1 == pytest.approx(l0, rel=1e-6)
        for path in p0:
            np.testing.assert_allclose(p1[path], p0[path], rtol=0,
                                       atol=1e-2 * LR, err_msg=path)


BENCH_SPEC = (("video", "save_attn_mlp_qkv"), ("audio", "save_attn_mlp_kern"),
              ("language", "save_attn_mlp"))  # bench.py:208-210


def test_bench_remat_spec_step_matches_jax(tree, batch, jax_run):
    """bench.py's train3 spec of named policies: the first gradient against
    jax.grad of the JAX loss under the same spec, then the losses and the
    params of two steps against the JAX package's steps (remat changes
    what the backward keeps, not the step)."""
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, remat=BENCH_SPEC)
    data, labels, missing = batch
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    treedef, trainable, frozen = jstep.partition_trainable(params, jcfg)

    def loss(tr):
        p = jstep.combine_params(treedef, tr, frozen)
        return jstep.compute_loss(
            p, None, jcfg, jax.tree_util.tree_map(jnp.asarray, data),
            jnp.asarray(labels), jnp.asarray(missing),
            jax.random.PRNGKey(0))[0]

    g = jax.jit(jax.grad(loss))(trainable)
    want_grads = _flat(jax.tree_util.tree_map(np.asarray, jstep.combine_params(
        treedef, g, [None if f is None else jnp.zeros_like(f)
                     for f in frozen])))
    grads, steps = _port_steps(tree, batch,
                               dataclasses.replace(tcfg, remat=BENCH_SPEC))
    for path, w in want_grads.items():
        atol = GRAD_RTOL * float(np.abs(w).max()) + NOISE
        np.testing.assert_allclose(grads[path], w, rtol=0, atol=atol,
                                   err_msg=path)
    for i, ((gl, gp), (wl, wp)) in enumerate(zip(steps, jax_run[1],
                                                 strict=True)):
        assert gl == pytest.approx(wl, rel=LOSS_RTOL)
        for path, w in wp.items():
            zero = float(np.abs(want_grads[path]).max()) < NOISE
            np.testing.assert_allclose(
                gp[path], w, rtol=0, err_msg=path,
                atol=(i + 1) * 2 * LR if zero else PARAM_ATOL)


def test_three_tower_labels_match_jax(tree):
    """Inside both LoRA'd vision towers only lora_a / lora_b train: the video
    tower's temporal attention factors, the audio tower's spatial ones; its
    spatial attention, temporal embedding and tln1 are frozen."""
    jcfg, tcfg = _configs()
    jlabels = {}

    def walk(node, prefix, out):
        items = enumerate(node) if isinstance(node, list) else node.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v, f"{prefix}{k}/", out)
            else:
                out[f"{prefix}{k}"] = v

    walk(jtrain.param_labels(tree, jcfg), "", jlabels)
    labels = ttrain.param_labels(from_jax(tree, device="cpu"), tcfg)
    flat = {}
    walk(labels, "", flat)
    assert set(flat) == set(_flat(tree))
    for path, label in flat.items():
        layer = path.split("/blocks/")
        key = path if len(layer) == 1 else (
            layer[0] + "/blocks/" + layer[1].split("/", 1)[1])
        assert label == jlabels[key], path
    video = labels["encoder"]["video"]["vision"]["blocks"][0]
    assert video["tattn"]["q"] == {"w": "frozen", "b": "frozen",
                                   "lora_a": "train", "lora_b": "train"}
    assert video["attn"]["q"] == {"w": "frozen", "b": "frozen"}
    assert video["temporal_embedding"] == "frozen"
    audio = labels["encoder"]["audio"]["vision"]["blocks"][1]
    assert audio["attn"]["v"]["lora_b"] == "train"


def test_frozen_bf16_storage_gives_the_same_bf16_step(tree, batch):
    """bench.py's train3 stores the frozen leaves in bf16
    (cast_frozen_params): under a bf16 encoder the forward casts them to
    bf16 anyway, so two steps give bit-identical losses and trainable
    params, and the frozen leaves stay as they were stored."""
    _, tcfg = _configs(compute_dtype="bfloat16")

    def run(cast):
        params = from_jax(tree, device="cpu")
        if cast:
            params = ttrain.cast_frozen_params(params, tcfg)
        stored = [t.clone() for t in ttrain.leaves(params)]
        state, tx = tstep.init_train_state(params, tcfg)
        step = tstep.make_train_step(tcfg, tx, device="cpu")
        data, labels, missing = batch
        losses = [float(step(state, data, labels, missing, LR,
                             torch.Generator().manual_seed(0))[1]["loss"])
                  for _ in range(2)]
        return losses, params, stored

    l0, p0, _ = run(False)
    l1, p1, stored = run(True)
    assert l1 == l0
    flat0, flat1 = ttrain.leaves(p0), ttrain.leaves(p1)
    for a, b, s, label in zip(flat0, flat1, stored, ttrain.leaves(
            ttrain.param_labels(p1, tcfg))):
        if label == ttrain.FROZEN:
            assert b.dtype == torch.bfloat16 and torch.equal(b, s)
            assert torch.equal(b, a.to(torch.bfloat16))
        else:
            assert b.dtype == torch.float32 and torch.equal(b, a)
