"""The JAX side of the port's parallel tests: the JAX package's
single-device f32 train step and eval forward on unsharded params, which
JAX's own tests pin every layout to (tests/test_pipeline.py,
test_pipeline_1f1b.py, test_fsdp_odd.py). The JAX layouts themselves are
not run: XLA:CPU can interlock their collectives (tests/fsdp_tp_worker.py).

Tolerances (f32): logits and losses atol 1e-5; each param after one Adam
step atol 1e-5 at LR = 1e-4 (the first Adam step moves an element by about
LR, so a gradient of the wrong sign shows as 2e-4). The attention key
bias's true gradient is zero (softmax ignores a per-query shift): both
frameworks step it on float noise, so those leaves are held to 2 LR, the
most one noise-driven step can move them.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import finetune as jft
from missm_tpu.models.fusion import FusionConfig as JaxFusionConfig
from missm_tpu.train import step as jstep

LR = 1e-4
ATOL = 1e-5


def jax_config(towers, fusion, layers=None, vision_kw=None):
    over = dict(vision_kw or {})
    if layers is not None:
        over["num_layers"] = layers
    tcfg = []
    for m in towers:
        t = jax_tiny_tower(m, **over)
        if layers is not None:
            t = dataclasses.replace(t, text=dataclasses.replace(
                t.text, num_layers=layers))
        tcfg.append((m, t))
    return jft.ModelConfig(towers=tuple(tcfg),
                           fusion=JaxFusionConfig(**fusion))


def redrawn_tree(jcfg, seed=0):
    """JAX init (numpy leaves) with every zero/one leaf redrawn, so LoRA B
    is non-zero and every LoRA A gradient too."""
    tree = jax.tree_util.tree_map(
        np.asarray, jft.init_model_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(1)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x
    return jax.tree_util.tree_map(redraw, tree)


def jax_reference(jcfg, tree, batch, accums=(1, 2)):
    """{"logits": eval logits, A: (loss, params after one step)} of the JAX
    single-device step, numpy."""
    data, labels, missing = batch
    jd = jax.tree_util.tree_map(jnp.asarray, data)
    jl, jm = jnp.asarray(labels), jnp.asarray(missing)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    logits, _ = jax.jit(lambda p, d, m: jft.model_forward(p, jcfg, d, m))(
        params, jd, jm)
    out = {"logits": np.asarray(logits), "init": tree}
    for A in accums:
        state, tx = jstep.init_train_state(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg)
        step = jstep.make_train_step(jcfg, tx, accum_steps=A)
        state, m = step(state, jd, jl, jm, LR, jax.random.PRNGKey(0))
        out[A] = (float(m["loss"]), jax.tree_util.tree_map(
            lambda a: np.array(a, copy=True), state.params))
    return out


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def assert_world_matches(results, ref, accums=(1, 2), changed=()):
    """Every rank's logits rows, and rank 0's loss and full params after
    each step, against the JAX reference; `changed` path suffixes must have
    moved in the step (the adapted leaves)."""
    for r in results:
        n = len(r["logits"])
        rows = ref["logits"][r["data_index"] * n:(r["data_index"] + 1) * n]
        np.testing.assert_allclose(r["logits"], rows, rtol=0, atol=ATOL)
    for i, A in enumerate(accums):
        want_loss, want = ref[A]
        loss, got, _ = results[0]["steps"][i]
        assert abs(loss - want_loss) <= ATOL, (A, loss, want_loss)
        for r in results:
            assert abs(r["steps"][i][0] - want_loss) <= ATOL
        got_leaves = dict(_leaves(got))
        want_leaves = dict(_leaves(want))
        assert set(got_leaves) == set(want_leaves)
        for path, w in want_leaves.items():
            atol = 2 * LR if path.endswith("/k/b") else ATOL
            np.testing.assert_allclose(got_leaves[path], w, rtol=0,
                                       atol=atol, err_msg=f"A={A} {path}")
    init = dict(_leaves(ref["init"])) if "init" in ref else None
    if init is not None:
        final = dict(_leaves(results[0]["steps"][0][1]))
        for suffix in changed:
            moved = [p for p in init if p.endswith(suffix)]
            assert moved, suffix
            for p in moved:
                assert np.abs(final[p] - init[p]).max() > 0, p
