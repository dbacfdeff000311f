"""What is left of the towers, in the port (missm_tpu_torch/models/tower.py)
against the JAX package's (missm_tpu/models/tower.py), f32 on the CPU,
atol 1e-5 (rtol 1e-5 beside it for the gradients' large sums):

- the tube-3D embedding with per-tube CLS tokens (tube 2 over T = 4),
  forward and the gradient of every leaf (`_vision_features_chunk`);
- 7-D retrieval-pair input [b, pair, T, bs, C, H, W] on the image, video
  and tube-3D towers (`:576-588`);
- patch dropout, one mask a video shared by its frames or tubes
  (`_patch_dropout`), with JAX's keep indices injected into the port:
  the two frameworks draw different numbers, so the test never pins them
  by seed; the port's own draw (`patch_keep_indices`) from its
  torch.Generator is checked for its shape and its determinism;
- tower_forward's generator reaching patch dropout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.core.config import tiny_tower as jax_tiny_tower
from missm_tpu.models import tower as jtower
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import tower as ttower

ATOL = RTOL = 1e-5
TUBE = dict(use_tube3d=True, tube_size=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the shapes are tiny and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redrawn(tree, seed):
    rng = np.random.default_rng(seed)

    def redraw(x):
        if np.all(x == 0):
            return (rng.standard_normal(x.shape) * 0.05).astype(x.dtype)
        if np.all(x == 1):
            return (1 + rng.standard_normal(x.shape) * 0.1).astype(x.dtype)
        return x

    return jax.tree_util.tree_map(redraw, tree)


def _tower(modality, **overrides):
    jcfg = jax_tiny_tower(modality, **overrides)
    tree = _redrawn(jax.tree_util.tree_map(np.asarray, jtower.init_tower_params(
        jax.random.PRNGKey(7), jcfg)), 8)
    return (jcfg, tiny_tower(modality, **overrides), tree,
            from_jax(tree, device="cpu"))


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unstack(tree):
    out = {}
    for path, a in _leaves(tree):
        if path.startswith("blocks/"):
            for i in range(a.shape[0]):
                out[f"blocks/{i}/{path[7:]}"] = np.asarray(a[i])
        else:
            out[path] = np.asarray(a)
    return out


def _jax_keep(key, videos, tokens, prob):
    """The keep indices JAX's _patch_dropout draws from `key`."""
    keep = max(1, int(tokens * (1.0 - prob)))
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(videos))
    rand = jax.vmap(lambda k: jax.random.normal(k, (tokens,)))(keys)
    return np.array(jax.lax.top_k(rand, keep)[1])


def _check(modality, overrides, shape, *, prob=0.0, grads=False, seed=0):
    """vision_features of both packages on one seeded input; with prob > 0
    in train mode with JAX's keep indices injected into the port."""
    over = dict(overrides, force_patch_dropout=prob)
    jcfg, tcfg, tree, tp = _tower(modality, **over)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w = np.random.default_rng(seed + 1).standard_normal(24).astype(np.float32)
    train = prob > 0
    key = jax.random.PRNGKey(seed)
    keep = None
    if train:
        videos = (shape[0] * shape[1] * shape[3] if len(shape) == 7
                  else shape[0])
        keep = torch.from_numpy(_jax_keep(key, videos,
                                          tcfg.vision.num_patches, prob))

    def jloss(p):
        pooled = jtower.vision_features(
            p["vision"], jcfg.vision, jnp.asarray(x), train=train, rng=key,
            projection=p["visual_projection"])
        return jnp.sum(jnp.tanh(pooled) * w), pooled

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    (jl, jpooled), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    leaves = dict(_leaves({"vision": tp["vision"],
                           "visual_projection": tp["visual_projection"]}))
    for t in leaves.values():
        t.requires_grad_(grads)
    pooled = ttower.vision_features(tp["vision"], tcfg.vision,
                                    torch.from_numpy(x), train=train,
                                    projection=tp["visual_projection"],
                                    keep_indices=keep)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(jpooled),
                               atol=ATOL, rtol=RTOL)
    if grads:
        loss = (torch.tanh(pooled) * torch.from_numpy(w)).sum()
        got = torch.autograd.grad(loss, list(leaves.values()))
        want = {f"vision/{k}": v for k, v in _unstack(jg["vision"]).items()}
        want["visual_projection/w"] = np.asarray(jg["visual_projection"]["w"])
        assert set(want) == set(leaves)
        for path, g in zip(leaves, got):
            np.testing.assert_allclose(g.numpy(), want[path], atol=ATOL,
                                       rtol=RTOL, err_msg=path)
    return tcfg, tp


@pytest.mark.parametrize("temporal_mlp", [False, True])
def test_tube3d_tower_forward_and_grads_match_jax(temporal_mlp):
    """Tube 2 over T = 4: two tubes of 2x2 patches, a CLS token each, the
    temporal blocks over the 2 tubes."""
    tcfg, tp = _check("video", dict(TUBE, temporal_mlp=temporal_mlp),
                      (2, 3, 4, 32, 32), grads=True)
    assert tp["vision"]["class_embedding"].shape == (2, 32)


@pytest.mark.parametrize("modality,overrides", [
    ("image", {}), ("video", {}), ("video", TUBE)],
    ids=["image", "video", "tube3d"])
def test_7d_input_matches_jax(modality, overrides):
    """(b, pair, T, bs, C, H, W) = (1, 2, 4, 2, 3, 32, 32): 4 videos of 4
    frames, each pooled over its frames (or tubes)."""
    _check(modality, overrides, (1, 2, 4, 2, 3, 32, 32), grads=True, seed=3)


@pytest.mark.parametrize("modality,overrides,shape", [
    ("image", {}, (3, 3, 32, 32)),
    ("video", {}, (2, 3, 4, 32, 32)),
    ("video", TUBE, (2, 3, 4, 32, 32)),
    ("video", {}, (1, 2, 4, 1, 3, 32, 32))],
    ids=["image", "video", "tube3d", "7d"])
def test_patch_dropout_with_jax_keep_indices_matches_jax(modality, overrides,
                                                         shape):
    """force_patch_dropout 0.5 of 4 patch tokens keeps 2 a video, the same
    two for each of its frames or tubes; forward and gradients."""
    _check(modality, overrides, shape, prob=0.5, grads=True, seed=5)


def test_patch_keep_indices_draw_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    a = ttower.patch_keep_indices(gen, 5, 256, 0.3)
    assert a.shape == (5, 179) and a.dtype == torch.int64
    assert all(len(set(row.tolist())) == 179 for row in a)
    assert int(a.min()) >= 0 and int(a.max()) < 256
    b = ttower.patch_keep_indices(torch.Generator().manual_seed(3), 5, 256,
                                  0.3)
    assert torch.equal(a, b)
    assert ttower.patch_keep_indices(gen, 2, 4, 0.99).shape == (2, 1)


def test_patch_dropout_needs_a_generator_in_train_mode():
    _, tcfg, _, tp = _tower("image", force_patch_dropout=0.5)
    x = torch.zeros(2, 3, 32, 32)
    with pytest.raises(ValueError, match="torch.Generator"):
        ttower.vision_features(tp["vision"], tcfg.vision, x, train=True)
    # eval mode draws nothing; train mode draws from the generator given
    ttower.vision_features(tp["vision"], tcfg.vision, x)
    gen = torch.Generator().manual_seed(0)
    out = ttower.tower_forward(tp, tcfg, torch.full((2, 5), 98), x,
                               train=True, generator=gen)
    again = ttower.tower_forward(tp, tcfg, torch.full((2, 5), 98), x,
                                 train=True,
                                 generator=torch.Generator().manual_seed(0))
    for a, b in zip(out, again):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
