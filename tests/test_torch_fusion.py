"""The port's fusion heads and dense SuperGAT (missm_tpu_torch.models.fusion,
missm_tpu_torch.ops.graph) against the JAX package's.

Shapes of tests/test_fusion.py: B = 6, feature 16, fusion 8, 3 classes,
the modalities (language, video, audio), so that the graph heads have three
nodes. Params are JAX-initialised and bridged with `from_jax`; embeddings
are made with numpy. All f32 on the CPU.

Tolerances: the two frameworks differ only in the matmuls' summation order.
Logits are held to 1e-5 absolute + 1e-5 * |ref|; the gradient of the
logits' sum to 1e-5 of each leaf's largest |grad|, plus 1e-7 absolute for
the leaves whose true gradient is zero (the attention key bias: softmax
ignores a per-query shift), which hold float noise; the train-mode aux to
1e-5 absolute + 1e-5 * |ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from missm_tpu.models import fusion as jfusion
from missm_tpu.ops import graph as jgraph
from missm_tpu_torch.compat.from_jax import from_jax, to_numpy
from missm_tpu_torch.core.config import MODALITY_CODES
from missm_tpu_torch.models import fusion as tfusion
from missm_tpu_torch.models.finetune import tree_map
from missm_tpu_torch.ops import graph as tgraph

MODS = ("language", "video", "audio")
B, FEAT = 6, 16
RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-5     # of each leaf's largest |grad|
NOISE = 1e-7         # |grad| of a leaf whose true gradient is zero
# every missing code of the three modalities, and a batch that mixes them
CODES = {"complete": [0] * B, "language": [1] * B, "video": [2] * B,
         "audio": [3] * B, "mixed": [0, 1, 2, 3, 0, 2]}
DISTILL = ("Distill_tea", "MTD_stu", "KL_stu", "self_distill")


def _cfgs(ftype, mods=MODS, dropout_prob=0.1):
    kw = dict(fusion_type=ftype, modality_types=mods, output_dims=3,
              feature_dims=FEAT, fusion_dim=8, dropout_prob=dropout_prob)
    return jfusion.FusionConfig(**kw), tfusion.FusionConfig(**kw)


def _tree(ftype, seed=0):
    jcfg, _ = _cfgs(ftype)
    return jax.tree_util.tree_map(
        np.asarray, jfusion.init_fusion(jax.random.PRNGKey(seed), jcfg))


def _embeds(seed=0, mods=MODS):
    rng = np.random.default_rng(seed)
    return {m: rng.standard_normal((B, FEAT)).astype(np.float32)
            for m in mods}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _port(ftype, tree, embeds, codes, train=False, **kw):
    _, tcfg = _cfgs(ftype, **kw)
    return tfusion.fusion_forward(
        from_jax(tree, device="cpu"), tcfg,
        {m: torch.from_numpy(v) for m, v in embeds.items()},
        torch.as_tensor(codes), train=train,
        generator=torch.Generator().manual_seed(0) if train else None)


def _jax(ftype, tree, embeds, codes, train=False, **kw):
    jcfg, _ = _cfgs(ftype, **kw)
    return jfusion.fusion_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        {m: jnp.asarray(v) for m, v in embeds.items()},
        jnp.asarray(codes, jnp.int32), train=train,
        rng=jax.random.PRNGKey(1) if train else None)


def test_fusion_types_are_the_jax_packages():
    assert tfusion.FUSION_TYPES == jfusion.FUSION_TYPES
    assert len(tfusion.FUSION_TYPES) == 13
    assert tfusion.DISTILL_TYPES == jfusion.DISTILL_TYPES
    assert tfusion.INTER_ATTN_HEADS == jfusion.INTER_ATTN_HEADS


def test_unknown_fusion_type_raises_as_the_jax_dispatch_does():
    jcfg, tcfg = _cfgs("nope")
    with pytest.raises(KeyError):
        jfusion.init_fusion(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(KeyError):
        tfusion.init_fusion(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(KeyError):
        tfusion.fusion_forward({}, tcfg, {}, torch.zeros(1))


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("ftype", jfusion.FUSION_TYPES)
def test_head_logits_match_jax(ftype, code):
    tree = _tree(ftype)
    if ftype == "concat":  # non-zero statistics, so imputation shows
        rng = np.random.default_rng(5)
        tree["statistics"] = {m: rng.standard_normal(FEAT).astype(np.float32)
                              for m in MODS}
    embeds = _embeds()
    got, aux = _port(ftype, tree, embeds, CODES[code])
    want, jaux = _jax(ftype, tree, embeds, CODES[code])
    assert got.dtype == torch.float32 and got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ftype", jfusion.FUSION_TYPES)
def test_head_grads_match_jax(ftype):
    """d(sum of logits)/d(every head param), eval mode, mixed codes."""
    tree = _tree(ftype)
    embeds = _embeds(1)
    codes = CODES["mixed"]
    jcfg, _ = _cfgs(ftype)
    je = {m: jnp.asarray(v) for m, v in embeds.items()}

    def loss(p):
        return jfusion.fusion_forward(p, jcfg, je,
                                      jnp.asarray(codes, jnp.int32))[0].sum()

    want = _flat(jax.tree_util.tree_map(np.asarray, jax.grad(loss)(
        jax.tree_util.tree_map(jnp.asarray, tree))))
    params = from_jax(tree, device="cpu")
    tree_map(lambda t: t.requires_grad_(), params)
    _, tcfg = _cfgs(ftype)
    tfusion.fusion_forward(params, tcfg,
                           {m: torch.from_numpy(v) for m, v in embeds.items()},
                           torch.as_tensor(codes))[0].sum().backward()
    got = _flat(to_numpy(tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
        params)))
    assert set(got) == set(want)
    for path, w in want.items():
        atol = GRAD_RTOL * float(np.abs(w).max()) + NOISE
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("ftype", DISTILL)
def test_train_mode_aux_matches_jax(ftype):
    """Dropout 0: the train-mode forward is deterministic in both, and the
    aux the distillation losses read must match."""
    tree = _tree(ftype)
    embeds = _embeds(2)
    got, aux = _port(ftype, tree, embeds, CODES["mixed"], train=True,
                     dropout_prob=0.0)
    want, jaux = _jax(ftype, tree, embeds, CODES["mixed"], train=True,
                      dropout_prob=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    keys = ({"features"} if ftype != "self_distill" else
            {"present_masks", "stu_features", "tea_features"})
    assert set(aux) == set(jaux) == keys
    for k in keys:
        assert aux[k].shape == jaux[k].shape, k
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_self_distill_student_slots_keep_the_gradient():
    """Each student view is its modality in its own slot: the gradient of
    view i reaches modality i's embedding and no other."""
    _, tcfg = _cfgs("self_distill", dropout_prob=0.0)
    params = from_jax(_tree("self_distill"), device="cpu")
    embeds = {m: torch.from_numpy(v).requires_grad_()
              for m, v in _embeds(3).items()}
    _, aux = tfusion.fusion_forward(params, tcfg, embeds,
                                    torch.zeros(B, dtype=torch.int64),
                                    train=True,
                                    generator=torch.Generator())
    for i, m in enumerate(MODS):
        grads = torch.autograd.grad(aux["stu_features"][:, i].sum(),
                                    list(embeds.values()), allow_unused=True,
                                    retain_graph=True)
        for other, g in zip(MODS, grads):
            assert (g is not None and g.abs().sum() > 0) == (other == m)


def test_set_statistics_matches_jax():
    tree = _tree("concat")
    rng = np.random.default_rng(4)
    stats = {m: rng.standard_normal(FEAT).astype(np.float32) for m in MODS}
    want = jfusion.set_statistics(
        jax.tree_util.tree_map(jnp.asarray, tree), stats)
    params = from_jax(tree, device="cpu")
    got = tfusion.set_statistics(params, stats)
    assert got is not params and params["statistics"]["video"].abs().sum() == 0
    for m in MODS:
        assert got["statistics"][m].dtype == torch.float32
        np.testing.assert_array_equal(got["statistics"][m].numpy(),
                                      np.asarray(want["statistics"][m]))
    # a sample missing video behaves as if its embedding were the statistic
    embeds = _embeds()
    codes = [2] + [0] * (B - 1)
    out1, _ = _port("concat", to_numpy(got), embeds, codes)
    filled = dict(embeds, video=embeds["video"].copy())
    filled["video"][0] = stats["video"]
    out2, _ = _port("concat", to_numpy(got), filled, [0] * B)
    np.testing.assert_allclose(out1[0].numpy(), out2[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("heads,concat", [(1, False), (4, True), (3, False)])
def test_supergat_dense_matches_jax(heads, concat):
    rng = np.random.default_rng(heads)
    x = rng.standard_normal((5, 4, 12)).astype(np.float32)
    present = rng.random((5, 4)) < 0.6
    p = jax.tree_util.tree_map(np.asarray, jgraph.init_supergat_layer(
        jax.random.PRNGKey(heads), 12, 6, heads, concat))
    p["bias"] = rng.standard_normal(p["bias"].shape).astype(np.float32)
    jadj = jgraph.modality_adjacency(jnp.asarray(present))
    want = jgraph.supergat_dense(jax.tree_util.tree_map(jnp.asarray, p),
                                 jnp.asarray(x), jadj, heads=heads,
                                 concat=concat)
    adj = tgraph.modality_adjacency(torch.from_numpy(present))
    got = tgraph.supergat_dense(from_jax(p, device="cpu"),
                                torch.from_numpy(x), adj, heads=heads,
                                concat=concat)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("self_loops", [True, False])
def test_modality_adjacency_matches_jax(self_loops):
    present = np.random.default_rng(0).random((16, 5)) < 0.5
    want = jgraph.modality_adjacency(jnp.asarray(present), self_loops)
    got = tgraph.modality_adjacency(torch.from_numpy(present), self_loops)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tgraph.full_adjacency(2, 3).numpy(),
                                  np.asarray(jgraph.full_adjacency(2, 3)))


def test_supergat_isolated_node_attends_to_itself():
    """A node whose neighbours are all missing outputs x W + bias."""
    gen = torch.Generator().manual_seed(0)
    p = tgraph.init_supergat_layer(gen, 8, 8, 1, False)
    x = torch.randn(1, 3, 8, generator=gen)
    adj = tgraph.modality_adjacency(torch.tensor([[False, True, True]]))
    out = tgraph.supergat_dense(p, x, adj, heads=1, concat=False)
    torch.testing.assert_close(out[0, 0], x[0, 0] @ p["w"] + p["bias"],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("ftype", jfusion.FUSION_TYPES)
def test_init_matches_the_jax_tree_and_bridges_exactly(ftype):
    """The port's init has the JAX tree's leaves, shapes and dtypes; the
    JAX tree survives from_jax -> to_numpy bit for bit (statistics, the GCN
    gat1/gat2 leaves, query_token [1, 1, d], fusion_representation, the
    {m}_to_{t} regressors among them)."""
    tree = _tree(ftype)
    _, tcfg = _cfgs(ftype)
    init = _flat(to_numpy(tfusion.init_fusion(
        torch.Generator().manual_seed(0), tcfg)))
    want = _flat(tree)
    assert set(init) == set(want)
    for path, w in want.items():
        assert init[path].shape == w.shape and init[path].dtype == w.dtype, \
            path
    back = _flat(to_numpy(from_jax(tree, device="cpu")))
    assert set(back) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], w, err_msg=path)


def test_init_draws_from_its_generator_only():
    _, tcfg = _cfgs("unified_graph")
    state = torch.get_rng_state()
    a = _flat(to_numpy(tfusion.init_fusion(torch.Generator().manual_seed(3),
                                           tcfg)))
    b = _flat(to_numpy(tfusion.init_fusion(torch.Generator().manual_seed(3),
                                           tcfg)))
    c = _flat(to_numpy(tfusion.init_fusion(torch.Generator().manual_seed(4),
                                           tcfg)))
    assert torch.equal(torch.get_rng_state(), state)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path])
    assert any(not np.array_equal(a[p], c[p]) for p in a if a[p].any())


# ---------------------------------------------------------------------------
# The properties of tests/test_fusion_fuzz.py, for the port's heads
# ---------------------------------------------------------------------------

MODSETS = {"sims_mosi": ("language", "video", "audio"),
           "enterface": ("video", "audio"),
           "mvsa": ("language", "image")}
INVARIANT = ("sum", "concat", "regression", "intra_attention",
             "inter_attention", "dedicated_dnn", "Distill_tea", "MTD_stu",
             "KL_stu", "self_distill")


def _fuzz_setup(ftype, modset):
    mods = MODSETS[modset]
    _, cfg = _cfgs(ftype, mods)
    return cfg, tfusion.init_fusion(torch.Generator().manual_seed(0), cfg)


def _draw(data, mods):
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 31 - 1)))
    embeds = {m: torch.from_numpy(rng.standard_normal((B, FEAT))
                                  .astype(np.float32)) for m in mods}
    codes = [0] + [MODALITY_CODES[m] for m in mods]
    missing = torch.tensor([data.draw(st.sampled_from(codes))
                            for _ in range(B)])
    return rng, embeds, missing


@settings(max_examples=12, deadline=None)
@given(data=st.data())
@pytest.mark.parametrize("modset", sorted(MODSETS))
@pytest.mark.parametrize("ftype", jfusion.FUSION_TYPES)
def test_fuzz_permutation_equivariance(ftype, modset, data):
    """Row i's logits depend only on row i: permuting the batch permutes
    the logits."""
    cfg, params = _fuzz_setup(ftype, modset)
    rng, embeds, missing = _draw(data, MODSETS[modset])
    perm = torch.from_numpy(rng.permutation(B))
    with torch.no_grad():
        out, _ = tfusion.fusion_forward(params, cfg, embeds, missing)
        out_p, _ = tfusion.fusion_forward(
            params, cfg, {m: v[perm] for m, v in embeds.items()},
            missing[perm])
    assert torch.isfinite(out).all(), (ftype, modset)
    np.testing.assert_allclose(out[perm].numpy(), out_p.numpy(), atol=1e-5,
                               rtol=1e-5, err_msg=f"{ftype}/{modset}")


@settings(max_examples=12, deadline=None)
@given(data=st.data())
@pytest.mark.parametrize("modset", sorted(MODSETS))
@pytest.mark.parametrize("ftype", INVARIANT)
def test_fuzz_missing_content_invariance(ftype, modset, data):
    """Scribbling over every missing row's embedding changes no logit (the
    graph heads leak through the self-loop and are left out)."""
    mods = MODSETS[modset]
    cfg, params = _fuzz_setup(ftype, modset)
    _, embeds, missing = _draw(data, mods)
    scribble = data.draw(st.floats(-1e4, 1e4, allow_nan=False))
    embeds2 = {m: torch.where((missing == MODALITY_CODES[m])[:, None],
                              torch.tensor(scribble, dtype=torch.float32), e)
               for m, e in embeds.items()}
    with torch.no_grad():
        out1, _ = tfusion.fusion_forward(params, cfg, embeds, missing)
        out2, _ = tfusion.fusion_forward(params, cfg, embeds2, missing)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5,
                               err_msg=f"{ftype}/{modset}")
