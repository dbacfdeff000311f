"""The port's layout rules as pure functions, against the JAX package's:
`param_pspecs` leaf by leaf (the JAX spec of a stacked [L, ...] block leaf
loses its layer entry, which is "pipe" exactly when the port's stages own
block ranges) for TP, FSDP at 2, 3, 4 and 8 with fsdp_min_size 128 and the
default, pipe, and their compositions; `hybrid_shapes`; the stage ranges.
"""
import itertools

import jax
import numpy as np
import pytest

from missm_tpu.core import mesh as jmesh
from missm_tpu.parallel.partitioning import param_pspecs as jax_pspecs
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core import mesh as tmesh
from missm_tpu_torch.parallel.partitioning import (FSDP_MIN_SIZE,
                                                   param_pspecs, stage_range)
from tests.torch_parallel_ref import jax_config, redrawn_tree

FUSION = dict(fusion_type="concat",
              modality_types=("language", "video", "audio", "image"),
              output_dims=3, feature_dims=24, fusion_dim=8)


@pytest.fixture(scope="module")
def trees():
    """The JAX tree and the port's of a tiny image + video (temporal MLP)
    + audio model."""
    jcfg = jax_config(("image", "video", "audio"), FUSION,
                      vision_kw={"temporal_mlp": True})
    tree = redrawn_tree(jcfg)
    return tree, from_jax(tree, device="cpu")


def _norm(spec, ndim):
    s = tuple(spec)
    return s + (None,) * (ndim - len(s))


def _pairs(jtree, jspecs, tspecs, path=()):
    """(path, JAX spec, port spec, stacked) for every leaf, each block layer
    of a stacked JAX leaf paired with its port layer."""
    for k, v in jtree.items():
        if isinstance(v, dict):
            if k == "blocks":
                n = jax.tree_util.tree_leaves(v)[0].shape[0]
                for i in range(n):
                    yield from _block_pairs(v, jspecs[k], tspecs[k][i],
                                            path + (k, i))
            else:
                yield from _pairs(v, jspecs[k], tspecs[k], path + (k,))
        else:
            yield path + (k,), _norm(jspecs[k], np.ndim(v)), tspecs[k], False


def _block_pairs(jtree, jspecs, tspecs, path):
    for k, v in jtree.items():
        if isinstance(v, dict):
            yield from _block_pairs(v, jspecs[k], tspecs[k], path + (k,))
        else:
            yield path + (k,), _norm(jspecs[k], np.ndim(v)), tspecs[k], True


CASES = [dict(tp=tp, fsdp_size=n, fsdp_min_size=m, pipe=pipe)
         for tp, n, m, pipe in itertools.product(
             (False, True), (0, 2, 3, 4, 8), (128, FSDP_MIN_SIZE),
             (False, True))
         if not (n == 0 and m != 128)]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "tp{tp}-fsdp{fsdp_size}"
                         "-min{fsdp_min_size}-pipe{pipe}".format(**kw))
def test_param_pspecs_match_jax(trees, kw):
    jtree, ttree = trees
    want = jax_pspecs(jtree, **kw)
    got = param_pspecs(ttree, **kw)
    n = 0
    for path, j, t, stacked in _pairs(jtree, want, got):
        if stacked:
            assert j[0] == ("pipe" if kw["pipe"] else None), path
            j = j[1:]
        assert t == j, (path, t, j)
        n += 1
    assert n > 100
    if kw["fsdp_size"] == 2 and kw["fsdp_min_size"] == 128 and not kw["tp"]:
        # the fc1 bias, 64 elements a layer and 128 stacked, shards only
        # because the threshold counts the stacked leaf, as JAX does
        spec = got["encoder"]["audio"]["vision"]["blocks"][0]["mlp"]["fc1"][
            "b"]
        assert "data" in spec


def test_hybrid_shapes_match_jax():
    for args in itertools.product((1, 2, 3, 4, 8), (1, 2), (1, 2),
                                  (1, 2, 3, 4)):
        assert tmesh.hybrid_shapes(*args) == jmesh.hybrid_shapes(*args), args


def test_stage_ranges():
    assert [list(stage_range(24, 2, s)) for s in range(2)] == [
        list(range(12)), list(range(12, 24))]
    with pytest.raises(ValueError, match="12 layers not divisible by pipe "
                                         "axis 5"):
        stage_range(12, 5, 0)


def _jax_ticks(S, M, r, backward):
    """The JAX pipeline's per-tick microbatch on stage r, as its scan
    computes it (missm_tpu/parallel/pipeline.py: `midx = t - r` in the
    forward, `m = t - (S - 1 - r)` in the 1F1B backward, valid in [0, M))."""
    out = []
    for t in range(M + S - 1):
        m = t - (S - 1 - r) if backward else t - r
        if 0 <= m <= M - 1:
            out.append((t, m))
    return out


@pytest.mark.parametrize("S, M", [(2, 2), (2, 4), (4, 4), (4, 6), (3, 5)])
def test_pipeline_ticks_match_jax(S, M):
    from missm_tpu_torch.parallel.pipeline import ticks
    for r in range(S):
        for backward in (False, True):
            assert ticks(S, M, r, backward) == _jax_ticks(S, M, r, backward)
    # every microbatch once a stage, M + S - 1 ticks in all
    assert all(sorted(m for _, m in ticks(S, M, r)) == list(range(M))
               for r in range(S))
    assert max(t for r in range(S) for t, _ in ticks(S, M, r)) == M + S - 2


def test_mesh_warns_when_a_node_splits_a_model_group(monkeypatch):
    from missm_tpu_torch.core.mesh import _check_local
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.warns(UserWarning, match="model x pipe"):
        _check_local(8, 1)
    with pytest.warns(UserWarning, match="model x pipe"):
        _check_local(3, 1)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _check_local(2, 2)
        _check_local(2, 1)


class _Mesh:
    mesh_dim_names = ("data", "model", "pipe")

    def __init__(self, n_data):
        self.n_data = n_data

    def size(self, i):
        return self.n_data if i == 0 else 2


def test_cli_batch_rules():
    """round_eval_batch rounds the global eval batch up to the data axis
    times M and returns a rank's; validate_pipe_batch exits on a rank batch
    that does not split into M pipeline microbatches."""
    import argparse

    from missm_tpu_torch.cli.common import round_eval_batch, validate_pipe_batch
    args = argparse.Namespace(batch_size=64, mesh_pipe=2,
                              pipe_microbatches=0, grad_accum=1)
    assert round_eval_batch(args, _Mesh(3)) == 22 and args.batch_size == 66
    args = argparse.Namespace(batch_size=6, mesh_pipe=2,
                              pipe_microbatches=4, grad_accum=1)
    with pytest.raises(SystemExit, match="not divisible into 4 pipeline"):
        validate_pipe_batch(args, _Mesh(2))
    args.batch_size = 8
    validate_pipe_batch(args, _Mesh(2))
