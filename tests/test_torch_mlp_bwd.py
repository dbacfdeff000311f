"""The port's fused MLP-backward dx (missm_tpu_torch.kernels.mlp_bwd, K6)
against the JAX package's (missm_tpu.kernels.mlp_bwd), on the CPU.

The JAX kernel runs in interpret mode with small blocks (bm=32, bf=64), the
last token block ragged at M=80; the port's wrapper runs its plain version.
Inputs are made with numpy, as tests/test_mlp_bwd.py makes them. f32: 2e-4
(summation order, the JAX package's own tolerance). bf16: both round dwide
to bf16 between the products and the result once, and differ only where an
f32 sum in another order rounds to the neighbouring bf16 value (about 0.1 %
of the elements): ||got - ref|| / ||ref|| <= 5e-4 (measured up to 1.2e-4).
The same function with dwide left in f32 differs in ~40 % of the elements,
at ~2.5e-3, so the test pins the rounding point.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from missm_tpu.kernels.mlp_bwd import mlp_bwd_dx as jax_mlp_bwd_dx
from missm_tpu.kernels.mlp_bwd import mlp_bwd_dx_xla
from missm_tpu_torch.kernels import mlp_bwd
from missm_tpu_torch.kernels.launches import LAUNCHES

D, FF = 128, 256
BF16_RTOL = 5e-4


def _data(m, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, D)).astype(np.float32),
            (rng.standard_normal((m, FF)) * 0.5).astype(np.float32),
            (rng.standard_normal((D, FF)) * 0.05).astype(np.float32),
            (rng.standard_normal((FF, D)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("m", [64, 80])
def test_f32_matches_jax(m):
    arrays = _data(m)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    kernel = jax_mlp_bwd_dx(*jargs, bm=32, bf=64, interpret=True)
    xla = mlp_bwd_dx_xla(*jargs)
    LAUNCHES["mlp_bwd_dx"] = 0
    for got in (mlp_bwd.mlp_bwd_dx_plain(*targs), mlp_bwd.mlp_bwd_dx(*targs)):
        assert got.dtype == torch.float32 and got.shape == (m, D)
        for ref in (kernel, xla):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=2e-4, rtol=2e-4)
    assert LAUNCHES["mlp_bwd_dx"] == 0  # the CPU runs the plain version


def _to_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("m", [64, 80])
def test_bf16_matches_jax_with_dwide_rounded(m):
    arrays = _data(m, seed=1)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    refs = [np.asarray(r, np.float32) for r in (
        jax_mlp_bwd_dx(*jargs, bm=32, bf=64, interpret=True),
        mlp_bwd_dx_xla(*jargs))]
    targs = [_to_bf16(a) for a in arrays]
    got = mlp_bwd.mlp_bwd_dx(*targs)
    assert got.dtype == torch.bfloat16
    # dwide left in f32 between the products
    dy, wide, w1, w2 = (t.float() for t in targs)
    dwide = (dy @ w2.t()) * mlp_bwd.quick_gelu_grad(wide)
    unrounded = (dwide @ w1.t()).to(torch.bfloat16).float().numpy()
    for ref in refs:
        def rel(x):
            return np.linalg.norm(x - ref) / np.linalg.norm(ref)
        assert rel(got.float().numpy()) <= BF16_RTOL
        assert rel(unrounded) > BF16_RTOL


# ---------------------------------------------------------------------------
# kernels.mlp_bwd.plan: what each bf16 launch of csrc/mlp_bwd.cu computes
# ---------------------------------------------------------------------------

PLAN_M = (8, 56, 64, 72, 120, 128, 136, 4112, 16448)
PLAN_FF = (128, 384, 3072, 4096)


def _check_plan(m, d, ff, tile):
    p = mlp_bwd.plan(m, d, ff, tile)
    assert (p.rows, p.cluster) == tuple(tile) and p.nout in mlp_bwd.NOUT
    assert 2 <= p.stages <= mlp_bwd.MAX_STAGES
    assert p.smem_bytes <= mlp_bwd.SMEM_LIMIT
    assert p.stages == mlp_bwd.MAX_STAGES or mlp_bwd._smem(
        p.cluster, p.nout, p.stages + 1) > mlp_bwd.SMEM_LIMIT
    rows = [r for r0, n in p.row_tiles for r in range(r0, r0 + n)]
    assert rows == list(range(m)) and p.grid == len(p.row_tiles) * p.cluster
    # the blocks of a cluster own the output columns once, and compute each
    # dwide chunk of FF once
    cols = sorted(c for b in range(p.cluster) for c in p.out_cols(b))
    assert cols == list(range(d))
    chunks = sorted(c for b in range(p.cluster) for c in p.ff_chunks(b))
    assert chunks == list(range(0, ff, mlp_bwd.DEPTH))
    return p


@pytest.mark.parametrize("m", PLAN_M)
@pytest.mark.parametrize("d", mlp_bwd.D_SIZES)
@pytest.mark.parametrize("ff", PLAN_FF)
def test_plan_fits_and_covers_every_tile_edge_once(m, d, ff):
    for tile in mlp_bwd.tiles(d):
        if ff % (tile[1] * mlp_bwd.DEPTH):
            with pytest.raises(ValueError):
                mlp_bwd.plan(m, d, ff, tile)
        else:
            _check_plan(m, d, ff, tile)


def test_plan_at_the_probes_shape():
    """The probe's [16448, 1024, 4096]: the default tile is clusters of 8
    blocks of 128 output columns (129 clusters, 15 at a time on the card:
    9 waves), 8 FF steps of 512, three stages; (128, 4) is the sweep's
    other tile. The source note's figures."""
    assert mlp_bwd.TILES == ((128, 8), (128, 4))
    p = _check_plan(16448, 1024, 4096, mlp_bwd.default_tile(1024))
    assert (p.cluster, p.nout, p.steps, p.stages, p.grid, p.waves) == (
        8, 128, 8, 3, 1032, 9)
    assert p.smem_bytes == 222_304
    q = _check_plan(16448, 1024, 4096, (128, 4))
    assert (q.nout, q.steps, q.stages, q.waves) == (256, 16, 4, 5)
    assert [mlp_bwd.default_tile(d) for d in mlp_bwd.D_SIZES] == [
        (128, 1), (128, 2), (128, 4), (128, 6), (128, 8)]


def test_plan_refuses_what_the_kernel_was_not_built_for():
    for args in ((16, 192, 256, (128, 1)), (16, 1024, 4096, (32, 32)),
                 (16, 1024, 4096, (128, 2)), (16, 1024, 4096, (128, 16)),
                 (16, 1024, 2048 + 256, (128, 8)), (0, 128, 256, (128, 1))):
        with pytest.raises(ValueError):
            mlp_bwd.plan(*args)
