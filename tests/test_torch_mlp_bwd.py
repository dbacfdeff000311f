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
