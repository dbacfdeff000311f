"""Fused LayerNorm -> linear, the pre-LN block's ln2 -> fc1 boundary: the
hand-written CUDA kernel csrc/ln_linear.cu, its autograd wrapper and its
plain PyTorch version.

`ln_linear` takes the place of K5, missm_tpu/kernels/ln_linear.py::
_ln_linear_fwd_pallas:

    y = round((x - mean) * rstd * gamma + beta) @ W (+ b)

for x [..., D] with the statistics in f32 (the mean, then the mean of the
squared deviation), the normalised activation rounded to x's type, the
product accumulated in f32 and the bias added in f32 before the single
rounding to x's type. W is stored (in, out). The bf16 kernel normalises x
between shared memory and the tensor cores (the register operand of its
wgmma), so the normalised activation never reaches device memory, and takes
each row tile's statistics once; `plan` says what each bf16 launch computes. The backward is plain PyTorch, the JAX package's _ln_linear_bwd
(XLA there): dln = dy W^T kept in f32, then the LayerNorm backward, and dW,
db, dgamma, dbeta only where autograd asks for them.

`FUSE_LN2_FC1` is the JAX package's switch, off by default and read at call
time by models/tower.py's block; `ln_linear_available` is its shape rule. The
wrapper calls the custom op `missm::ln_linear`: on a CPU tensor it computes
the plain version; on a CUDA tensor it launches the kernel or raises, and
each launch adds one to LAUNCHES["ln_linear"]. The backward is the same
code on both.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..ops.basic import matmul_f32, named
from . import build
from .launches import LAUNCHES

# The ln2 -> fc1 fusion in models/tower.py's block: off by default, as in
# the JAX package. The ln_linear probe flips it per arm.
FUSE_LN2_FC1 = False


def ln_linear_available(x, lin_params) -> bool:
    """The JAX package's shape rule: D and F multiples of 128, the rows M
    (every leading dim of x) a multiple of 8, and no LoRA on the projection
    (the unfused path keeps LoRA's exact-rank gradient). The JAX rule also
    asks for a TPU backend; the port's wrapper runs on either device (its
    plain version on the CPU), so that clause is dropped."""
    if "lora_a" in lin_params:
        return False
    D = x.shape[-1]
    F = lin_params["w"].shape[1]
    M = math.prod(x.shape[:-1])
    return D % 128 == 0 and F % 128 == 0 and M % 8 == 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _normalise(x, eps):
    """(xhat, rstd) in f32: x - mean over the last axis, times rstd from the
    mean of the squared deviation."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    return (xf - mean) * rstd, rstd


def _plain(x, gamma, beta, w, b, eps):
    xhat, _ = _normalise(x, eps)
    h = (xhat * gamma.float() + beta.float()).to(x.dtype)
    y = matmul_f32(h.reshape(-1, h.shape[-1]), w)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[1])


def ln_linear_plain(x, ln_params, lin_params, eps: float = 1e-5):
    """The kernel's function in plain PyTorch, with the same rounding
    points; x [..., D] -> [..., F]."""
    return _plain(x, ln_params["scale"], ln_params["bias"], lin_params["w"],
                  lin_params.get("b"), eps)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def ln_linear(x, ln_params, lin_params, eps: float = 1e-5, *, name=None):
    """y = LN(x; ln_params) @ lin_params['w'] (+ lin_params['b']), x [..., D]
    -> [..., F], in x's type, through `missm::ln_linear`: the kernel
    forward on CUDA, the plain version on the CPU, and the plain backward on
    both. No LoRA (see ln_linear_available). `name` tags the op's output
    for the remat policies (ops/basic.py::named)."""
    D = x.shape[-1]
    w = lin_params["w"]
    with named(name):
        y = torch.ops.missm.ln_linear(x.reshape(-1, D), ln_params["scale"],
                                      ln_params["bias"], w,
                                      lin_params.get("b"), eps)
    return y.reshape(*x.shape[:-1], w.shape[1])


@torch.library.custom_op(
    "missm::ln_linear", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor gamma, Tensor beta, Tensor w, Tensor? b, "
           "float eps) -> Tensor")
def _ln_linear_op(x, gamma, beta, w, b, eps):
    """K5's function on x [M, D]: its plain version on the CPU."""
    return _plain(x, gamma, beta, w, b, eps)


@_ln_linear_op.register_kernel("cuda")
def _(x, gamma, beta, w, b, eps):
    y = _launch(x, gamma, beta, w, b, eps)
    LAUNCHES["ln_linear"] += 1
    return y


@_ln_linear_op.register_fake
def _(x, gamma, beta, w, b, eps):
    return x.new_empty((x.shape[0], w.shape[1]))


def _ln_linear_setup(ctx, inputs, output):
    x, gamma, beta, w, b, eps = inputs
    ctx.save_for_backward(x, gamma, beta, w)
    ctx.eps = eps
    ctx.b_dtype = None if b is None else b.dtype


def _ln_linear_grad(ctx, dy):
    """missm_tpu/kernels/ln_linear.py::_ln_linear_bwd: dln = dy W^T in f32,
    then the LayerNorm backward; each gradient only where autograd asks."""
    x, gamma, beta, w = ctx.saved_tensors
    need_x, need_gamma, need_beta, need_w, need_b, _ = ctx.needs_input_grad
    xhat, rstd = _normalise(x, ctx.eps)
    dyc = dy.to(x.dtype)
    dx = dgamma = dbeta = dw = db = None
    if need_x or need_gamma or need_beta:
        dln = matmul_f32(dyc, w.t())                       # [M, D] f32
    if need_w:
        h = (xhat * gamma.float() + beta.float()).to(x.dtype)
        dw = matmul_f32(h.t(), dyc).to(w.dtype)
    if need_b:
        db = dy.float().sum(0).to(ctx.b_dtype)
    if need_gamma:
        dgamma = (dln * xhat).sum(0).to(gamma.dtype)
    if need_beta:
        dbeta = dln.sum(0).to(beta.dtype)
    if need_x:
        t = dln * gamma.float()
        dx = rstd * (t - t.mean(-1, keepdim=True)
                     - xhat * (t * xhat).mean(-1, keepdim=True))
        dx = dx.to(x.dtype)
    return dx, dgamma, dbeta, dw, db, None


_ln_linear_op.register_autograd(_ln_linear_grad,
                                setup_context=_ln_linear_setup)


# ---------------------------------------------------------------------------
# The bf16 launch (csrc/ln_linear.cu: plan_for)
# ---------------------------------------------------------------------------

ROWS = 128          # rows of a row tile: two consumer warpgroups of 64
DEPTH = 64          # depth of a stage: one 128-byte swizzled row of bf16
WIDTHS = (256, 128)  # column tile widths, the wider preferred
MAX_STAGES = 4
SMEM_LIMIT = 232_448
# Clusters of g blocks (one an SM) that an H100 runs at once, from
# cudaOccupancyMaxActiveClusters on the card (a cluster stays within a GPC,
# so clusters of 3, 4, 6 and 8 leave SMs idle; tests/test_torch_cuda.py
# checks the table); sizes 5 and 7 are not taken.
ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15}


def _smem(d: int, bn: int, stages: int) -> int:
    """The aligned ring of (x, W) stages, the output staging tile [128, bn],
    gamma and beta as f32, the row tile's mean and rstd, the bias of two
    column tiles as f32, a full and an empty barrier a stage and a bias
    buffer."""
    return (1024 + stages * (ROWS * DEPTH * 2 + DEPTH * bn * 2)
            + ROWS * bn * 2 + 8 * d + 8 * ROWS + 8 * bn + 8 * (2 * stages + 4))


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one bf16 launch at [m, d] -> f computes: row tiles of ROWS rows
    (the last ragged), each owned by a cluster of `groups` blocks, block g
    of which walks the column tiles `col_tiles(g)` of width `bn` and takes
    the statistics of the rows `stats_rows(g)` of its row tile for all of
    them; `stages` (x, W) stages in flight; `smem_bytes` of dynamic shared
    memory (0: the launch does not fit in a block)."""
    m: int
    d: int
    f: int
    bn: int
    groups: int
    stages: int
    smem_bytes: int

    @property
    def fits(self) -> bool:
        return self.smem_bytes > 0

    @property
    def row_tiles(self) -> tuple:
        """(first row, live rows) of each row tile."""
        return tuple((r, min(ROWS, self.m - r)) for r in range(0, self.m, ROWS))

    @property
    def grid(self) -> int:
        return len(self.row_tiles) * self.groups

    def col_tiles(self, g: int) -> tuple:
        """The first column of each column tile block g of a group walks."""
        return tuple(range(g * self.bn, self.f, self.groups * self.bn))

    def stats_rows(self, g: int) -> range:
        """The rows of its row tile whose statistics block g takes."""
        share = -(-ROWS // self.groups)
        return range(min(ROWS, g * share), min(ROWS, (g + 1) * share))


@functools.lru_cache(maxsize=None)
def plan(m: int, d: int, f: int) -> Plan:
    """The bf16 launch at [m, d] -> f: the column tile width and groups
    that finish soonest (the fewest waves of clusters, ACTIVE_CLUSTERS at
    once, times the column tiles a block walks, times their width; ties to
    the wider tile and the fewer groups), then the most stages that fit, at
    least 2."""
    if m < 1 or d < 1 or f < 1 or d % 128 or f % 128:
        raise ValueError(f"ln_linear kernel takes m > 0 and D and F multiples "
                         f"of 128; got m={m}, D={d}, F={f}")
    row_tiles = -(-m // ROWS)
    best = None
    for bn in WIDTHS:
        if f % bn:
            continue
        cols = f // bn
        for g, active in ACTIVE_CLUSTERS.items():
            if g > cols:
                continue
            cost = -(-row_tiles // active) * -(-cols // g) * bn
            if best is None or cost < best[0]:
                best = (cost, bn, g)
    _, bn, g = best
    stages = MAX_STAGES
    while stages >= 2 and _smem(d, bn, stages) > SMEM_LIMIT:
        stages -= 1
    return Plan(m, d, f, bn, g, stages,
                _smem(d, bn, stages) if stages >= 2 else 0)


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def _vector(name, t, n, device):
    """Raise unless t is a contiguous float32/bfloat16 [n] on device."""
    if (t.shape != (n,) or t.dtype not in (torch.float32, torch.bfloat16)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 or bfloat16 "
                         f"[{n}] tensor on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _launch(x, gamma, beta, w, b, eps):
    """The K5 kernel on x [M, D]: y [M, F] in x's type. Raises on what the
    kernel does not take: D or F not a multiple of 128, x and W not of one
    type (float32 or bfloat16), a tensor off x's device, a bf16 launch that
    `plan` says does not fit."""
    if x.device.type != "cuda":
        raise ValueError(f"ln_linear kernel needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16; got {x.dtype}")
    x = x.contiguous()
    M, D = x.shape
    if w.dim() != 2 or w.shape[0] != D or w.dtype != x.dtype:
        raise ValueError(f"w must be {x.dtype} [{D}, F]; got {w.dtype} "
                         f"{tuple(w.shape)}")
    F = w.shape[1]
    if D % 128 or F % 128:
        raise ValueError(f"ln_linear kernel takes D and F multiples of 128; "
                         f"got D={D}, F={F}")
    if (w.device != x.device or not w.is_contiguous() or x.data_ptr() % 16
            or w.data_ptr() % 16):
        raise ValueError(f"x and w must be contiguous, 16-byte aligned and "
                         f"on {x.device}")
    _vector("gamma", gamma, D, x.device)
    _vector("beta", beta, D, x.device)
    if gamma.dtype != beta.dtype:
        raise ValueError(f"gamma and beta must be of one type; got "
                         f"{gamma.dtype}, {beta.dtype}")
    if b is not None:
        _vector("b", b, F, x.device)
    if x.dtype == torch.bfloat16 and not plan(M, D, F).fits:
        raise ValueError(f"ln_linear kernel: D={D} leaves no room for two "
                         f"stages in a block's shared memory")
    y = torch.empty(M, F, dtype=x.dtype, device=x.device)
    fn = build.function("ln_linear", "missm_ln_linear_forward", _ARGTYPES)
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), M, D, F,
            int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16),
            int(b is not None and b.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_linear kernel launch failed: CUDA error {rc}")
    return y
