"""The MLP backward's input gradient, fused: the hand-written CUDA kernel
csrc/mlp_bwd.cu, its wrapper and its plain PyTorch version.

`mlp_bwd_dx` takes the place of K6, missm_tpu/kernels/mlp_bwd.py::mlp_bwd_dx:
for a quick_gelu MLP h -> quick_gelu(h W1) W2 whose forward saved the fc1
pre-activation `wide`,

    dh = R(R((dy W2^T) * qg'(wide)) W1^T),
    qg'(x) = s (1 + 1.702 x (1 - s)),  s = sigmoid(1.702 x),

with R rounding to dy's type: the first product and the derivative in f32,
dwide rounded once, the second product accumulated in f32. The kernel keeps
dwide [M, FF] on the chip.

No model path calls it, as in the JAX package: its callers are the probe
(probes/mlp_bwd_probe.py) and the tests. On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises, and each launch adds one to LAUNCHES["mlp_bwd_dx"].
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.basic import matmul_f32
from . import build
from .launches import LAUNCHES

D_SIZES = (128, 256, 512, 768, 1024)  # the widths csrc/mlp_bwd.cu is built for
# (rows, FF columns) per block step of the bf16 kernel: the default at every
# width, the others at D = 1024 (the probe's sweep)
TILES = ((32, 32), (16, 32), (32, 16), (16, 16))
DEFAULT_TILE = TILES[0]


def quick_gelu_grad(x):
    """d quick_gelu / dx = s (1 + 1.702 x (1 - s)), s = sigmoid(1.702 x)."""
    s = torch.sigmoid(1.702 * x)
    return s * (1.0 + 1.702 * x * (1.0 - s))


def mlp_bwd_dx_plain(dy, wide, w1, w2):
    """The kernel's function in plain PyTorch, after the JAX package's
    mlp_bwd_dx_xla: two f32-accumulating products around one elementwise
    pass, dwide rounded to dy's type between them."""
    dwide = matmul_f32(dy, w2.t()) * quick_gelu_grad(wide.float())
    return matmul_f32(dwide.to(dy.dtype), w1.t()).to(dy.dtype)


def mlp_bwd_dx(dy, wide, w1, w2, *, tile=DEFAULT_TILE):
    """dh [M, D] in dy's type, for dy [M, D], wide [M, FF], w1 [D, FF] and
    w2 [FF, D]. `tile` (bf16 on CUDA only): one of TILES."""
    if dy.device.type == "cpu":
        return mlp_bwd_dx_plain(dy, wide, w1, w2)
    out = _launch(dy, wide, w1, w2, tile)
    LAUNCHES["mlp_bwd_dx"] += 1
    return out


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(dy, wide, w1, w2, tile):
    """The K6 kernel. Raises on what it does not take: tensors not CUDA,
    contiguous, 16-byte aligned and of one type (float32 or bfloat16),
    shapes that disagree, D not one of D_SIZES, a tile it was not built for,
    FF not a multiple of the tile's FF columns (16 for float32)."""
    if dy.device.type != "cuda":
        raise ValueError(f"mlp_bwd_dx kernel needs CUDA tensors, got {dy.device}")
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dy must be float32 or bfloat16; got {dy.dtype}")
    if dy.dim() != 2 or wide.dim() != 2:
        raise ValueError("dy and wide must be 2-D")
    M, D = dy.shape
    FF = wide.shape[1]
    shapes = dict(wide=(M, FF), w1=(D, FF), w2=(FF, D))
    for name, t in dict(wide=wide, w1=w1, w2=w2).items():
        if tuple(t.shape) != shapes[name] or t.dtype != dy.dtype:
            raise ValueError(f"{name} must be {dy.dtype} {shapes[name]}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in dict(dy=dy, wide=wide, w1=w1, w2=w2).items():
        if t.device != dy.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {dy.device}")
    bf16 = dy.dtype == torch.bfloat16
    if D not in D_SIZES:
        raise ValueError(f"mlp_bwd_dx kernel takes D in {D_SIZES}; got {D}")
    if bf16 and tuple(tile) not in (TILES if D == 1024 else TILES[:1]):
        raise ValueError(f"no tile {tuple(tile)} at D={D}")
    step = tile[1] if bf16 else 16
    if FF % step:
        raise ValueError(f"FF={FF} is not a multiple of {step}")
    out = torch.empty_like(dy)
    fn = build.function("mlp_bwd", "missm_mlp_bwd_dx", _ARGTYPES)
    rc = fn(dy.data_ptr(), wide.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), M, D, FF, int(bf16), tile[0], tile[1],
            torch.cuda.current_stream(dy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_bwd_dx kernel launch failed: CUDA error {rc}")
    return out
