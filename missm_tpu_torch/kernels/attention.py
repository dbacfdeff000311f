"""Softmax self-attention: the hand-written CUDA kernel (csrc/attention.cu),
its wrappers and its plain PyTorch version.

Two wrappers share the kernel, one per TPU kernel it replaces
(missm_tpu/kernels/flash_attention.py):

- `attention` (K1) takes the place of `fused_attention_cls`: bias-free
  attention, the image tower's path. The TPU kernel gets K/V split into a
  CLS row and 256 main keys to fill its 128-wide lanes; here K/V come whole.
- `causal_attention` (K2, mode a) takes the place of
  `fused_attention(causal=True, kbias=...)`: causal attention with an
  optional additive key bias [B, 1, N], the text tower's path.

q, k, v and the output are [B, N, H*hd]. Scores, softmax and accumulation are
f32; the output has the input's type (bf16 or f32). On a CPU tensor a wrapper
computes the plain version; on a CUDA tensor it launches the kernel or raises.
Each launch adds one to `LAUNCHES[<wrapper name>]`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"attention": 0, "causal_attention": 0}

_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)  # instantiated in attention.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_plain(q, k, v, num_heads: int, *, causal: bool = False,
                    kbias=None, bias=None):
    """The einsum formulation of the JAX package (ops/attention.py einsum
    branch, kernels/flash_attention.py::_einsum_reference): q scaled in its
    own type, scores accumulated in f32, the causal mask (finfo.min above
    the diagonal), the key bias [B, 1, N] and any dense `bias` (broadcast to
    [B, H, N, N]) added, softmax in f32, P cast to the input type and P.V
    accumulated in f32."""
    B, N, D = q.shape
    hd = D // num_heads
    qh = (q * hd ** -0.5).reshape(B, N, num_heads, hd)
    kh = k.reshape(B, N, num_heads, hd)
    vh = v.reshape(B, N, num_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    if causal:
        neg = torch.finfo(torch.float32).min
        s = s + torch.full((N, N), neg, device=q.device).triu(1)
    if kbias is not None:
        s = s + kbias[:, :, None, :].float()
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), vh.float())
    return o.to(q.dtype).reshape(B, N, D)


def attention(q, k, v, num_heads: int):
    """softmax(q k^T hd^-0.5) v per (batch, head); K1."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads)
    out = _launch(q, k, v, None, num_heads, causal=False)
    LAUNCHES["attention"] += 1
    return out


def causal_attention(q, k, v, kbias, num_heads: int):
    """Causal attention with an optional additive key bias [B, 1, N] f32
    (finfo.min at padded keys), added before the causal mask; K2 mode a."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, causal=True, kbias=kbias)
    out = _launch(q, k, v, kbias, num_heads, causal=True)
    LAUNCHES["causal_attention"] += 1
    return out


def _launch(q, k, v, kbias, num_heads, *, causal):
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, N, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must all be float32 or all bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, N, D = q.shape
    if D % num_heads or D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D}/{num_heads} is not one of {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {q.device}")
    if kbias is not None and (
            kbias.shape != (B, 1, N) or kbias.dtype != torch.float32
            or kbias.device != q.device or not kbias.is_contiguous()):
        raise ValueError(f"kbias must be a contiguous float32 [B, 1, N] = "
                         f"[{B}, 1, {N}] tensor on {q.device}; got "
                         f"{kbias.dtype} {tuple(kbias.shape)} on {kbias.device}")
    out = torch.empty_like(q)
    rc = _library().missm_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kbias is None else kbias.data_ptr(), out.data_ptr(),
        B, N, num_heads, D // num_heads, int(q.dtype == torch.bfloat16),
        int(causal), (D // num_heads) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc}")
    return out


def _library():
    lib = build.load("attention")
    fn = lib.missm_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
