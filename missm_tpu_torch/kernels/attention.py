"""Softmax self-attention: the hand-written CUDA kernels (csrc/attention.cu,
csrc/attention_bwd.cu), their autograd wrappers and their plain PyTorch
versions.

Two wrappers share the forward kernel, one per TPU kernel it replaces
(missm_tpu/kernels/flash_attention.py):

- `attention` (K1) takes the place of `fused_attention_cls`: bias-free
  attention, the image tower's path. The TPU kernel gets K/V split into a
  CLS row and 256 main keys to fill its 128-wide lanes; here K/V come whole.
  Its gradient is the backward kernel (K3), which takes the place of
  `fused_attention_cls_bwd`.
- `causal_attention` (K2, mode a) takes the place of
  `fused_attention(causal=True, kbias=...)`: causal attention with an
  optional additive key bias [B, 1, N], the text tower's path. Its gradient
  is plain PyTorch, as the JAX package's is einsum (`_fca_bwd`).

q, k, v and the output are [B, N, H*hd]. Scores, softmax and accumulation are
f32; the output has the input's type (bf16 or f32). On a CPU tensor a wrapper
computes the plain version under plain autograd; on a CUDA tensor it
launches the kernel or raises. Each launch adds one to
`LAUNCHES[<wrapper name>]` (`attention_bwd` for K3).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"attention": 0, "attention_bwd": 0, "causal_attention": 0}

_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)  # instantiated in both .cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _causal_mask(n, device):
    return torch.full((n, n), torch.finfo(torch.float32).min,
                      device=device).triu(1)


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
        s = s + _causal_mask(N, q.device)
    if kbias is not None:
        s = s + kbias[:, :, None, :].float()
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), vh.float())
    return o.to(q.dtype).reshape(B, N, D)


def _bwd_plain(q, k, v, g, num_heads, bias=None):
    """flash_attention.py::_einsum_bwd_bias, every step in f32: P recomputed
    from q, k (and the additive `bias`), then dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dP P)), dQ = dS K scale, dK = dS^T Q scale. Returns
    (dq, dk, dv) in the input types and dS [B, H, N, N] f32."""
    B, N, D = q.shape
    hd = D // num_heads
    scale = hd ** -0.5

    def heads(t):
        return t.reshape(B, N, num_heads, hd).float()

    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    s = torch.einsum("bqhd,bkhd->bhqk", qh * scale, kh)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh) * scale
    return (dq.reshape(B, N, D).to(q.dtype), dk.reshape(B, N, D).to(k.dtype),
            dv.reshape(B, N, D).to(v.dtype), ds)


def attention_bwd_plain(q, k, v, g, num_heads: int):
    """(dq, dk, dv) of bias-free attention for the output cotangent g: the
    plain version of the backward kernel (K3)."""
    return _bwd_plain(q, k, v, g, num_heads)[:3]


def causal_attention_bwd_plain(q, k, v, kbias, g, num_heads: int):
    """(dq, dk, dv, dkbias) of causal attention with the key bias [B, 1, N]
    (or None), after flash_attention.py::_fca_bwd: the dense bias is the
    finfo.min causal mask plus the key bias, and dkbias is dS summed over
    heads and queries (None without a key bias)."""
    N = q.shape[1]
    bias = _causal_mask(N, q.device)
    if kbias is not None:
        bias = bias + kbias[:, :, None, :].float()
    dq, dk, dv, ds = _bwd_plain(q, k, v, g, num_heads, bias)
    dkb = None if kbias is None else ds.sum((1, 2))[:, None, :].to(kbias.dtype)
    return dq, dk, dv, dkb


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _recorded(*tensors) -> bool:
    """Whether autograd records this call (a Function's needs_input_grad
    does not say whether grad mode is on)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def attention(q, k, v, num_heads: int):
    """softmax(q k^T hd^-0.5) v per (batch, head); K1 forward, K3 backward.
    Only a recorded call writes the log-sum-exp that K3 needs."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads)
    return _Attention.apply(q, k, v, num_heads, _recorded(q, k, v))


def causal_attention(q, k, v, kbias, num_heads: int):
    """Causal attention with an optional additive key bias [B, 1, N] f32
    (finfo.min at padded keys), added before the causal mask; K2 mode a
    forward, plain PyTorch backward."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads, causal=True, kbias=kbias)
    return _CausalAttention.apply(q, k, v, kbias, num_heads)


class _Attention(torch.autograd.Function):
    """K1 forward (writing the per-row log-sum-exp when `want_lse`), K3
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, want_lse):
        out, lse = _launch(q, k, v, None, num_heads, causal=False,
                           want_lse=want_lse)
        LAUNCHES["attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, lse, g.contiguous(),
                                 ctx.num_heads)
        LAUNCHES["attention_bwd"] += 1
        return dq, dk, dv, None, None


class _CausalAttention(torch.autograd.Function):
    """K2(a) forward; the backward recomputes P in plain PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, num_heads):
        out, _ = _launch(q, k, v, kbias, num_heads, causal=True)
        LAUNCHES["causal_attention"] += 1
        ctx.save_for_backward(q, k, v, kbias)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kbias = ctx.saved_tensors
        dq, dk, dv, dkb = causal_attention_bwd_plain(
            q, k, v, kbias if ctx.needs_input_grad[3] else None,
            g.contiguous(), ctx.num_heads)
        return dq, dk, dv, dkb, None


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _check(num_heads, q, **tensors):
    """Raise on what the kernels do not take: every tensor CUDA, [B, N, D]
    of q's shape, q's type (float32 or bfloat16), contiguous and 16-byte
    aligned, with a head dim the kernels were built for."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, N, D]; got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    D = q.shape[2]
    if D % num_heads or D // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {D}/{num_heads} is not one of {_HEAD_DIMS}")
    for name, t in dict(q=q, **tensors).items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} like "
                             f"q; got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {q.device}")


def _launch(q, k, v, kbias, num_heads, *, causal, want_lse=False):
    """The forward kernel: (out, lse [B, H, N] f32 or None)."""
    _check(num_heads, q, k=k, v=v)
    B, N, D = q.shape
    if kbias is not None and (
            kbias.shape != (B, 1, N) or kbias.dtype != torch.float32
            or kbias.device != q.device or not kbias.is_contiguous()):
        raise ValueError(f"kbias must be a contiguous float32 [B, 1, N] = "
                         f"[{B}, 1, {N}] tensor on {q.device}; got "
                         f"{kbias.dtype} {tuple(kbias.shape)} on {kbias.device}")
    out = torch.empty_like(q)
    lse = (torch.empty(B, num_heads, N, dtype=torch.float32, device=q.device)
           if want_lse else None)
    fn = _function("attention", "missm_attention_forward", 6, 6)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kbias is None else kbias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, N, num_heads, D // num_heads, int(q.dtype == torch.bfloat16),
            int(causal), (D // num_heads) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {rc}")
    return out, lse


def _launch_bwd(q, k, v, out, lse, g, num_heads):
    """The backward kernel (K3): (dq, dk, dv) for the output cotangent g."""
    _check(num_heads, q, k=k, v=v, out=out, g=g)
    B, N, D = q.shape
    if (lse.shape != (B, num_heads, N) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [B, H, N] = "
                         f"[{B}, {num_heads}, {N}] tensor on {q.device}")
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = _function("attention_bwd", "missm_attention_backward", 10, 5)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, N, num_heads, D // num_heads,
            int(q.dtype == torch.bfloat16), (D // num_heads) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA "
                           f"error {rc}")
    return dq, dk, dv


def _function(source, name, n_pointers, n_ints):
    """csrc/<source>.cu's C entry point `name`, which takes n_pointers
    pointers, n_ints ints, the float scale and the stream."""
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
