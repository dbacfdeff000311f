"""The attention forwards of the two timing probes: the hand-written CUDA
kernels of csrc/probe_attention.cu, their wrappers and their plain PyTorch
versions.

The wrappers, by the TPU kernel each takes the place of (scripts/):

- `attn_probe_fused` (P1, attn_probe.py:47 `make_fused`): q, k, v
  [G, N, hd], one head-major slice each; the whole-row kernel.
- `tower_bhne` (P2, ablation_probe.py:84 `make_tower_bhne`): [B, H, N, hd];
  the whole-row kernel on its B*H slices.
- `tower_scratch` (P3, ablation_probe.py:152 `make_tower_scratch`):
  [B, N, H*hd]; the batch-row kernel, one block per batch row over all
  heads.
- `tower_packed_debug` (P4, ablation_probe.py:210
  `make_tower_packed_debug`): [B, N, H*hd] in one of MODES; the whole-row
  kernel with the production kernel's rounding order and the knock-outs.

Each counts its launches under its own name in `LAUNCHES`, P1 and P2 on one
kernel as K1 and K2(b) are. The probes time a jitted forward and nothing
differentiates them, so the kernels are forward only: on a CUDA tensor a
wrapper launches its kernel or raises, and a call that autograd records
raises NotImplementedError. On a CPU tensor it computes the plain version.
The kernels are built for hd = 64, the probes' head dim.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .attention import _recorded
from .launches import LAUNCHES

HEAD_DIM = 64                     # the one head dim the kernels are built for
MODES = ("full", "noexp", "dotsonly", "nostage")
_MODE_IDS = {"full": 0, "noexp": 1, "dotsonly": 2, "nostage": 0}
# Query rows per block of the bf16 whole-row kernel, the largest N each
# takes (its f32 score rows live in shared memory), and P1's default; the
# f32 kernel takes 32 rows and the same N as the default.
ROWS_MAX_N = {16: 768, 32: 768, 64: 768, 128: 400}
ROWS = tuple(ROWS_MAX_N)
DEFAULT_ROWS = 64
_F32_ROWS = 32
SCRATCH_MAX_N = 320               # the batch-row kernel stages a head whole


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _to_heads(t, num_heads):
    """[B, N, H*hd] -> [B, H, N, hd]."""
    B, N, D = t.shape
    return t.reshape(B, N, num_heads, D // num_heads).transpose(1, 2)


def _to_tokens(t):
    """[B, H, N, hd] -> [B, N, H*hd]."""
    B, H, N, hd = t.shape
    return t.transpose(1, 2).reshape(B, N, H * hd)


def rows_attention_plain(q, k, v, *, layout="heads", num_heads=None):
    """The math of P1, P2 and P3: s = (q . k in f32) * hd^-0.5, the softmax
    in f32 over the whole row, P = e / sum(e) cast to the input type, P.V
    accumulated in f32 and written in the input type. layout "heads": q, k,
    v [..., N, hd] (P1's [G, N, hd], P2's [B, H, N, hd]); "tokens": [B, N,
    H*hd] with `num_heads` heads (P3)."""
    if layout == "tokens":
        q, k, v = (_to_heads(t, num_heads) for t in (q, k, v))
    elif layout != "heads":
        raise ValueError(f"layout must be 'heads' or 'tokens'; got {layout!r}")
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    o = (p.float() @ v.float()).to(q.dtype)
    return _to_tokens(o) if layout == "tokens" else o


def packed_attention_plain(q, k, v, num_heads: int, mode: str):
    """The math of P4 on q, k, v [B, N, H*hd], per head: s = (q . k in f32)
    * hd^-0.5 and m = max(s) over the row, then
      full, nostage: e = exp(s - m), den = sum(e);
      noexp:         e = s - m,      den = sum(s - m);
      dotsonly:      e = s,          den = 1;
    e cast to the input type, P.V accumulated in f32, divided by den in f32
    and cast to the input type. nostage differs from full only in how the
    TPU kernel reads its operands (ablation_probe.py:229-251)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    qh, kh, vh = (_to_heads(t, num_heads) for t in (q, k, v))
    s = (qh.float() @ kh.float().transpose(-1, -2)) * qh.shape[-1] ** -0.5
    if mode == "dotsonly":
        e, den = s, 1.0
    else:
        e = s - s.amax(-1, keepdim=True)
        if mode != "noexp":
            e = torch.exp(e)
        den = e.sum(-1, keepdim=True)
    o = (e.to(q.dtype).float() @ vh.float()) / den
    return _to_tokens(o.to(q.dtype))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def attn_probe_fused(q, k, v, *, rows: int = DEFAULT_ROWS):
    """P1: attention per head-major slice of q, k, v [G, N, hd]. `rows`
    (bf16 on CUDA): query rows per block, one of ROWS."""
    if q.device.type == "cpu":
        return rows_attention_plain(q, k, v)
    _check("attn_probe_fused", (q, k, v), 3)
    G, N, hd = q.shape
    out = _launch_rows(q, k, v, G, N, 1, "full", after=False, rows=rows)
    LAUNCHES["attn_probe_fused"] += 1
    return out


def tower_bhne(q, k, v):
    """P2: attention per (batch, head) of head-major q, k, v [B, H, N, hd]."""
    if q.device.type == "cpu":
        return rows_attention_plain(q, k, v)
    _check("tower_bhne", (q, k, v), 4)
    B, H, N, hd = q.shape
    out = _launch_rows(q, k, v, B * H, N, 1, "full", after=False)
    LAUNCHES["tower_bhne"] += 1
    return out


def tower_scratch(q, k, v, num_heads: int):
    """P3: attention per (batch, head) of q, k, v [B, N, H*hd], one block
    per batch row looping over the heads."""
    if q.device.type == "cpu":
        return rows_attention_plain(q, k, v, layout="tokens",
                                    num_heads=num_heads)
    _check("tower_scratch", (q, k, v), 3, num_heads)
    B, N, D = q.shape
    if N > SCRATCH_MAX_N:
        raise ValueError(f"tower_scratch kernel takes N <= {SCRATCH_MAX_N}; "
                         f"got {N}")
    out = torch.empty_like(q)
    fn = build.function("probe_attention", "missm_probe_scratch_attention",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N,
            num_heads, HEAD_DIM, int(q.dtype == torch.bfloat16),
            HEAD_DIM ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tower_scratch kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["tower_scratch"] += 1
    return out


def tower_packed_debug(q, k, v, num_heads: int, mode: str):
    """P4: attention per (batch, head) of q, k, v [B, N, H*hd] in the
    production kernel's rounding order, with `mode` one of MODES."""
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, num_heads, mode)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    _check("tower_packed_debug", (q, k, v), 3, num_heads)
    B, N, D = q.shape
    out = _launch_rows(q, k, v, B, N, num_heads, mode, after=True)
    LAUNCHES["tower_packed_debug"] += 1
    return out


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------


def _check(name, tensors, dims, num_heads=None):
    """Raise on what the kernels do not take: a call autograd records; q,
    k, v not CUDA, contiguous, 16-byte aligned and of one shape and type
    (float32 or bfloat16); not `dims`-D; a head dim other than HEAD_DIM."""
    if _recorded(*tensors):
        raise NotImplementedError(f"{name} is forward only: call it under "
                                  f"torch.no_grad() or inference mode")
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    if q.dim() != dims:
        raise ValueError(f"{name} takes {dims}-D q, k, v; got "
                         f"{tuple(q.shape)}")
    hd = q.shape[-1] if num_heads is None else q.shape[-1] / num_heads
    if hd != HEAD_DIM:
        raise ValueError(f"{name} kernel is built for head dim {HEAD_DIM}; "
                         f"got {hd}")
    for label, t in zip("qkv", tensors):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{label} must be {q.dtype} {tuple(q.shape)} like "
                             f"q; got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{label} must be contiguous, 16-byte aligned and "
                             f"on {q.device}")


def _launch_rows(q, k, v, b, n, h, mode, *, after, rows=DEFAULT_ROWS):
    """The whole-row kernel on b * h slices of n rows (row pitch h * hd)."""
    bf16 = q.dtype == torch.bfloat16
    if not bf16:
        rows = _F32_ROWS
    elif rows not in ROWS or (rows != DEFAULT_ROWS
                              and (after or mode != "full")):
        raise ValueError(f"no kernel of {rows} query rows for mode {mode}")
    max_n = ROWS_MAX_N[DEFAULT_ROWS if not bf16 else rows]
    if n > max_n:
        raise ValueError(f"the whole-row kernel takes N <= {max_n} at "
                         f"{rows} query rows; got {n}")
    out = torch.empty_like(q)
    fn = build.function("probe_attention", "missm_probe_rows_attention",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h,
            HEAD_DIM, int(bf16), _MODE_IDS[mode], int(after),
            int(mode != "nostage"), rows, HEAD_DIM ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe attention kernel launch failed: CUDA error "
                           f"{rc}")
    return out
