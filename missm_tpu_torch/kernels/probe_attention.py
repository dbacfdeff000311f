"""The attention forwards of the two timing probes: the hand-written CUDA
kernels of csrc/probe_attention.cu, their wrappers and their plain PyTorch
versions.

The wrappers, by the TPU kernel each takes the place of (scripts/):

- `attn_probe_fused` (P1, attn_probe.py:47 `make_fused`): q, k, v
  [G, N, hd], one head-major slice each; the whole-row kernel.
- `tower_bhne` (P2, ablation_probe.py:84 `make_tower_bhne`): [B, H, N, hd];
  the whole-row kernel on its B*H slices.
- `tower_scratch` (P3, ablation_probe.py:152 `make_tower_scratch`):
  [B, N, H*hd]; the batch-row kernel, one block per (batch, head) that
  stages the head's whole K and V once for all its query tiles.
- `tower_packed_debug` (P4, ablation_probe.py:210
  `make_tower_packed_debug`): [B, N, H*hd] in one of MODES; the whole-row
  kernel with the production kernel's rounding order and the knock-outs,
  nostage on a kernel of its own that reads each head's tiles as the input
  lays them out (no swizzle, no per-head re-layout) with mma.sync.

Each counts its launches under its own name in `LAUNCHES`, P1 and P2 on one
kernel as K1 and K2(b) are. The probes time a jitted forward and nothing
differentiates them, so the kernels are forward only: on a CUDA tensor a
wrapper launches its kernel or raises, and a call that autograd records
raises NotImplementedError. On a CPU tensor it computes the plain version.
The kernels are built for hd = 64, the probes' head dim.

`plan` says what a bf16 launch computes: its grid, its query and key tiles,
its passes over the keys and its shared memory, as the C launchers compute
them; the largest N each kernel takes (`max_n`, SCRATCH_MAX_N) follows from
it. The whole-row and nostage kernels keep no score row in shared memory,
so they take any N.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build
from .attention import _recorded
from .launches import LAUNCHES

HEAD_DIM = 64                     # the one head dim the kernels are built for
MODES = ("full", "noexp", "dotsonly", "nostage")
_MODE_IDS = {"full": 0, "noexp": 1, "dotsonly": 2, "nostage": 0}
KERNELS = ("rows", "scratch", "nostage")  # plan's names, the C kernel ids
# The bf16 kernels' tiles and shared memory (`plan`, the C launchers):
QUERY_ROWS = 64                   # query rows of a warpgroup: wgmma's M
KEYS = 64                         # keys of a full K or V tile
STAGES = 4                        # tiles in the whole-row kernel's ring
BOX = 16                          # rows of a TMA box of P3's K and V
TILE_BYTES = QUERY_ROWS * HEAD_DIM * 2   # one 64-row bf16 tile
SMEM_LIMIT = 232_448              # the most dynamic shared memory a block may have
# Query rows per block of the bf16 whole-row kernel (one warpgroup, or two
# sharing the ring) for P1's sweep, and its default; the f32 kernels take 32.
ROWS = (64, 128)
DEFAULT_ROWS = 64
_F32_ROWS = 32


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
# Plans: what a bf16 launch computes (the C launchers compute the same)
# ---------------------------------------------------------------------------


def _tiles(n: int, width: int):
    """(first, live) per tile of `width` rows over n rows."""
    return tuple((i, min(width, n - i)) for i in range(0, n, width))


def _round(x: int, to: int) -> int:
    return -(-x // to) * to


@dataclass(frozen=True)
class Plan:
    """One bf16 launch of csrc/probe_attention.cu over `slices` (batch,
    head) slices of N tokens.

    kernel: "rows" (the whole-row kernel: P1, P2, P4 full, noexp,
    dotsonly), "scratch" (the batch-row kernel: P3) or "nostage" (P4
    nostage, mma.sync on unswizzled tiles). warpgroups: per block
    (nostage: its 4 warps count as one). grid: the launch's blocks. rows:
    (first, live) of each query tile that a block (rows, nostage) or one
    of its warpgroups in turn (scratch) computes, in launch order: the full
    tiles, then the ragged one. cols: (first, width) of each key tile every
    query tile visits, the last narrowed to its keys rounded up to 8
    (wgmma's N step; nostage: mma.sync's n). passes: how often each query
    tile computes its scores (the statistics pass, then the output pass;
    dotsonly: once). smem_bytes: the block's dynamic shared memory, which
    the C launcher asks for."""
    kernel: str
    warpgroups: int
    grid: int
    rows: tuple
    cols: tuple
    passes: int
    smem_bytes: int

    @property
    def scores(self) -> int:
        """Score entries computed per slice: each query tile's rows (64 a
        warpgroup, wgmma's M, whether live or not; nostage: its 4 warps'
        64) times each key tile's width, once per pass."""
        height = QUERY_ROWS * (self.warpgroups if self.kernel == "rows"
                               else 1)
        return (self.passes * height * len(self.rows)
                * sum(w for _, w in self.cols))


@functools.lru_cache(maxsize=None)
def plan(n: int, kernel: str = "rows", rows: int = DEFAULT_ROWS,
         slices: int = 1, mode: str = "full") -> Plan:
    """What the bf16 `kernel` computes at N = n tokens over `slices`
    slices in `mode` (one of MODES); `rows` (the whole-row kernel): query
    rows a block, one of ROWS."""
    if n < 1:
        raise ValueError(f"N must be at least 1; got {n}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    keys = tuple((i, _round(w, 8)) for i, w in _tiles(n, KEYS))
    passes = 1 if mode == "dotsonly" else 2

    def ring(wgs):  # 1024 (alignment), Q, the ring of key tiles, barriers
        return 1024 + (wgs + STAGES) * TILE_BYTES + 8 * (1 + STAGES)

    if kernel == "rows":
        if rows not in ROWS:
            raise ValueError(f"no whole-row kernel of {rows} query rows")
        wgs = rows // QUERY_ROWS
        tiles = _tiles(n, rows)
        return Plan(kernel, wgs, slices * len(tiles), tiles, keys, passes,
                    ring(wgs))
    tiles = _tiles(n, QUERY_ROWS)
    if kernel == "scratch":
        def smem(wgs):
            return (1024 + 2 * wgs * TILE_BYTES
                    + 2 * _round(n, BOX) * HEAD_DIM * 2 + 8 * (1 + 2 * wgs))
        wgs = 2 if smem(2) <= SMEM_LIMIT else 1
        return Plan(kernel, wgs, slices, tiles, keys, passes, smem(wgs))
    if kernel == "nostage":
        return Plan(kernel, 1, slices * len(tiles), tiles, keys, passes,
                    ring(1))
    raise ValueError(f"no kernel {kernel!r}; one of {KERNELS}")


def _f32_smem(kernel: str, n: int) -> int:
    """The dynamic shared memory of an f32 launch: the score rows of 32
    queries (pitch N rounded up to 32, plus 4), and a staged K/V tile of 32
    keys (rows) or the head's whole K and V (scratch)."""
    sp = _round(n, 32) + 4
    return 4 * (32 * sp + (2 * n * HEAD_DIM if kernel == "scratch"
                           else 32 * HEAD_DIM))


def _smem(kernel, n, rows, bf16):
    return plan(n, kernel, rows).smem_bytes if bf16 else _f32_smem(kernel, n)


def max_n(kernel: str, rows: int = DEFAULT_ROWS, bf16: bool = True):
    """The largest N whose launch of `kernel` (bf16: `plan`; f32: its
    CUDA-core kernel) fits in a block's shared memory, which grows with N;
    None for the bf16 whole-row and nostage kernels, whose shared memory
    holds no row and does not grow with N."""
    if bf16 and kernel in ("rows", "nostage"):
        return None
    n = 1
    while _smem(kernel, n + 1, rows, bf16) <= SMEM_LIMIT:
        n += 1
    return n


SCRATCH_MAX_N = max_n("scratch")                             # 832


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
    """P3: attention per (batch, head) of q, k, v [B, N, H*hd]: bf16, one
    block per (batch, head) with the head's whole K and V staged once for
    all its query tiles; f32, one block per batch row looping over the
    heads."""
    if q.device.type == "cpu":
        return rows_attention_plain(q, k, v, layout="tokens",
                                    num_heads=num_heads)
    _check("tower_scratch", (q, k, v), 3, num_heads)
    B, N, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    _fits("scratch", N, bf16)
    out = torch.empty_like(q)
    fn = build.function("probe_attention", "missm_probe_scratch_attention",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N,
            num_heads, HEAD_DIM, int(bf16), HEAD_DIM ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
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


def _fits(kernel, n, bf16, rows=DEFAULT_ROWS):
    """Raise unless a launch of `kernel` at N = n fits in shared memory."""
    if _smem(kernel, n, rows, bf16) > SMEM_LIMIT:
        raise ValueError(f"the {kernel} kernel takes N <= "
                         f"{max_n(kernel, rows, bf16)} in "
                         f"{'bf16' if bf16 else 'f32'}; got {n}")


def _launch_rows(q, k, v, b, n, h, mode, *, after, rows=DEFAULT_ROWS):
    """The whole-row kernel (nostage: its own kernel on the unswizzled
    tiles) on b * h slices of n rows (row pitch h * hd)."""
    bf16 = q.dtype == torch.bfloat16
    if not bf16:
        rows = _F32_ROWS
    elif rows not in ROWS or (rows != DEFAULT_ROWS
                              and (after or mode != "full")):
        raise ValueError(f"no kernel of {rows} query rows for mode {mode}")
    _fits("nostage" if mode == "nostage" else "rows", n, bf16, rows)
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
