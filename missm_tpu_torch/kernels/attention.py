"""Softmax self-attention: the hand-written CUDA kernels (csrc/attention.cu,
csrc/attention_bwd.cu, csrc/short_attention.cu, csrc/short_attention_bwd.cu),
their autograd wrappers and their plain PyTorch versions.

The wrappers, by the TPU kernel each takes the place of
(missm_tpu/kernels/flash_attention.py):

- `attention`: bias-free attention, on csrc/attention.cu. The JAX package
  sends it to one of two TPU kernels, and the launch counts follow it:
  - K1, `fused_attention_cls` (`LAUNCHES["attention"]`), where it takes the
    CLS split: N - 1 a positive multiple of 128 and head pairs of 64, the
    image and video towers' spatial attention at N = 257. The TPU kernel
    gets K/V split into a CLS row and 256 main keys to fill its 128-wide
    lanes; here K/V come whole.
  - K2 mode b, `fused_attention` unmasked (`LAUNCHES["attention_unsplit"]`),
    everywhere else: the audio tower at N = 593.
  Its gradient is the backward kernel (csrc/attention_bwd.cu), which takes
  the place of K3, `fused_attention_cls_bwd` (`LAUNCHES["attention_bwd"]`),
  on the first route, and of K4, `fused_attention_bwd` unmasked
  (`LAUNCHES["attention_unsplit_bwd"]`), on the other.
- `causal_attention` (K2, mode a) takes the place of
  `fused_attention(causal=True, kbias=...)`: causal attention with an
  optional additive key bias [B, 1, N], the text tower's path. Its gradient
  is plain PyTorch, as the JAX package's is einsum (`_fca_bwd`).
- `short_attention` (K2, mode c) takes the place of
  `fused_attention(block_diag=T)`: attention within each of M instances of
  T <= 32 tokens, the video tower's temporal attention. Its gradient is the
  kernel of csrc/short_attention_bwd.cu (`LAUNCHES["short_attention_bwd"]`),
  which takes the place of K4, `fused_attention_bwd(block_diag=T)`.

`plan` says what a bf16 launch of csrc/attention.cu or csrc/attention_bwd.cu
computes per (batch, head): its row and column tiles, scores, exponentials
and shared memory, as the C launchers compute them.

q, k, v and the output are [B, N, H*hd] ([M, T, H*hd] for short_attention).
Scores, softmax and accumulation are f32; the output has the input's type
(bf16 or f32). Each wrapper calls a torch custom op (namespace `missm`,
listed in kernels/ops.py): on a CPU tensor the op computes the plain
version, on a CUDA tensor it launches the kernel or raises, and each launch
adds one to its count in `LAUNCHES`. The backwards are ops too, so an
exported program and selective checkpointing see every kernel call.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import build
from .launches import LAUNCHES, reset_launches  # noqa: F401 (re-exported)

_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)  # instantiated in every .cu
SHORT_MAX_T = 32  # the longest instance csrc/short_attention.cu takes
# The bf16 kernels of csrc/attention.cu and csrc/attention_bwd.cu (`plan`):
ROWS = 64              # rows of a block: one warpgroup, wgmma's M
STAGES = 2             # streamed tiles in flight (the TMA ring)
SMEM_LIMIT = 232_448   # the most dynamic shared memory a block may have


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


def short_attention_plain(q, k, v, num_heads: int):
    """Attention within each instance of [M, T, H*hd]: attention_plain with
    the M instances as its batch. The same function as the JAX package's
    block-diagonal mode on packed rows (`_einsum_reference(...,
    block_diag=T)`), whose finfo.min mask leaves exactly zero weight on the
    other instances' keys."""
    return attention_plain(q, k, v, num_heads)


def attention_bwd_plain(q, k, v, g, num_heads: int):
    """(dq, dk, dv) of bias-free attention for the output cotangent g: the
    plain version of the backward kernel (K3, and K4 unmasked)."""
    return _bwd_plain(q, k, v, g, num_heads)[:3]


def short_attention_bwd_plain(q, k, v, g, num_heads: int):
    """(dq, dk, dv) of attention within each instance of [M, T, H*hd] for
    the output cotangent g: attention_bwd_plain with the M instances as its
    batch, every step in f32. The same function as the JAX package's
    block-diagonal gradient on packed rows (`_einsum_bwd(H, T, ...)`), whose
    finfo.min mask leaves exactly zero weight across instances."""
    return attention_bwd_plain(q, k, v, g, num_heads)


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
    """Whether autograd records this call: a wrapper asks the forward
    kernel for the log-sum-exp only then."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def attention_route(n: int, num_heads: int, head_dim: int) -> str:
    """The TPU kernel a bias-free call over N tokens takes the place of, as
    its `LAUNCHES` name: "attention" (K1) where the JAX package takes the
    CLS split (flash_attention.py::cls_split_available without its VMEM
    budgets), else "attention_unsplit" (K2 mode b)."""
    cls_split = (n > 128 and (n - 1) % 128 == 0 and head_dim == 64
                 and num_heads % 2 == 0)
    return "attention" if cls_split else "attention_unsplit"


def attention(q, k, v, num_heads: int):
    """softmax(q k^T hd^-0.5) v per (batch, head): `missm::attention`, whose
    gradient is `missm::attention_bwd`. Only a call that autograd records
    has the forward kernel write the log-sum-exp the backward reads."""
    out, _ = torch.ops.missm.attention(q, k, v, num_heads,
                                       _recorded(q, k, v))
    return out


def causal_attention(q, k, v, kbias, num_heads: int):
    """Causal attention with an optional additive key bias [B, 1, N] f32
    (finfo.min at padded keys), added before the causal mask:
    `missm::causal_attention`, K2 mode a forward, plain PyTorch backward."""
    return torch.ops.missm.causal_attention(q, k, v, kbias, num_heads)


def short_attention(q, k, v, num_heads: int):
    """Attention within each instance of q, k, v [M, T, H*hd], T <= 32:
    `missm::short_attention`, K2 mode c forward, K4 block-diagonal
    backward (`missm::short_attention_bwd`)."""
    return torch.ops.missm.short_attention(q, k, v, num_heads)


# ---------------------------------------------------------------------------
# The custom ops (namespace missm; kernels/ops.py lists them). The CPU
# kernel of each is its plain version, the CUDA kernel the hand kernel,
# which raises on what it does not take and counts each launch; the fake
# gives the exact output shapes and types, so torch.export and selective
# checkpointing see every call.
# ---------------------------------------------------------------------------


def _lse_plain(q, k, num_heads):
    """The per-row log-sum-exp [B, H, N] f32 of the scaled scores."""
    B, N, D = q.shape
    hd = D // num_heads
    s = torch.einsum("bqhd,bkhd->bhqk",
                     (q * hd ** -0.5).reshape(B, N, num_heads, hd).float(),
                     k.reshape(B, N, num_heads, hd).float())
    return torch.logsumexp(s, dim=-1)


def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op(
    "missm::attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, int num_heads, bool want_lse) "
           "-> (Tensor, Tensor)")
def _attention_op(q, k, v, num_heads, want_lse):
    """(out, lse [B, H, N] f32, or an empty tensor without want_lse)."""
    lse = _lse_plain(q, k, num_heads) if want_lse else _no_lse(q)
    return attention_plain(q, k, v, num_heads), lse


@_attention_op.register_kernel("cuda")
def _(q, k, v, num_heads, want_lse):
    out, lse = _launch(q, k, v, None, num_heads, causal=False,
                       want_lse=want_lse)
    LAUNCHES[attention_route(q.shape[1], num_heads,
                             q.shape[2] // num_heads)] += 1
    return out, _no_lse(q) if lse is None else lse


@_attention_op.register_fake
def _(q, k, v, num_heads, want_lse):
    B, N, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, num_heads, N) if want_lse else (0,),
                        dtype=torch.float32))


@torch.library.custom_op(
    "missm::attention_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
           "Tensor g, int num_heads) -> (Tensor, Tensor, Tensor)")
def _attention_bwd_op(q, k, v, out, lse, g, num_heads):
    """(dq, dk, dv) for the output cotangent g (K3, K4 unmasked)."""
    return tuple(attention_bwd_plain(q, k, v, g, num_heads))


@_attention_bwd_op.register_kernel("cuda")
def _(q, k, v, out, lse, g, num_heads):
    grads = _launch_bwd(q, k, v, out, lse, g.contiguous(), num_heads)
    LAUNCHES[attention_route(q.shape[1], num_heads,
                             q.shape[2] // num_heads) + "_bwd"] += 1
    return grads


@_attention_bwd_op.register_fake
def _(q, k, v, out, lse, g, num_heads):
    return tuple(torch.empty_like(t) for t in (q, k, v))


def _attention_setup(ctx, inputs, output):
    q, k, v, num_heads, want_lse = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.num_heads = num_heads
    ctx.want_lse = want_lse


def _attention_grad(ctx, g, _glse):
    if not ctx.want_lse:
        raise RuntimeError("missm::attention was recorded without its "
                           "log-sum-exp (want_lse=False); call it through "
                           "kernels.attention.attention")
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.missm.attention_bwd(q, k, v, out, lse, g,
                                               ctx.num_heads)
    return dq, dk, dv, None, None


_attention_op.register_autograd(_attention_grad,
                                setup_context=_attention_setup)


@torch.library.custom_op(
    "missm::causal_attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? kbias, int num_heads) "
           "-> Tensor")
def _causal_attention_op(q, k, v, kbias, num_heads):
    return attention_plain(q, k, v, num_heads, causal=True, kbias=kbias)


@_causal_attention_op.register_kernel("cuda")
def _(q, k, v, kbias, num_heads):
    out, _ = _launch(q, k, v, kbias, num_heads, causal=True)
    LAUNCHES["causal_attention"] += 1
    return out


@_causal_attention_op.register_fake
def _(q, k, v, kbias, num_heads):
    return torch.empty_like(q)


def _causal_setup(ctx, inputs, output):
    q, k, v, kbias, num_heads = inputs
    ctx.save_for_backward(q, k, v, kbias)
    ctx.num_heads = num_heads


def _causal_grad(ctx, g):
    """The JAX package's einsum backward (`_fca_bwd`), in plain PyTorch. The
    key bias masks the scores whether or not it takes a gradient."""
    q, k, v, kbias = ctx.saved_tensors
    dq, dk, dv, dkb = causal_attention_bwd_plain(q, k, v, kbias,
                                                 g.contiguous(),
                                                 ctx.num_heads)
    return dq, dk, dv, dkb if ctx.needs_input_grad[3] else None, None


_causal_attention_op.register_autograd(_causal_grad,
                                       setup_context=_causal_setup)


@torch.library.custom_op(
    "missm::short_attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, int num_heads) -> Tensor")
def _short_attention_op(q, k, v, num_heads):
    return short_attention_plain(q, k, v, num_heads)


@_short_attention_op.register_kernel("cuda")
def _(q, k, v, num_heads):
    out = _launch_short(q, k, v, num_heads)
    LAUNCHES["short_attention"] += 1
    return out


@_short_attention_op.register_fake
def _(q, k, v, num_heads):
    return torch.empty_like(q)


@torch.library.custom_op(
    "missm::short_attention_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor g, int num_heads) "
           "-> (Tensor, Tensor, Tensor)")
def _short_attention_bwd_op(q, k, v, g, num_heads):
    return tuple(short_attention_bwd_plain(q, k, v, g, num_heads))


@_short_attention_bwd_op.register_kernel("cuda")
def _(q, k, v, g, num_heads):
    grads = _launch_short_bwd(q, k, v, g.contiguous(), num_heads)
    LAUNCHES["short_attention_bwd"] += 1
    return grads


@_short_attention_bwd_op.register_fake
def _(q, k, v, g, num_heads):
    return tuple(torch.empty_like(t) for t in (q, k, v))


def _short_setup(ctx, inputs, output):
    q, k, v, num_heads = inputs
    ctx.save_for_backward(q, k, v)
    ctx.num_heads = num_heads


def _short_grad(ctx, g):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = torch.ops.missm.short_attention_bwd(q, k, v, g,
                                                     ctx.num_heads)
    return dq, dk, dv, None


_short_attention_op.register_autograd(_short_grad, setup_context=_short_setup)


# ---------------------------------------------------------------------------
# Plans: what a bf16 launch computes (the C launchers compute the same)
# ---------------------------------------------------------------------------


def dkdv_rows(head_dim: int) -> int:
    """Query rows per step of the dK/dV kernel: the register budget of dK,
    dV, S^T and dP^T (attention_bwd.cu::dkdv_rows)."""
    return 64 if head_dim <= 64 else 32


def _tiles(n: int, width: int):
    """(first, live) per tile of `width` rows over n rows: the full tiles,
    then the ragged one."""
    return tuple((i, min(width, n - i)) for i in range(0, n, width))


def _narrow(live: int) -> int:
    """The width a tile of `live` columns is computed at: wgmma's N steps
    of 8."""
    return -(-live // 8) * 8


@dataclass(frozen=True)
class Plan:
    """One bf16 kernel's work for a (batch, head).

    kernel: "forward", "dq" or "dkdv". rows: (first, live) of each block's
    row tile (queries; keys for dkdv), in launch order: the full tiles, then
    the ragged one, which every (batch, head) runs after all full tiles.
    cols: per row tile, (first, width) of each column tile it visits (keys;
    queries for dkdv), the last one narrowed to `width` = its live columns
    rounded up to 8; causal row tiles stop at their diagonal. smem_bytes:
    the block's dynamic shared memory, which the C launcher asks for."""
    kernel: str
    rows: tuple
    cols: tuple
    smem_bytes: int

    @property
    def blocks(self) -> int:
        """Blocks per (batch, head)."""
        return len(self.rows)

    @property
    def scores(self) -> int:
        """Score entries computed per (batch, head): every block's 64 rows
        times the width of each column tile it visits."""
        return sum(ROWS * sum(w for _, w in c) for c in self.cols)

    @property
    def exponentials(self) -> int:
        """Scores per (batch, head) whose exponential is taken: the warps
        (16 rows each) with a live row compute the softmax, the others skip
        it."""
        return sum(-(-live // 16) * 16 * sum(w for _, w in c)
                   for (_, live), c in zip(self.rows, self.cols))


@functools.lru_cache(maxsize=None)
def plan(n: int, head_dim: int, kernel: str = "forward", *,
         causal: bool = False) -> Plan:
    """What the bf16 `kernel` ("forward", "dq", "dkdv") computes at N = n
    tokens and `head_dim`: csrc/attention.cu::attention_bf16 (causal: its
    key tiles stop at each query tile's last row) and the two launches of
    csrc/attention_bwd.cu."""
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} is not one of {_HEAD_DIMS}")
    tile_bytes = ROWS * head_dim * 2
    rows = _tiles(n, ROWS)
    if kernel == "dkdv":
        bq = dkdv_rows(head_dim)
        cols = tuple(tuple((i, _narrow(w)) for i, w in _tiles(n, bq))
                     for _ in rows)
        smem = (1024 + 2 * tile_bytes + 2 * STAGES * bq * head_dim * 2
                + 2 * 2 * bq * 4 + 8 * (1 + STAGES))
        return Plan(kernel, rows, cols, smem)
    if kernel not in ("forward", "dq"):
        raise ValueError(f"no kernel {kernel!r}")
    cols = tuple(tuple((i, _narrow(w)) for i, w in _tiles(
        min(n, q0 + ROWS) if causal else n, ROWS)) for q0, _ in rows)
    resident = 1 if kernel == "forward" else 2       # Q; Q and dO
    smem = 1024 + (resident + 2 * STAGES) * tile_bytes + 8 * (1 + STAGES)
    return Plan(kernel, rows, cols, smem)


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
    shape, dtype, device = q.shape, q.dtype, q.device
    for name, t in (("q", q), *tensors.items()):
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} like "
                             f"q; got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {device}")


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


def _check_short(num_heads, q, **tensors):
    """_check, and T <= SHORT_MAX_T tokens per instance."""
    _check(num_heads, q, **tensors)
    if not 1 <= q.shape[1] <= SHORT_MAX_T:
        raise ValueError(f"short attention takes 1 <= T <= {SHORT_MAX_T} "
                         f"tokens per instance; got T={q.shape[1]}")


def _launch_short(q, k, v, num_heads):
    """The K2(c) kernel: attention within each instance of [M, T, H*hd]."""
    _check_short(num_heads, q, k=k, v=v)
    M, T, D = q.shape
    out = torch.empty_like(q)
    fn = _function("short_attention", "missm_short_attention_forward", 4, 5)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), M, T,
            num_heads, D // num_heads, int(q.dtype == torch.bfloat16),
            (D // num_heads) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"short attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def _launch_short_bwd(q, k, v, g, num_heads):
    """The K4 block-diagonal kernel: (dq, dk, dv) of attention within each
    instance of [M, T, H*hd] for the output cotangent g."""
    _check_short(num_heads, q, k=k, v=v, g=g)
    M, T, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    fn = _function("short_attention_bwd", "missm_short_attention_backward",
                   7, 5)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), M, T, num_heads,
            D // num_heads, int(q.dtype == torch.bfloat16),
            (D // num_heads) ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"short attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    return dq, dk, dv


def _launch_bwd(q, k, v, out, lse, g, num_heads):
    """The backward kernel (K3, K4 unmasked): (dq, dk, dv) for the output
    cotangent g."""
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
    return build.function(source, name,
                          [ctypes.c_void_p] * n_pointers
                          + [ctypes.c_int] * n_ints
                          + [ctypes.c_float, ctypes.c_void_p])
