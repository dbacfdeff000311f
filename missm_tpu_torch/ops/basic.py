"""Elementwise and dense primitives, after missm_tpu/ops/basic.py.

Params are dicts of tensors; linear weights are (in, out) as in the JAX
package. Matmuls accumulate in f32 and round once to the input type. A
LoRA'd `linear` carries the JAX package's exact-rank gradient (_LoraLinear).

`named` is the port's `checkpoint_name`: the ops run inside it produce the
named value, and a block checkpointed under a named remat policy
(models/tower.py) keeps the outputs of those ops by the name
(`keep_contexts`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

_NAME = None  # the name of the value the ops now running produce
_KEEP = None  # the _Keeper of the block running under a named policy


@contextlib.contextmanager
def named(name: str | None):
    """Name the value that the ops run inside produce (the JAX package's
    `checkpoint_name`): "qkv", "attn_kernel_out", "mlp_wide" and so on. A
    region holds only the ops that make the value (their views aside), so
    that a policy keeping the name keeps that value and nothing else."""
    global _NAME
    outer, _NAME = _NAME, name
    keeper = _KEEP if _KEEP is not None and _KEEP.enters(name) else None
    try:
        if keeper is None:
            yield
        else:
            with keeper:
                yield
    finally:
        _NAME = outer


def _detached(out):
    if isinstance(out, tuple):
        return tuple(_detached(t) for t in out)
    return out.detach() if isinstance(out, torch.Tensor) else out


class _Keeper(TorchDispatchMode):
    """What one checkpointed block keeps under a named remat policy. In the
    forward each op it sees runs and its output is kept; in the backward's
    recompute the same op, met in the same order, gives the kept output
    instead of running again, so autograd still records it (saving its
    inputs for the backward) but nothing is computed twice. It sees the ops
    of the regions (`named`) the policy keeps, where `named` enters it; with
    `most`, the ops of the whole block but those of the `names` regions.
    Views are never kept (one costs nothing to make again, and one of any
    other tensor would keep its base alive), nor the detaches autograd adds
    in one pass and not the other."""

    def __init__(self, names, most: bool):
        super().__init__()
        self.names, self.most = names, most
        self.kept, self.replay, self.next = [], False, 0

    def keeps(self, name) -> bool:
        return (name not in self.names) if self.most else (name in self.names)

    def enters(self, name) -> bool:
        """Whether `named(name)` enters this mode (with `most` it is on
        for the whole block already)."""
        return not self.most and name in self.names

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func.is_view or func is torch.ops.aten.detach.default
                or not self.keeps(_NAME)):
            return func(*args, **kwargs)
        if self.replay:
            self.next += 1
            return _detached(self.kept[self.next - 1])
        out = func(*args, **kwargs)
        self.kept.append(_detached(out))
        return out


@contextlib.contextmanager
def _keeping(keeper: _Keeper, replay: bool):
    global _KEEP
    keeper.replay, keeper.next = replay, 0
    outer, _KEEP = _KEEP, keeper
    try:
        if keeper.most:
            with keeper:
                yield
        else:
            yield
    finally:
        _KEEP = outer


def keep_contexts(names, most: bool = False):
    """torch.utils.checkpoint's context_fn for a block that keeps the values
    `names` names (with `most`: every value but those): the forward's
    context, which keeps them, and the recompute's, which gives them back."""
    keeper = _Keeper(names, most)
    return _keeping(keeper, False), _keeping(keeper, True)


def quick_gelu(x, *, name: str | None = None):
    """CLIP's activation: x * sigmoid(1.702 x). The sigmoid is named
    "act_sig" (missm_tpu/ops/basic.py::quick_gelu), the result `name`."""
    z = 1.702 * x
    with named("act_sig"):
        s = torch.sigmoid(z)
    with named(name):
        return x * s


_ACTS = {"quick_gelu": quick_gelu}  # every ported tower's hidden_act


def get_activation(name: str):
    return _ACTS[name]


def layer_norm(params, x, eps: float = 1e-5):
    """LayerNorm over the last axis; statistics and affine in f32, the
    result cast back to x's type."""
    y = F.layer_norm(x.float(), x.shape[-1:], params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def _fold_lora(w, a, b, scaling, out_dtype):
    """peft merge math w + a @ b * scaling, folded in f32, then cast."""
    delta = a.float() @ b.float()
    return (w.float() + delta * scaling).to(out_dtype)


class _LoraLinear(torch.autograd.Function):
    """x @ (w + a @ b * scaling) + bias with exact-rank LoRA gradients, after
    missm_tpu/ops/basic.py::_lora_matmul.

    The forward uses the folded weight. The backward recomputes the fold for
    dx and computes the adapter gradients at rank r,
        da = x^T (dy b^T) * scaling,   db = (x a)^T dy * scaling,
    instead of through dW_eff = x^T dy, a full [in, out] product per
    projection. dw = x^T dy (and the bias gradient) are computed only when
    that input needs a gradient: JAX relies on XLA removing the unused dw,
    which eager PyTorch would compute."""

    @staticmethod
    def forward(ctx, x, w, a, b, bias, scaling, name):
        ctx.save_for_backward(x, w, a, b)
        ctx.scaling = scaling
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _product(x, _fold_lora(w, a, b, scaling, x.dtype), bias,
                        name)

    @staticmethod
    def backward(ctx, g):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scaling
        need_x, need_w, need_a, need_b, need_bias = ctx.needs_input_grad[:5]
        gc = g.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        g2 = gc.reshape(-1, gc.shape[-1])
        dx = dw = da = db = dbias = None
        if need_x:
            dx = gc @ _fold_lora(w, a, b, s, x.dtype).t()
        if need_w:
            dw = (x2.t() @ g2).to(w.dtype)
        if need_a:
            gb = g2 @ b.t().to(g2.dtype)                      # [M, r]
            da = ((x2.t() @ gb.to(x2.dtype)).float() * s).to(a.dtype)
        if need_b:
            xa = x2 @ a.to(x2.dtype)                          # [M, r]
            db = ((xa.to(g2.dtype).t() @ g2).float() * s).to(b.dtype)
        if need_bias:
            dbias = g2.float().sum(0).to(ctx.bias_dtype)
        return dx, dw, da, db, dbias, None, None


def linear(params, x, *, lora_scaling: float | None = None,
           name: str | None = None):
    """y = x @ w (+ b) with the optional folded LoRA delta.

    `params['w']`: (in, out); optional `params['b']`: (out,); optional
    `params['lora_a']` (in, r) and `params['lora_b']` (r, out), used when
    `lora_scaling` is given. The bias is added inside the f32-accumulating
    matmul before the single rounding to x's type. LoRA'd projections take
    _LoraLinear's exact-rank gradient. `name` names the product (`named`)."""
    if lora_scaling is not None and "lora_a" in params:
        return _LoraLinear.apply(x, params["w"], params["lora_a"],
                                 params["lora_b"], params.get("b"),
                                 lora_scaling, name)
    return _product(x, params["w"], params.get("b"), name)


def _product(x, w, b, name):
    """x [..., in] @ w (in, out) (+ b) as the one addmm (mm without a bias)
    that F.linear runs on the rows, the only op of the `named` region (the
    views stay outside it)."""
    rows = x.reshape(-1, x.shape[-1])
    with named(name):
        y = torch.mm(rows, w) if b is None else torch.addmm(b, rows, w)
    return y.view(*x.shape[:-1], w.shape[1])


def matmul_f32(a, b):
    """a @ b for 2-D a and b, summed and returned in f32 (XLA's
    preferred_element_type=float32). A bf16 product on CUDA writes f32
    directly (torch.mm's out_dtype); elsewhere (the CPU's mm takes no
    out_dtype, or the types differ) the operands are upcast first, which
    gives the same products (bf16 x bf16 is exact in f32)."""
    if (a.device.type == "cuda" and a.dtype == b.dtype
            and a.dtype != torch.float32):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def bmm_f32(a, b):
    """a @ b for 3-D a and b, summed and returned in f32: matmul_f32 for a
    batch of products (torch.bmm's out_dtype on CUDA)."""
    if (a.device.type == "cuda" and a.dtype == b.dtype
            and a.dtype != torch.float32):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def l2_normalize(x, dim: int = -1, eps: float = 0.0):
    """x / ||x||_2 with no epsilon (torch `x / x.norm(dim=-1, keepdim=True)`)."""
    return x / torch.sqrt(x.square().sum(dim=dim, keepdim=True) + eps)


def dropout(x, rate: float, deterministic: bool,
            generator: torch.Generator | None = None):
    """Inverted dropout drawing its mask from `generator` only (never from
    torch's global generator): a train-mode call without one raises."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
