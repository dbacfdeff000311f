"""Multi-head attention, after missm_tpu/ops/attention.py.

Numerics match HF `CLIPAttention`: q scaled by head_dim**-0.5, softmax in
f32, additive bias masks. Bias-free attention and causal attention (with an
optional key bias) go to the attention kernel (kernels/attention.py), which
computes the plain version for CPU tensors; attention with a dense `bias`
stays plain PyTorch, as the JAX package keeps it on XLA. Temporal attention
over tiny instances goes to the short-attention kernel (`short_attention`).

The values are named for the remat policies as the JAX package names them
(ops/basic.py::named): the q, k and v projections "qkv" ("tqkv" in the
temporal attention), the attention's output before the out projection
"attn_kernel_out" ("tattn_kernel_out"), and the out projection `out_name`
("attn_out" in the block's spatial attention).
"""
from __future__ import annotations

import torch

from ..kernels import attention as kernels
from ..parallel.collectives import copy_to_model
from .basic import named, tp_linear


def _qkv(params, x, lora_scaling, name, tp):
    """The q, k and v projections; under TP (`tp`, a ModelAxis) this rank's
    columns of each, x entering the model axis once for the three."""
    if tp is not None:
        x = copy_to_model(x, tp)
    return tuple(tp_linear(params[p], x, tp, "col",
                           lora_scaling=lora_scaling, name=name)
                 for p in ("q", "k", "v"))


def _heads(num_heads, tp):
    """The heads this rank computes: all of them, or under TP its share."""
    return num_heads if tp is None else num_heads // tp.size


def multi_head_attention(params, x, *, num_heads: int, bias=None,
                         causal: bool = False, key_bias=None,
                         lora_scaling: float | None = None,
                         out_name: str | None = None, tp=None):
    """Self-attention over x: [B, N, D] -> [B, N, D].

    bias: optional additive bias broadcastable to [B, H, N, N].
    causal / key_bias: the text tower's causal mask and [B, 1, N] f32
    padding bias, kept apart from `bias` so that they run inside the kernel.
    tp: the model axis (parallel.collectives.ModelAxis) under Megatron TP:
    this rank computes H / size heads from its q/k/v columns, and the out
    projection's partial products are summed over the axis.
    """
    q, k, v = _qkv(params, x, lora_scaling, "qkv", tp)
    num_heads = _heads(num_heads, tp)
    with named("attn_kernel_out"):
        if bias is None and causal:
            out = kernels.causal_attention(q, k, v, key_bias, num_heads)
        elif bias is None and key_bias is None:
            out = kernels.attention(q, k, v, num_heads)
        else:
            out = kernels.attention_plain(q, k, v, num_heads, causal=causal,
                                          kbias=key_bias, bias=bias)
    return tp_linear(params["out"], out, tp, "row",
                     lora_scaling=lora_scaling, name=out_name)


def short_attention(params, x, *, num_heads: int,
                    lora_scaling: float | None = None, tp=None):
    """Self-attention within each of the M instances of x [M, T, D], T <= 32
    (the video tower's temporal attention over T frames).

    The TPU path packs 128/T instances into one 128-token row under a
    block-diagonal mask, and runs a leftover that does not fill a row, or a
    shape the packing does not take, through einsums. The kernel here takes
    the instances as they are, all of them, so none of that is carried
    over. `tp` as in multi_head_attention."""
    q, k, v = _qkv(params, x, lora_scaling, "tqkv", tp)
    with named("tattn_kernel_out"):
        out = kernels.short_attention(q, k, v, _heads(num_heads, tp))
    return tp_linear(params["out"], out, tp, "row", lora_scaling=lora_scaling)


def causal_bias(n: int, dtype=torch.float32, device=None):
    """Additive causal mask [1, 1, n, n]: 0 on/below the diagonal, finfo.min
    above."""
    neg = torch.finfo(dtype).min
    return torch.full((n, n), neg, dtype=dtype, device=device).triu(1)[None, None]


def key_padding_bias(pad_mask, dtype=torch.float32):
    """[B, N] bool (True = masked) -> additive bias [B, 1, 1, N]."""
    neg = torch.finfo(dtype).min
    return torch.where(pad_mask[:, None, None, :], neg, 0.0).to(dtype)
