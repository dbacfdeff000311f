"""Multi-head attention, after missm_tpu/ops/attention.py.

Numerics match HF `CLIPAttention`: q scaled by head_dim**-0.5, softmax in
f32, additive bias masks. Bias-free attention and causal attention (with an
optional key bias) go to the attention kernel (kernels/attention.py), which
computes the plain version for CPU tensors; attention with a dense `bias`
stays plain PyTorch, as the JAX package keeps it on XLA.
"""
from __future__ import annotations

import torch

from ..kernels import attention as kernels
from .basic import linear


def multi_head_attention(params, x, *, num_heads: int, bias=None,
                         causal: bool = False, key_bias=None,
                         lora_scaling: float | None = None):
    """Self-attention over x: [B, N, D] -> [B, N, D].

    bias: optional additive bias broadcastable to [B, H, N, N].
    causal / key_bias: the text tower's causal mask and [B, 1, N] f32
    padding bias, kept apart from `bias` so that they run inside the kernel.
    """
    q = linear(params["q"], x, lora_scaling=lora_scaling)
    k = linear(params["k"], x, lora_scaling=lora_scaling)
    v = linear(params["v"], x, lora_scaling=lora_scaling)
    if bias is None and causal:
        out = kernels.causal_attention(q, k, v, key_bias, num_heads)
    elif bias is None and key_bias is None:
        out = kernels.attention(q, k, v, num_heads)
    else:
        out = kernels.attention_plain(q, k, v, num_heads, causal=causal,
                                      kbias=key_bias, bias=bias)
    return linear(params["out"], out, lora_scaling=lora_scaling)


def causal_bias(n: int, dtype=torch.float32, device=None):
    """Additive causal mask [1, 1, n, n]: 0 on/below the diagonal, finfo.min
    above."""
    neg = torch.finfo(dtype).min
    return torch.full((n, n), neg, dtype=dtype, device=device).triu(1)[None, None]


def key_padding_bias(pad_mask, dtype=torch.float32):
    """[B, N] bool (True = masked) -> additive bias [B, 1, 1, N]."""
    neg = torch.finfo(dtype).min
    return torch.where(pad_mask[:, None, None, :], neg, 0.0).to(dtype)
