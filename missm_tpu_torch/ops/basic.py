"""Elementwise and dense primitives (forward), after missm_tpu/ops/basic.py.

Params are dicts of tensors; linear weights are (in, out) as in the JAX
package. Matmuls accumulate in f32 and round once to the input type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


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


def linear(params, x, *, lora_scaling: float | None = None):
    """y = x @ w (+ b) with the optional folded LoRA delta.

    `params['w']`: (in, out); optional `params['b']`: (out,); optional
    `params['lora_a']` (in, r) and `params['lora_b']` (r, out), used when
    `lora_scaling` is given. The bias is added inside the f32-accumulating
    matmul before the single rounding to x's type."""
    w = params["w"]
    if lora_scaling is not None and "lora_a" in params:
        w = _fold_lora(w, params["lora_a"], params["lora_b"], lora_scaling,
                       x.dtype)
    return F.linear(x, w.t(), params.get("b"))


def l2_normalize(x, dim: int = -1, eps: float = 0.0):
    """x / ||x||_2 with no epsilon (torch `x / x.norm(dim=-1, keepdim=True)`)."""
    return x / torch.sqrt(x.square().sum(dim=dim, keepdim=True) + eps)


def dropout(x, rate: float, deterministic: bool,
            generator: torch.Generator | None = None):
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
