"""Parameter bridge: the JAX package's param pytree -> the port's params.

Input: nested dicts of numpy arrays, e.g.
`jax.tree_util.tree_map(np.asarray, params)` of
`missm_tpu.models.finetune.init_model_params`. Output: the same nested dicts
of torch tensors on `device`, with one change of layout: every `blocks`
stack [L, ...] becomes a list of L per-layer dicts. Linear weights stay
(in, out), LoRA factors stay lora_a (in, r) / lora_b (r, out), and every
leaf keeps its dtype (fusion params are f32 in, f32 out).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.device import resolve_device


def _tensor(arr, device):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native torch twin
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _convert(node, device):
    if not isinstance(node, Mapping):
        return _tensor(node, device)
    out = {}
    for key, value in node.items():
        if key == "blocks":
            first = value
            while isinstance(first, Mapping):
                first = next(iter(first.values()))
            out[key] = [_convert(_layer(value, i), device)
                        for i in range(np.shape(first)[0])]
        else:
            out[key] = _convert(value, device)
    return out


def _layer(stack, i):
    if isinstance(stack, Mapping):
        return {k: _layer(v, i) for k, v in stack.items()}
    return np.asarray(stack)[i]


def from_jax(tree: Mapping, *, device="cuda"):
    """The port's params for a JAX param tree of numpy arrays."""
    return _convert(tree, resolve_device(device))
