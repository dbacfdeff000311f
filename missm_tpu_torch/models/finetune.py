"""The benchmark model: multi-tower encoder + fusion head, after
missm_tpu/models/finetune.py.

Casts follow the JAX package: encoder params and media go to
`compute_dtype`, the encoder's embeddings come back as f32, and the fusion
params stay f32 throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch

from ..core.config import TowerConfig
from ..core.device import resolve_device
from ..ops.image_transforms import OPENAI_MEAN, OPENAI_STD
from .encoder import encode, init_encoder_params
from .fusion import FusionConfig, fusion_forward, init_fusion


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """`towers` maps each non-language modality to its TowerConfig, ordered
    (the language tower is the last entry's text tower). compute_dtype:
    'bfloat16' runs the encoder in bf16; 'float32' for parity tests."""
    towers: Tuple[Tuple[str, TowerConfig], ...]
    fusion: FusionConfig
    use_temp: bool = True
    compute_dtype: str = "float32"

    @property
    def tower_dict(self):
        return dict(self.towers)


def tree_map(fn, tree):
    """fn applied to every tensor of a param tree of dicts and lists."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_tree(tree, dtype):
    """Every floating tensor of a param tree cast to dtype (a tensor already
    of that type is returned as it is)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def _dequantize(x, dtype):
    """uint8 media batch [B, 3, H, W] -> normalised CLIP input; normalised
    in f32, then cast."""
    shape = (1, 3) + (1,) * (x.dim() - 2)
    mean = torch.tensor(OPENAI_MEAN, device=x.device).reshape(shape)
    std = torch.tensor(OPENAI_STD, device=x.device).reshape(shape)
    return ((x.float() / 255.0 - mean) / std).to(dtype)


def _prepare_inputs(data: Mapping, dtype, device):
    """Move every input to `device`; media to `dtype` (uint8 media through
    _dequantize), language ids and masks as they are."""
    out = {}
    for k, v in data.items():
        if k == "language":
            out[k] = ({n: torch.as_tensor(t, device=device)
                       for n, t in v.items()} if isinstance(v, Mapping)
                      else torch.as_tensor(v, device=device))
            continue
        v = torch.as_tensor(v, device=device)
        out[k] = _dequantize(v, dtype) if v.dtype == torch.uint8 else v.to(dtype)
    return out


def init_model_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Seeded f32 params on `device`, drawn as the JAX package draws them
    (same distributions, not the same numbers)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return {"encoder": init_encoder_params(gen, cfg.tower_dict),
            "fusion": init_fusion(gen, cfg.fusion)}


def _encode(params, cfg: ModelConfig, data, device, train):
    dt = getattr(torch, cfg.compute_dtype)
    data = _prepare_inputs(data, dt, resolve_device(device))
    embeds = encode(cast_tree(params["encoder"], dt), cfg.tower_dict, data,
                    use_temp=cfg.use_temp, train=train)
    return {k: v.float() for k, v in embeds.items()}


def model_forward(params, cfg: ModelConfig, data: Mapping, missing_index, *,
                  train: bool = False, generator: torch.Generator | None = None,
                  device="cuda"):
    """data: {'language': ids [B, L] | {'input_ids', 'attention_mask'}} and
    {modality: pixels}; returns (logits [B, output_dims] f32, aux)."""
    embeds = _encode(params, cfg, data, device, train)
    missing_index = torch.as_tensor(missing_index, device=resolve_device(device))
    return fusion_forward(params["fusion"], cfg.fusion, embeds, missing_index,
                          train=train, generator=generator)


@torch.inference_mode()
def embed_only(params, cfg: ModelConfig, data: Mapping, *, device="cuda"):
    """Encoder-only pass at cfg.compute_dtype; f32 embeddings."""
    return _encode(params, cfg, data, device, train=False)
