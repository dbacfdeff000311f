"""Multi-tower encoder, after missm_tpu/models/encoder.py.

A dict of per-modality vision towers, projections and logit scales, and a
language tower that is the text tower of the LAST modality tower (the
reference's ordering-sensitive behaviour, kept explicitly).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from ..core.config import TowerConfig
from ..ops.basic import l2_normalize
from .tower import init_tower_params, text_features, vision_features


def init_encoder_params(gen: torch.Generator,
                        tower_cfgs: Mapping[str, TowerConfig]):
    """tower_cfgs: ordered {modality: TowerConfig} for the non-language
    modalities. The language branch shares the text tower of the LAST one."""
    mods = list(tower_cfgs)
    towers = {m: init_tower_params(gen, tower_cfgs[m]) for m in mods}
    return build_encoder_params(towers, mods)


def build_encoder_params(towers: Dict[str, dict], order: Sequence[str]):
    """Encoder params from full dual-tower params; the language encoder is
    (the same objects as) the text tower of order[-1]."""
    enc = {m: {"vision": towers[m]["vision"],
               "proj": towers[m]["visual_projection"],
               "logit_scale": towers[m]["logit_scale"]} for m in order}
    last = order[-1]
    enc["language"] = {"text": towers[last]["text"],
                       "proj": towers[last]["text_projection"]}
    return enc


def encode(params, tower_cfgs: Mapping[str, TowerConfig], inputs: Mapping, *,
           use_temp: bool = True, train: bool = False) -> Dict[str, torch.Tensor]:
    """inputs: {'language': input_ids [B, L] or {'input_ids', 'attention_mask'}}
    and/or {modality: pixel_values [B, C, H, W]}.

    Returns {modality: [B, projection_dim]} L2-normalised embeddings, the
    non-language ones times exp(logit_scale) when `use_temp`. Missing-modality
    masking happens after the encoder, in the fusion head."""
    out = {}
    any_cfg = next(iter(tower_cfgs.values()))
    for name, value in inputs.items():
        if name == "language":
            if isinstance(value, Mapping):
                ids, am = value["input_ids"], value.get("attention_mask")
            else:
                ids, am = value, None
            _, pooled = text_features(params["language"]["text"], any_cfg.text,
                                      ids, am,
                                      projection=params["language"]["proj"])
            out[name] = l2_normalize(pooled)
        else:
            pooled = vision_features(params[name]["vision"],
                                     tower_cfgs[name].vision, value,
                                     train=train,
                                     projection=params[name]["proj"])
            pooled = l2_normalize(pooled)
            if use_temp:
                pooled = pooled * torch.exp(params[name]["logit_scale"])
            out[name] = pooled
    return out
