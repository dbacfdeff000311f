"""Multi-tower encoder, after missm_tpu/models/encoder.py.

A dict of per-modality vision towers, projections and logit scales, and a
language tower that is the text tower of the LAST modality tower (the
reference's ordering-sensitive behaviour, kept explicitly).
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Sequence

import torch

from ..core.config import TowerConfig
from ..ops.basic import l2_normalize
from ..utils.profiling import span
from .tower import init_tower_params, text_features, vision_features


@functools.cache
def _tower_span(modality: str) -> str:
    """The span name of one tower's forward, built once a modality."""
    return f"missm.model.tower.{modality}"


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


def _remat_for(remat, modality):
    """The remat policy of one tower (missm_tpu/models/encoder.py::_remat_for).
    `remat` is either one policy (True, False or a policy name) for every
    tower, or a per-tower spec: a Mapping or a tuple of (modality, policy)
    pairs, with an optional "default" entry. A tower the spec does not name
    gets the default, else True (full remat)."""
    if isinstance(remat, tuple) and remat and isinstance(remat[0], tuple):
        remat = dict(remat)
    if isinstance(remat, Mapping):
        return remat.get(modality, remat.get("default", True))
    return remat


def encode(params, tower_cfgs: Mapping[str, TowerConfig], inputs: Mapping, *,
           use_temp: bool = True, train: bool = False, remat=False,
           generator: torch.Generator | None = None, tp=None, pipe=None
           ) -> Dict[str, torch.Tensor]:
    """inputs: {'language': input_ids [B, L] or {'input_ids', 'attention_mask'}}
    and/or {modality: pixel_values [B, C, H, W] or video [B, C, T, H, W]}.

    Returns {modality: [B, projection_dim]} L2-normalised embeddings, the
    non-language ones times exp(logit_scale) when `use_temp`. Missing-modality
    masking happens after the encoder, in the fusion head. `remat` is one
    policy or a per-tower spec, resolved by _remat_for for each tower and for
    "language" (models/tower.py::_block_forward). `generator` feeds the
    vision towers' patch dropout in train mode (the only encoder draw).
    `tp` (a ModelAxis) and `pipe` (a PipeConfig) run every tower's blocks
    under Megatron TP and over the pipe axis."""
    out = {}
    any_cfg = next(iter(tower_cfgs.values()))
    for name, value in inputs.items():
        with span(_tower_span(name)):
            if name == "language":
                if isinstance(value, Mapping):
                    ids, am = value["input_ids"], value.get("attention_mask")
                else:
                    ids, am = value, None
                lang = params["language"]
                _, pooled = text_features(lang["text"], any_cfg.text, ids, am,
                                          remat=_remat_for(remat, "language"),
                                          projection=lang["proj"], tp=tp,
                                          pipe=pipe)
                out[name] = l2_normalize(pooled)
            else:
                pooled = vision_features(params[name]["vision"],
                                         tower_cfgs[name].vision, value,
                                         train=train,
                                         remat=_remat_for(remat, name),
                                         projection=params[name]["proj"],
                                         generator=generator, tp=tp, pipe=pipe)
                pooled = l2_normalize(pooled)
                if use_temp:
                    pooled = pooled * torch.exp(params[name]["logit_scale"])
                out[name] = pooled
    return out
