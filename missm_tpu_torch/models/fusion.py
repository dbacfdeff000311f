"""Fusion heads, after missm_tpu/models/fusion.py. This slice ports the `sum`
head; every other `fusion_type` raises NotImplementedError.

Missing-modality masks are post-encoder selects on the per-sample scalar
`missing_index` (0 = complete, else MODALITY_CODES). Fusion params are f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

from ..core.config import MODALITY_CODES
from ..ops.basic import dropout, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    fusion_type: str
    modality_types: Tuple[str, ...]
    output_dims: int
    feature_dims: int = 768
    fusion_dim: int = 256
    dropout_prob: float = 0.1

    @property
    def num_modalities(self) -> int:
        return len(self.modality_types)


# -- init helpers (torch nn.Linear default init: U(+-1/sqrt(fan_in))) --------

def _torch_linear(gen, d_in, d_out):
    bound = 1.0 / math.sqrt(d_in)
    return {
        "w": torch.empty(d_in, d_out, device=gen.device).uniform_(
            -bound, bound, generator=gen),
        "b": torch.empty(d_out, device=gen.device).uniform_(
            -bound, bound, generator=gen),
    }


def _ln(d, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _init_head(gen, cfg: FusionConfig, in_dim: int):
    """The shared classifier head: Linear -> ReLU -> Dropout -> Linear."""
    return {"fc1": _torch_linear(gen, in_dim, cfg.fusion_dim),
            "fc2": _torch_linear(gen, cfg.fusion_dim, cfg.output_dims)}


def _apply_head(p, cfg, x, train, generator):
    h = torch.relu(linear(p["fc1"], x))
    h = dropout(h, cfg.dropout_prob, deterministic=not train,
                generator=generator)
    return linear(p["fc2"], h)


# -- mask helpers ------------------------------------------------------------

def missing_masks(cfg: FusionConfig, missing_index) -> Dict[str, torch.Tensor]:
    """{modality: [B] bool, True where that modality is MISSING}. Modalities
    without a missing code (depth, thermal) are always present."""
    return {m: missing_index == MODALITY_CODES.get(m, -1)
            for m in cfg.modality_types}


def present_matrix(cfg: FusionConfig, missing_index) -> torch.Tensor:
    """[B, M] bool, True where present, columns in modality_types order."""
    return torch.stack([missing_index != MODALITY_CODES.get(m, -1)
                        for m in cfg.modality_types], dim=1)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def init_sum(gen, cfg):
    return {"proj": {m: _torch_linear(gen, cfg.feature_dims, cfg.fusion_dim)
                     for m in cfg.modality_types},
            "norm": _ln(cfg.fusion_dim, gen.device),
            "head": _init_head(gen, cfg, cfg.fusion_dim)}


def _fwd_sum(p, cfg, embeds, missing_index, train, generator):
    miss = missing_masks(cfg, missing_index)
    total = 0.0
    for m in cfg.modality_types:
        total = total + torch.where(miss[m][:, None], 0.0,
                                    linear(p["proj"][m], embeds[m]))
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], total), train,
                       generator), {}


_INIT = {"sum": init_sum}
_FWD = {"sum": _fwd_sum}


def _check(cfg: FusionConfig):
    if cfg.fusion_type not in _FWD:
        raise NotImplementedError(
            f"fusion_type {cfg.fusion_type!r} is not ported yet "
            f"(ported: {sorted(_FWD)})")


def init_fusion(gen: torch.Generator, cfg: FusionConfig):
    _check(cfg)
    return _INIT[cfg.fusion_type](gen, cfg)


def fusion_forward(params, cfg: FusionConfig,
                   embeds: Mapping[str, torch.Tensor], missing_index, *,
                   train: bool = False, generator: torch.Generator | None = None):
    """embeds: {modality: [B, feature_dims]} f32; missing_index: [B] int.
    Returns (logits [B, output_dims], aux dict)."""
    _check(cfg)
    return _FWD[cfg.fusion_type](params, cfg, embeds, missing_index, train,
                                 generator)
