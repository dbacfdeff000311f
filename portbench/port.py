"""The system under test: the port's entry points, built from a
configs/*.json dict. Only this module and the traffic kinds import the port.
"""
from __future__ import annotations

import dataclasses

from missm_tpu_torch.core.config import TextConfig, TowerConfig, VisionConfig
from missm_tpu_torch.models.finetune import ModelConfig
from missm_tpu_torch.models.fusion import FusionConfig

_VISION = {f.name for f in dataclasses.fields(VisionConfig)}
_TEXT = {f.name for f in dataclasses.fields(TextConfig)}


def model_config(cfg) -> ModelConfig:
    """The port's ModelConfig of `cfg`: its towers in order, the `sum` head,
    the encoder in cfg's compute type, no remat."""
    text = TextConfig(**{k: v for k, v in cfg["text"].items() if k in _TEXT})
    towers = []
    for mod, v in cfg["towers"]:
        kw = {k: val for k, val in v.items() if k in _VISION}
        kw["image_size"] = tuple(v["image_size"])
        towers.append((mod, TowerConfig(
            text=text, vision=VisionConfig(**kw),
            projection_dim=cfg["projection_dim"],
            logit_scale_init=cfg["logit_scale_init"])))
    fu = cfg["fusion"]
    fusion = FusionConfig(fusion_type=fu["fusion_type"],
                          modality_types=tuple(cfg["modality_types"]),
                          output_dims=fu["output_dims"],
                          feature_dims=fu["feature_dims"],
                          fusion_dim=fu["fusion_dim"],
                          dropout_prob=fu["dropout_prob"])
    return ModelConfig(towers=tuple(towers), fusion=fusion, remat=False,
                       compute_dtype=cfg["compute_dtype"])


def build_kernels(names) -> None:
    """Build (or find in the build cache) the port's CUDA libraries
    `names` at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from missm_tpu_torch.kernels import build
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))

