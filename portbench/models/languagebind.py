"""The LanguageBind family on the port's side: the port's ModelConfig of a
configs/*.json dict, and the inputs the port's loaders hand over for it
(f32 media as host tensors, CLIP token ids), made from the seed.

Media are drawn on the device with a torch.Generator, in blocks of rows,
and kept in pageable host memory, from where the timed path uploads them.
Every seed gives the same sizes: only the values and the order differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from missm_tpu_torch.core.config import TextConfig, TowerConfig, VisionConfig
from missm_tpu_torch.models.finetune import ModelConfig
from missm_tpu_torch.models.fusion import FusionConfig

_VISION = {f.name for f in dataclasses.fields(VisionConfig)}
_TEXT = {f.name for f in dataclasses.fields(TextConfig)}


def model_config(cfg) -> ModelConfig:
    """The port's ModelConfig of `cfg`: its towers in order, its fusion
    head, the encoder in cfg's compute type, no remat."""
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


def media_shape(v):
    """[C, H, W], or [C, T, H, W] for a temporal tower."""
    h, w = v["image_size"]
    if v.get("add_time_attn"):
        return (v["num_channels"], v["num_frames"], h, w)
    return (v["num_channels"], h, w)


def media(cfg, n: int, gen: torch.Generator, block: int = 32) -> dict:
    """{modality: f32 [n, ...] host tensor} of standard normal pixels (the
    loaders' normalised media), drawn on gen's device `block` rows at a
    time."""
    out = {}
    for mod, v in cfg["towers"]:
        shape = media_shape(v)
        host = torch.empty((n, *shape), dtype=torch.float32)
        for i in range(0, n, block):
            k = min(block, n - i)
            host[i:i + k] = torch.randn((k, *shape), generator=gen,
                                        device=gen.device).cpu()
        out[mod] = host
    return out


def text(cfg, n: int, rng: np.random.Generator, lengths) -> object:
    """Token ids [n, context] as the CLIP tokenizer lays them out: SOT,
    `length - 2` random tokens, EOT, then EOT as padding; with the
    configuration's attention mask (1 from SOT to the first EOT) a dict
    {input_ids, attention_mask}. `lengths` = (shortest, longest) in tokens,
    SOT and EOT included."""
    t = cfg["text"]
    ctx, vocab = t["max_position_embeddings"], t["vocab_size"]
    sot, eot = vocab - 2, vocab - 1
    lo, hi = lengths
    ids = np.full((n, ctx), eot, np.int64)
    ids[:, 0] = sot
    lens = rng.integers(lo, min(hi, ctx) + 1, size=n)
    for i, length in enumerate(lens):
        ids[i, 1:length - 1] = rng.integers(1, sot, size=length - 2)
    if not cfg.get("text_attention_mask"):
        return ids
    mask = (np.arange(ctx)[None] < lens[:, None]).astype(np.int64)
    return {"input_ids": ids, "attention_mask": mask}
