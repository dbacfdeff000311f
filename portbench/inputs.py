"""Inputs made from the seed, in the layout the port's loaders hand over:
f32 media as host tensors, token ids (and the tokenizer's attention mask
where the configuration passes one) and labels as numpy arrays, missing
codes by the reference's rule.

Media are drawn on the device with a torch.Generator, in blocks of rows,
and kept in pageable host memory, from where the timed path uploads them.
Every seed gives the same sizes: only the values and the order differ.
"""
from __future__ import annotations

import random

import numpy as np
import torch

CODES = {"language": 1, "video": 2, "audio": 3, "image": 4}


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


def labels(n: int, classes: int, rng: np.random.Generator):
    return rng.integers(0, classes, size=n).astype(np.int64)


def missing_codes(n: int, missing_type: str, ratio: float, modalities,
                  seed: int):
    """Per-row missing codes by the reference's rule (generate_missing.py,
    missm_tpu_torch/data/missing.py): int(n * ratio) rows drawn without
    replacement get the missing type's code; under "mixed" each draws one
    of the real modalities' codes. A local random.Random(seed) takes the
    place of the global `random.seed`."""
    r = random.Random(seed)
    codes = [0] * n
    for idx in r.sample(range(n), int(n * ratio)):
        codes[idx] = (r.choice([CODES[m] for m in modalities])
                      if missing_type == "mixed" else CODES[missing_type])
    return np.asarray(codes, np.int64)


def train_codes(n: int, choices, rng: np.random.Generator):
    """Codes drawn uniformly per row from `choices`, as the reference draws
    them at train time."""
    return rng.choice(np.asarray(choices, np.int64), size=n)


def rows(data, sl):
    """The rows `sl` of a batch: dicts of numpy arrays and tensors."""
    return {k: rows(v, sl) if isinstance(v, dict) else v[sl]
            for k, v in data.items()}
