"""Shared pieces of the harness's tests: tiny versions of the benchmark's
configurations and mixes for the CPU, and the card fixture of the tests
marked `cuda`."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load(kind, name):
    with open(BENCH / kind / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def tiny_config(name):
    """configs/<name>.json with every width and depth cut to a CPU test's
    size; the structure (towers, temporal attention, masks, head) kept."""
    cfg = copy.deepcopy(load("configs", name))
    for _, v in cfg["towers"]:
        v.update(hidden_size=32, intermediate_size=64, num_layers=2,
                 num_heads=2, patch_size=16, projection_dim=24)
        v["image_size"] = [32, 48] if v["image_size"][0] != 224 else [32, 32]
        if v.get("add_time_attn"):
            v["num_frames"] = 4
    cfg["text"].update(vocab_size=99, hidden_size=32, intermediate_size=64,
                       num_layers=2, num_heads=2, max_position_embeddings=16,
                       projection_dim=24)
    cfg["projection_dim"] = 24
    cfg["fusion"].update(feature_dims=24, fusion_dim=8)
    return cfg


def tiny_mix(name, **overrides):
    mix = load("traffic", name)
    if mix["kind"] == "sweep":
        mix.update(rows=11, batch=4, ratios=[0.3, 0.6], check_batches=2,
                   reference_rows=3)
    else:
        mix.update(batch=4, pool=4, reference_rows=2)
    mix["text_lengths"] = [3, 12]
    mix.update(overrides)
    return mix


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
