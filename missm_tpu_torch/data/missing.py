"""Offline missing-modality mask generation, after missm_tpu/data/missing.py:
the same python `random` calls in the same order with the same seeds, so
the codes come out equal to the JAX package's (and the reference's
`missing_index.pkl`).
"""
from __future__ import annotations

import pickle
import random
from typing import Dict, List, Sequence

import numpy as np

from ..core.config import MODALITY_CODES

MISSING_RATIOS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def simulate_missing_modality(n_samples: int, missing_type: str,
                              missing_ratio: float, modal: Sequence[str],
                              seed: int = 2025) -> List[int]:
    """Per-sample missing codes (0 = complete). `modal` is the dataset's
    modality list with 'mixed' appended last; 'mixed' draws uniformly from
    the real modalities (reference generate_missing.py:8-40)."""
    missing_count = int(n_samples * missing_ratio)
    missing_index_list = [0 for _ in range(n_samples)]

    random.seed(seed)
    np.random.seed(seed)

    missing_indices = random.sample(range(n_samples), missing_count)
    if missing_type == "mixed":
        modals_index = [MODALITY_CODES[m] for m in modal[:-1]]
        for idx in missing_indices:
            missing_index_list[idx] = random.choice(modals_index)
    else:
        for idx in missing_indices:
            missing_index_list[idx] = MODALITY_CODES[missing_type]
    return missing_index_list


def generate_missing_index(split_sizes: Dict[str, int],
                           modalities: Sequence[str],
                           ratios: Sequence[float] = MISSING_RATIOS,
                           seed: int = 2025) -> Dict:
    """{split: {missing_type: {ratio: [codes]}}} with the reference's seed
    schedule: all ratios of one (split, type) share a seed; the seed
    increments after each missing_type (generate_missing.py:43-63)."""
    modal = list(modalities) + ["mixed"]
    out = {}
    for split in ("train", "valid", "test"):
        n = split_sizes[split]
        out[split] = {}
        for missing_type in modal:
            out[split][missing_type] = {
                r: simulate_missing_modality(n, missing_type, r, modal, seed)
                for r in ratios
            }
            seed += 1
    return out


def save_missing_index(path: str, index: Dict):
    with open(path, "wb") as f:
        pickle.dump(index, f)


def load_missing_index(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)
