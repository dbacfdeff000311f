"""Inputs made from the seed that every model family shares, in the layout
the port's loaders hand over: labels as numpy arrays, missing codes by the
reference's rule, a batch's rows. A family's media and token ids are its
own (models/<family>.py: `media`, `text`). Every seed gives the same sizes:
only the values and the order differ.
"""
from __future__ import annotations

import random

import numpy as np

CODES = {"language": 1, "video": 2, "audio": 3, "image": 4}


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
