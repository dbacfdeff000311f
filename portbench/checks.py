"""What `correct` compares: each number beside its limit, and the harness's
own arithmetic for the numbers it works out (the sweep's metrics, the
training's norms by the worst leaf)."""
from __future__ import annotations

import itertools
import statistics
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float
    note: str = ""          # where the value was read, for standard error

    @property
    def ok(self) -> bool:
        # a NaN reading fails
        return self.value <= self.limit


def metrics(labels, preds, probs) -> dict:
    """Accuracy, macro-F1 over the classes seen in labels or predictions,
    and the one-vs-one AUC (Hand and Till) macro-averaged over the class
    pairs of the labels, the pair's AUCs counted over every (positive,
    negative) pair with ties as one half."""
    labels, preds, probs = (np.asarray(labels), np.asarray(preds),
                            np.asarray(probs, np.float64))
    f1 = []
    for c in np.union1d(labels, preds):
        tp = np.sum((preds == c) & (labels == c))
        wrong = np.sum((preds == c) != (labels == c))
        f1.append(0.0 if 2 * tp + wrong == 0 else 2 * tp / (2 * tp + wrong))

    def auc(pos, neg):
        d = pos[:, None] - neg[None, :]
        return (np.sum(d > 0) + 0.5 * np.sum(d == 0)) / d.size

    classes = np.unique(labels)
    pairs = [(auc(probs[labels == a, a], probs[labels == b, a])
              + auc(probs[labels == b, b], probs[labels == a, b])) / 2
             for a, b in itertools.combinations(classes, 2)]
    return {"accuracy": float(np.mean(labels == preds)),
            "f1": float(np.mean(f1)),
            "auc": float(np.mean(pairs))}


def leaf_gaps(gap, ref, keep=None):
    """[(gap, leaf)], sorted: each leaf's `gap` (a norm's gap, or the norm of
    a difference) against the larger of the leaf's reference norm `ref` and
    the median leaf's, with the leaf's index. `keep` leaves out the leaves
    it marks False (from the median too)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return sorted((gap[i] / max(ref[i], med), i) for i in idx)
