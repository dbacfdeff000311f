"""Evaluation metrics: accuracy, macro-F1, AUC one-vs-one (a copy of
missm_tpu/metrics/classification.py: the port imports nothing of the JAX
package).

Numpy reimplementations of the sklearn calls the reference harness makes
(train_ddp.py:128-133, test.py:157-162):
  accuracy_score, f1_score(average='macro'),
  roc_auc_score(multi_class='ovo')  [macro-averaged over ordered class pairs]
Parity with sklearn is pinned by tests; implementations are self-contained so
the eval path has no sklearn dependency at runtime.
"""
from __future__ import annotations

import itertools

import numpy as np


def accuracy(labels, preds) -> float:
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    return float((labels == preds).mean())


def macro_f1(labels, preds) -> float:
    """F1 averaged over the classes present in labels-or-preds (sklearn
    default: classes = union of observed labels)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    classes = np.union1d(labels, preds)
    f1s = []
    for c in classes:
        tp = float(((preds == c) & (labels == c)).sum())
        fp = float(((preds == c) & (labels != c)).sum())
        fn = float(((preds != c) & (labels == c)).sum())
        denom = 2 * tp + fp + fn
        f1s.append(0.0 if denom == 0 else 2 * tp / denom)
    return float(np.mean(f1s))


def _binary_auc(y_true, score) -> float:
    """AUC via the rank statistic (ties get average rank)."""
    y_true = np.asarray(y_true, dtype=bool)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return np.nan
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty(len(score), dtype=np.float64)
    sorted_scores = np.asarray(score)[order]
    # average ranks for ties
    i = 0
    while i < len(score):
        j = i
        while j + 1 < len(score) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    s = ranks[y_true].sum()
    return float((s - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def auc_ovo(labels, probs) -> float:
    """Multiclass AUC, one-vs-one (Hand & Till 2001), macro-averaged —
    sklearn's roc_auc_score(multi_class='ovo', average='macro').

    For each unordered class pair (a, b): restrict to samples of class a or
    b; AUC(a|b) uses P(class=a) as the score with a as positive; the pair
    score is (AUC(a|b) + AUC(b|a)) / 2. Binary probs ([N, 2]) reduce to the
    standard binary AUC on column 1 (sklearn requires shape (N,) there; we
    accept both).
    """
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    classes = np.unique(labels)
    if probs.ndim == 1 or probs.shape[1] == 1:
        return _binary_auc(labels == classes.max(), probs.reshape(-1))
    if len(classes) == 2:
        # sklearn binary path: score = prob of the greater label
        pos = classes[1]
        return _binary_auc(labels == pos, probs[:, 1])
    pair_scores = []
    for a, b in itertools.combinations(classes, 2):
        mask = (labels == a) | (labels == b)
        la = labels[mask] == a
        a_score = _binary_auc(la, probs[mask, a])
        b_score = _binary_auc(~la, probs[mask, b])
        pair_scores.append((a_score + b_score) / 2.0)
    return float(np.mean(pair_scores))


def compute_metrics(labels, preds, probs, loss: float | None = None) -> dict:
    """The reference's metric block (train_ddp.py:128-133)."""
    out = {
        "accuracy": accuracy(labels, preds),
        "f1": macro_f1(labels, preds),
        "auc": auc_ovo(labels, probs),
    }
    if loss is not None:
        out["loss"] = float(loss)
    return out
