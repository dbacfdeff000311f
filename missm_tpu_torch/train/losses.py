"""Classification losses, after missm_tpu/train/losses.py (the eval slice
needs only cross-entropy)."""
from __future__ import annotations

import torch


def per_sample_cross_entropy(logits, labels):
    """Per-row NLL (no reduction), log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits, labels):
    """nn.CrossEntropyLoss with mean reduction."""
    return per_sample_cross_entropy(logits, labels).mean()
