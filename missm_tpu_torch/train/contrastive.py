"""Contrastive (CLIP) objective for the dual towers, after
missm_tpu/train/contrastive.py.

Each reference tower exposes a contrastive forward with `clip_loss`
(image/modeling_image.py:941-1030, loss at :1016): symmetric cross-entropy
over the text->image similarity matrix. For tower pretraining or
fine-tuning workflows (models.tower.tower_forward); the benchmark itself
trains classifiers.
"""
from __future__ import annotations

import torch

from .losses import cross_entropy


def clip_loss(logits_per_text) -> torch.Tensor:
    """(CE(rows) + CE(cols)) / 2 with diagonal targets — HF `clip_loss`."""
    n = logits_per_text.shape[0]
    labels = torch.arange(n, device=logits_per_text.device)
    caption_loss = cross_entropy(logits_per_text, labels)
    image_loss = cross_entropy(logits_per_text.T, labels)
    return (caption_loss + image_loss) / 2.0
