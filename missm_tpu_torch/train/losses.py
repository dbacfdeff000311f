"""Training losses, after missm_tpu/train/losses.py.

- cross_entropy: nn.CrossEntropyLoss (mean reduction, log-softmax in f32).
- kl_distill_loss: KL(softmax(teacher/T) || softmax(student/T)) with
  reduction='batchmean', teacher detached, temperature 0.15.
- mse_loss: nn.MSELoss, mean reduction, teacher detached (MTD_stu).
- the masked forms reduce over the rows where a [B] bool mask is True.

At T = 0.15 most of softmax(teacher/T) underflows to exactly 0: those
elements contribute 0 (torch's kl_div convention 0 * log 0 = 0), guarded on
both sides of the log so that neither the value nor the gradient is NaN.
"""
from __future__ import annotations

import torch

KL_TEMPERATURE = 0.15


def per_sample_cross_entropy(logits, labels):
    """Per-row NLL (no reduction), log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits, labels):
    """nn.CrossEntropyLoss with mean reduction."""
    return per_sample_cross_entropy(logits, labels).mean()


def _kl_elements(student, teacher, temperature):
    """t * (log t - log_softmax(s / T)) with t = softmax(teacher / T), 0
    where t is 0."""
    s = torch.log_softmax(student.float() / temperature, dim=1)
    t = torch.softmax(teacher.detach().float() / temperature, dim=1)
    pos = t > 0
    return torch.where(pos, t * (torch.log(torch.where(pos, t, 1.0)) - s),
                       0.0)


def kl_distill_loss(student, teacher, temperature: float = KL_TEMPERATURE):
    """F.kl_div(log_softmax(s/T), softmax(t/T), reduction='batchmean')."""
    return _kl_elements(student, teacher, temperature).sum() / student.shape[0]


def mse_loss(a, b):
    return torch.mean(torch.square(a - b.detach()))


def _count(mask):
    return torch.clamp(mask.sum(), min=1)


def masked_mse_loss(a, b, mask):
    """nn.MSELoss mean over only the rows where `mask` is True: the masked
    per-row sum over (count * row width)."""
    sq = torch.square(a - b.detach()).sum(dim=1)
    return torch.where(mask, sq, 0.0).sum() / (_count(mask) * a.shape[1])


def masked_kl_distill(student, teacher, mask,
                      temperature: float = KL_TEMPERATURE):
    """KL over only the rows where `mask` is True, batchmean over those
    rows: the masked per-row KL sum over the masked count."""
    row = _kl_elements(student, teacher, temperature).sum(dim=1)
    return torch.where(mask, row, 0.0).sum() / _count(mask)
