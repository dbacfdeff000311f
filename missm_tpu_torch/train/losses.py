"""Training losses, after missm_tpu/train/losses.py.

- cross_entropy: nn.CrossEntropyLoss (mean reduction, log-softmax in f32).
- kl_distill_loss: KL(softmax(teacher/T) || softmax(student/T)) with
  reduction='batchmean', teacher detached, temperature 0.15.
- mse_loss: nn.MSELoss, mean reduction, teacher detached (MTD_stu).
- the masked forms reduce over the rows where a [B] bool mask is True.

Under data parallelism each rank holds its rows of the batch, and the JAX
package's means are over the whole batch. With a `group` (the data group)
every mean divides this rank's sum by the count summed over the group, so
the ranks' losses (and gradients) add up to the whole batch's.

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


def total(n, like, group):
    """A count (an int or a tensor) summed over `group`, as a f32 tensor on
    `like`'s device without a gradient; `n` itself without a group."""
    if group is None:
        return n
    from ..parallel.collectives import all_reduce
    t = torch.as_tensor(n, dtype=torch.float32, device=like.device)
    return all_reduce(t.detach().float(), group)


def cross_entropy(logits, labels, group=None):
    """nn.CrossEntropyLoss with mean reduction (over the group's rows)."""
    nll = per_sample_cross_entropy(logits, labels)
    if group is None:
        return nll.mean()
    return nll.sum() / total(nll.shape[0], nll, group)


def _kl_elements(student, teacher, temperature):
    """t * (log t - log_softmax(s / T)) with t = softmax(teacher / T), 0
    where t is 0."""
    s = torch.log_softmax(student.float() / temperature, dim=1)
    t = torch.softmax(teacher.detach().float() / temperature, dim=1)
    pos = t > 0
    return torch.where(pos, t * (torch.log(torch.where(pos, t, 1.0)) - s),
                       0.0)


def kl_distill_loss(student, teacher, temperature: float = KL_TEMPERATURE,
                    group=None):
    """F.kl_div(log_softmax(s/T), softmax(t/T), reduction='batchmean')."""
    return (_kl_elements(student, teacher, temperature).sum()
            / total(student.shape[0], student, group))


def mse_loss(a, b, group=None):
    if group is None:
        return torch.mean(torch.square(a - b.detach()))
    return (torch.square(a - b.detach()).sum()
            / (total(a.shape[0], a, group) * a.shape[1]))


def _count(mask, group=None):
    return torch.clamp(total(mask.sum(), mask, group), min=1)


def masked_mse_loss(a, b, mask, group=None):
    """nn.MSELoss mean over only the rows where `mask` is True: the masked
    per-row sum over (count * row width)."""
    sq = torch.square(a - b.detach()).sum(dim=1)
    return (torch.where(mask, sq, 0.0).sum()
            / (_count(mask, group) * a.shape[1]))


def masked_kl_distill(student, teacher, mask,
                      temperature: float = KL_TEMPERATURE, group=None):
    """KL over only the rows where `mask` is True, batchmean over those
    rows: the masked per-row KL sum over the masked count."""
    row = _kl_elements(student, teacher, temperature).sum(dim=1)
    return torch.where(mask, row, 0.0).sum() / _count(mask, group)
