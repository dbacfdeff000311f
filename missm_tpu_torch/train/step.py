"""The eval step, after missm_tpu/train/step.py::make_eval_step."""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..models.finetune import ModelConfig, model_forward
from .losses import per_sample_cross_entropy


def make_eval_step(cfg: ModelConfig, *, device="cuda"):
    """Returns eval(params, data, labels, missing_index[, valid]) ->
    dict(loss, loss_sum, count, preds, probs), run on `device` (params must
    already be there; data, labels and masks may be numpy arrays).

    `valid` is an optional boolean [B] mask: rows padded in by a fixed-shape
    batcher are left out of the loss. `loss_sum` and `count` let callers
    combine the masked mean exactly across batches or processes."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def eval_fn(params, data, labels, missing_index, valid=None):
        logits, _ = model_forward(params, cfg, data, missing_index,
                                  train=False, device=dev)
        nll = per_sample_cross_entropy(logits,
                                       torch.as_tensor(labels, device=dev))
        if valid is None:
            loss_sum = nll.sum()
            count = torch.tensor(float(nll.shape[0]), device=dev)
        else:
            v = torch.as_tensor(valid, device=dev).to(nll.dtype)
            loss_sum = (nll * v).sum()
            count = v.sum()
        loss = loss_sum / torch.clamp(count, min=1.0)
        return {"loss": loss, "loss_sum": loss_sum, "count": count,
                "preds": torch.argmax(logits, dim=-1),
                "probs": torch.softmax(logits, dim=-1)}

    return eval_fn
