"""Serving-style inference, after missm_tpu/eval/predictor.py.

`Predictor` holds a trained model's params (the port's tree of tensors) on
the device, moved there once, and serves batched predictions (labels and
probabilities) for raw samples or for arrays. Partial batches are padded
to the predictor's batch size, so every forward has one shape. The
tokenizer and the media loaders are injected by the caller;
`from_checkpoint` restores the params of a train_loop checkpoint.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.finetune import ModelConfig, model_forward, tree_map
from .sweep import _pad_batch


class Predictor:
    def __init__(self, params, cfg: ModelConfig, batch_size: int = 32,
                 tokenizer=None,
                 media_loaders: Optional[Dict[str, Callable]] = None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.cfg = cfg
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.media_loaders = media_loaders or {}

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ModelConfig, **kw):
        """A Predictor over the params of a checkpoint at `path` (the final
        model train_loop writes, or its best_model), moved to `device`."""
        from ..train.checkpoint import restore_checkpoint
        tree, _ = restore_checkpoint(path)
        return cls(tree["params"], cfg, **kw)

    @torch.inference_mode()
    def _predict(self, data, missing_index):
        logits, _ = model_forward(self.params, self.cfg, data, missing_index,
                                  train=False, device=self.device)
        return torch.argmax(logits, dim=-1), torch.softmax(logits, dim=-1)

    def _collate_raw(self, samples: Sequence[Mapping]):
        """samples: [{modality: path or text}] -> batched arrays."""
        data = {}
        for m in self.cfg.fusion.modality_types:
            col = [s[m] for s in samples]
            if m == "language":
                data[m] = self.tokenizer(list(col))
            else:
                items = [self.media_loaders[m](x) for x in col]
                # the data layer's loaders give tensors on their device
                data[m] = (torch.stack(items) if torch.is_tensor(items[0])
                           else np.stack([np.asarray(x) for x in items]))
        return data

    def predict_arrays(self, data: Mapping, missing_index=None):
        """data: {modality: batched array}; returns (preds, probs) as numpy,
        cut to the batch's own length. A batch longer than the predictor's
        batch size raises."""
        n = len(next(iter(
            v["input_ids"] if isinstance(v, Mapping) else v
            for v in data.values())))
        target = self.batch_size
        if n > target:
            raise ValueError(
                f"predict_arrays got a batch of {n} rows but the compiled "
                f"batch_size is {target}; use predict() (which chunks) or "
                f"construct the Predictor with a larger batch_size")

        data = _pad_batch({k: v if isinstance(v, Mapping) or torch.is_tensor(v)
                           else np.asarray(v) for k, v in data.items()},
                          target)
        if missing_index is None:
            missing_index = np.zeros((target,), np.int32)
        else:
            missing_index = _pad_batch(np.asarray(missing_index, np.int32),
                                       target)
        preds, probs = self._predict(data, missing_index)
        return preds.cpu().numpy()[:n], probs.float().cpu().numpy()[:n]

    def predict(self, samples: Sequence[Mapping], missing_index=None):
        """Raw samples -> (preds, probs), in chunks of the batch size."""
        preds, probs = [], []
        bs = self.batch_size
        for i in range(0, len(samples), bs):
            data = self._collate_raw(samples[i:i + bs])
            mi = None if missing_index is None else missing_index[i:i + bs]
            p, pr = self.predict_arrays(data, mi)
            preds.append(p)
            probs.append(pr)
        return np.concatenate(preds), np.concatenate(probs)
