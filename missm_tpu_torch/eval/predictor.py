"""Serving-style inference, after missm_tpu/eval/predictor.py.

`Predictor` holds a trained model's params (the port's tree of tensors) on
the device, moved there once, and serves batched predictions (labels and
probabilities) for raw samples or for arrays. Partial batches are padded
to the predictor's batch size, so every forward has one shape. The
tokenizer and the media loaders are injected by the caller;
`from_checkpoint` restores the params of a train_loop checkpoint.

Under a parallel layout (`cfg.parallel`, this rank's params) `predict`
does what the JAX Predictor does through its mesh device_put: each data
rank predicts its shard of the samples (the loaders' wrap-around shards),
the model and pipe ranks of one data replica the same shard, and the rows
are gathered over the data group without the wrap-around duplicates
(eval/sweep.py::_gather_rows), so every rank returns every row in order.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.loaders import shard_rows
from ..models.finetune import ModelConfig, model_forward, tree_map
from .sweep import _gather_rows, _pad_batch, data_group


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
        (preds, probs), n = self._padded(data, missing_index)
        return preds.cpu().numpy()[:n], probs.float().cpu().numpy()[:n]

    def _padded(self, data: Mapping, missing_index):
        """((preds, probs) on the device for `data` padded to the batch
        size, the batch's own length)."""
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
        return self._predict(data, missing_index), n

    def predict(self, samples: Sequence[Mapping], missing_index=None):
        """Raw samples -> (preds, probs), in chunks of the batch size; under
        a layout with more than one data rank, this rank's shard of them,
        gathered (see the module)."""
        group = data_group(self.cfg)
        if group is not None:
            return self._predict_shard(samples, missing_index, group)
        preds, probs = [], []
        bs = self.batch_size
        for i in range(0, len(samples), bs):
            data = self._collate_raw(samples[i:i + bs])
            mi = None if missing_index is None else missing_index[i:i + bs]
            p, pr = self.predict_arrays(data, mi)
            preds.append(p)
            probs.append(pr)
        return np.concatenate(preds), np.concatenate(probs)

    def _predict_shard(self, samples, missing_index, group):
        lay = self.cfg.parallel
        idx, real = shard_rows(np.arange(len(samples)), lay.n_data,
                               lay.data_index)
        preds = np.zeros(len(samples), np.int64)
        probs = None
        bs = self.batch_size
        # every rank runs as many batches (the shards are of one length),
        # so the layout's collectives and the gather meet
        for i in range(0, len(idx), bs):
            rows = idx[i:i + bs]
            data = self._collate_raw([samples[j] for j in rows])
            mi = (None if missing_index is None
                  else np.asarray(missing_index)[rows])
            (p, pr), _ = self._padded(data, mi)
            n = max(0, min(len(rows), real - i))
            for p_r, pr_r, rows_r in _gather_rows(
                    group, n, p, pr.float(),
                    torch.as_tensor(_pad_batch(rows, bs), device=p.device)):
                if probs is None:
                    probs = np.zeros((len(samples), pr_r.shape[1]),
                                     np.float32)
                at = rows_r.astype(np.int64)
                preds[at] = p_r.astype(np.int64)
                probs[at] = pr_r.astype(np.float32)
        return preds, probs
