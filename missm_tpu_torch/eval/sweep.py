"""Evaluation, after missm_tpu/eval/sweep.py: the per-loader metric pass, the
train-set statistics pass and the missing-type x missing-ratio sweep with
the reference-format txt reports (byte-identical blocks).

A loader yields (data, labels, missing) batches, data as numpy arrays or
tensors and labels and codes as numpy arrays, and has a `batch_size`; a
batch may be shorter (the last one), and a sharded loader may say with
`shard_real_count` how many of its rows are real.

Quirk preserved: the reference normalises the test loss by the number of
missing types, not of batches. `loss_normalizer='reference'` reproduces
that; 'batches' gives the batch mean.

Across processes (`group`, the data group of a parallel layout), each data
rank reads its shard of the rows (the loaders' num_shards / shard_index),
and every batch's outputs, labels, loss sums and real-row counts are
gathered over the group, rank by rank, without the shards' wrap-around
duplicates (missm_tpu/eval/sweep.py's multi-host branch): the metrics
cover each row of the dataset once. The model and pipe ranks of one data
replica compute the same outputs and take part only in their model's
collectives.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..metrics import compute_metrics
from ..models.finetune import ModelConfig, embed_only, tree_map
from ..models.fusion import set_statistics
from ..utils.prefetch import prefetch
from ..utils.profiling import count, span

SPAN_POINT = "missm.eval.point"
SPAN_WAIT = "missm.eval.wait"
SPAN_STEP = "missm.eval.step"
SPAN_READBACK = "missm.eval.readback"
_END = object()


def _pad_batch(tree, target: int):
    """Every leaf's batch dim padded to `target` by repeating the last row,
    so that every batch an eval step sees has one shape."""
    def pad(x):
        n = x.shape[0]
        if n == target:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, x[-1:].expand(target - n, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)])
    return tree_map(pad, tree)


def data_group(cfg: ModelConfig):
    """The data group of cfg's parallel layout (None without one, or with
    one data rank)."""
    return None if cfg.parallel is None else cfg.parallel.data_group


def _gather_rows(group, n, *arrays):
    """Each rank's first `n` rows of `arrays` (tensors of one batch), over
    `group`, rank by rank: a list of (arrays[:n_r]) a rank, numpy. The rows
    travel as f64 (exact for the labels, codes and f32 values)."""
    from ..parallel.collectives import all_gather
    dev = arrays[0].device
    flat = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                            device=dev).double().reshape(len(a), -1)
            for a in arrays]
    widths = [f.shape[1] for f in flat]
    count = torch.full((len(flat[0]), 1), float(n), dtype=torch.float64,
                       device=dev)
    packed = torch.cat([count] + flat, dim=1)[None]
    every = all_gather(packed, 0, group).cpu().numpy()
    out = []
    for rank in every:
        n_r = int(rank[0, 0])
        parts, col = [], 1
        for a, w in zip(arrays, widths):
            parts.append(rank[:n_r, col:col + w].reshape(
                (n_r,) + tuple(a.shape[1:])))
            col += w
        out.append(parts)
    return out


def _waited(items):
    """`items`, each fetch inside the span of the layer's wait for its
    input."""
    it = iter(items)
    while True:
        with span(SPAN_WAIT):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def evaluate_loader(params, eval_step, loader, *, group=None):
    """Runs `eval_step` (make_eval_step's) over `loader`, each batch padded
    to the loader's `batch_size` with the padded rows, and the rows past the
    loader's `shard_real_count`, masked out of the loss and the gathered
    outputs. Host preparation runs ahead in a prefetch thread. With `group`
    (the data group) each rank's loader is its shard and the outputs are
    gathered over the group (see the module). Returns (batch losses,
    labels, preds, probs), numpy.

    Counts, per batch, `eval.rows` (the rows the step ran: the padded
    batch) and `eval.padded_rows` (those of them that count for nothing:
    padding and the shard's wrap-around duplicates)."""
    target = loader.batch_size

    def prepared():
        row = 0
        for data, labels, missing in loader:
            b = len(labels)
            # rows past the shard's real count are wrap-around duplicates
            # at the shard's tail: out of the loss and the outputs
            real = getattr(loader, "shard_real_count", None)
            n = b if real is None else max(0, min(b, real - row))
            row += b
            data, labels_p, missing_p = _pad_batch((data, labels, missing),
                                                   target)
            yield (n, labels[:n], data, labels_p, missing_p,
                   np.arange(target) < n)

    losses = []
    all_labels, all_preds, all_probs = [], [], []
    for n, labels, data, labels_p, missing_p, valid in _waited(
            prefetch(prepared(), 2)):
        count("eval.rows", target)
        count("eval.padded_rows", target - n)
        with span(SPAN_STEP):
            out = eval_step(params, data, labels_p, missing_p, valid=valid)
        with span(SPAN_READBACK):
            if group is not None:
                from ..parallel.collectives import all_reduce
                sums = all_reduce(torch.stack([out["loss_sum"].double(),
                                               out["count"].double()]), group)
                if float(sums[1]) > 0:
                    # a batch where every rank held only duplicates has no
                    # real rows: its 0.0 would deflate the batch mean
                    losses.append(float(sums[0]) / float(sums[1]))
                for p, pr, lab in _gather_rows(group, n, out["preds"],
                                               out["probs"].float(),
                                               torch.as_tensor(labels_p)):
                    all_preds.append(p.astype(np.int64))
                    all_probs.append(pr.astype(np.float32))
                    all_labels.append(lab.astype(np.asarray(labels).dtype))
            elif n > 0:
                # a batch of duplicates only has no real rows: its masked loss
                # 0/0 -> 0.0 would deflate the batch mean, so it is skipped
                losses.append(float(out["loss"]))
                all_preds.append(out["preds"].cpu().numpy()[:n])
                all_probs.append(out["probs"].float().cpu().numpy()[:n])
                all_labels.append(np.asarray(labels))
    if not all_labels:
        raise ValueError(
            "evaluate_loader: loader produced no batches (empty split, or "
            "a shard with zero samples) — nothing to evaluate")
    return (losses, np.concatenate(all_labels), np.concatenate(all_preds),
            np.concatenate(all_probs))


def evaluate_metrics(params, eval_step, loader, *, group=None):
    """Mean batch loss, accuracy, macro-F1 and AUC-ovo over `loader`."""
    losses, labels, preds, probs = evaluate_loader(params, eval_step, loader,
                                                   group=group)
    return compute_metrics(labels, preds, probs,
                           loss=float(np.sum(losses) / max(len(losses), 1)))


def statistics_pass(params, cfg: ModelConfig, train_loader, stat_type: str,
                    *, device="cuda") -> Dict[str, np.ndarray]:
    """{modality: the mean or the median (`stat_type`) of the encoder's
    embeddings over the whole train set}: np.mean / np.median over the
    concatenated f32 embeddings (the median of an even count is the mean of
    the two middle values). Under cfg's parallel layout each data rank
    embeds its shard and the real rows are gathered, so every row of the
    train set counts once, whatever the rank count."""
    mods = cfg.fusion.modality_types
    buf = {m: [] for m in mods}
    group = data_group(cfg)
    row = 0
    for data, labels, _ in train_loader:
        out = embed_only(params, cfg, data, device=device)
        if group is None:
            for m in mods:
                buf[m].append(out[m].cpu().numpy())
            continue
        real = getattr(train_loader, "shard_real_count", None)
        b = len(labels)
        n = b if real is None else max(0, min(b, real - row))
        row += b
        for parts in _gather_rows(group, n, *(out[m] for m in mods)):
            for m, part in zip(mods, parts):
                buf[m].append(part.astype(np.float32))
    agg = np.mean if stat_type == "mean" else np.median
    return {m: agg(np.concatenate(buf[m], axis=0), axis=0) for m in mods}


def format_report_block(ratio, metrics: Mapping[str, float]) -> str:
    """One ratio's block of the reference's txt report, byte for byte."""
    return (f"Testing with missing ratio: {ratio}\n"
            "Test Results:\n"
            f"Test Loss: {metrics['loss']:.4f}\n"
            f"Test Accuracy: {metrics['accuracy']:.4f}\n"
            f"Test F1 Score: {metrics['f1']:.4f}\n"
            f"Test AUC: {metrics['auc']:.4f}\n"
            "\n")


def run_missing_sweep(params, cfg: ModelConfig, eval_step, test_loaders,
                      out_dir: str, dataset_name: str, test_type: str, *,
                      train_loader=None,
                      loss_normalizer: str = "reference",
                      verbose: bool = True, device="cuda"):
    """The missing sweep over `test_loaders` ({missing_type: {ratio:
    loader}}). For concat_mean / concat_median the train-set statistics
    pass fills the concat head's imputation statistics first. Writes one
    txt report per missing type to `out_dir`; returns {missing_type:
    {ratio: metrics}}."""
    os.makedirs(out_dir, exist_ok=True)

    if test_type in ("concat_mean", "concat_median"):
        if train_loader is None:
            raise ValueError(f"{test_type} needs a train_loader for the "
                             "statistics pass")
        stats = statistics_pass(params, cfg, train_loader,
                                "mean" if test_type == "concat_mean"
                                else "median", device=device)
        params = dict(params,
                      fusion=set_statistics(params["fusion"], stats))

    n_types = len(test_loaders)
    results: Dict[str, Dict[float, dict]] = {}
    dist = torch.distributed
    lead = not dist.is_initialized() or dist.get_rank() == 0
    verbose = verbose and lead
    for missing_type, per_ratio in test_loaders.items():
        name = f"{dataset_name}_{test_type}_{missing_type}"
        results[missing_type] = {}
        path = os.path.join(out_dir, f"{name}.txt") if lead else os.devnull
        with open(path, "w", encoding="utf-8") as fout:
            for ratio, loader in per_ratio.items():
                with span(SPAN_POINT):
                    losses, labels, preds, probs = evaluate_loader(
                        params, eval_step, loader, group=data_group(cfg))
                    denom = (n_types if loss_normalizer == "reference"
                             else max(len(losses), 1))
                    metrics = compute_metrics(
                        labels, preds, probs,
                        loss=float(np.sum(losses) / denom))
                    results[missing_type][ratio] = metrics
                    fout.write(format_report_block(ratio, metrics))
                    if verbose:
                        print(f"[{name}] ratio={ratio} "
                              f"acc={metrics['accuracy']:.4f} "
                              f"f1={metrics['f1']:.4f} "
                              f"auc={metrics['auc']:.4f}")
    return results
