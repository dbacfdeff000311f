"""Batch loaders, after missm_tpu/data/loaders.py: sampling order, host
sharding, collation.

Replaces torch DataLoader + DistributedSampler (reference
data_loader.py:289-361). A loader yields (data, labels, missing) batches:
language as the tokenizer's numpy arrays, every other modality as its
media loader's outputs stacked (`torch.stack` for tensors, which stay on
their device; `np.stack` for numpy arrays), labels and codes as numpy
int32.

Sampling-order parity: DistributedSampler(shuffle=True, seed=0) without
`set_epoch` draws torch.randperm(n, generator=seed 0) — the *same*
permutation every epoch (the reference never calls set_epoch,
train_ddp.py:215-220). `epoch_order` draws it with the same call, as the
JAX package does.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .datasets import DATASET_SPECS, MMDataset, encode_labels
from .missing import MISSING_RATIOS, load_missing_index

# one decode pool per worker count, shared across BatchLoaders: the test
# sweep builds ~31 loaders (3 missing types x 10 ratios + train) and
# per-loader pools would pin hundreds of idle threads for the process
# lifetime. ThreadPoolExecutor.map is thread-safe, so the prefetch
# thread and the main thread can share one pool.
_POOLS: Dict[int, object] = {}
_POOLS_LOCK = threading.Lock()


def _decode_pool(num_workers: int):
    with _POOLS_LOCK:
        pool = _POOLS.get(num_workers)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(num_workers,
                                      thread_name_prefix="missm-decode")
            _POOLS[num_workers] = pool
        return pool


def epoch_order(n: int, shuffle: bool, seed: int = 0,
                epoch: int = 0) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    g = torch.Generator()
    g.manual_seed(seed + epoch)
    return torch.randperm(n, generator=g).numpy()


def _as_item(x):
    """A media loader's output as the batch holds it: tensors as they are,
    anything else as a numpy array."""
    return x if torch.is_tensor(x) else np.asarray(x)


class BatchLoader:
    """Iterates (data, labels, missing_index) batches.

    collate: language -> tokenizer(batch of texts); other modalities ->
    media_loaders[m](raw) stacked. Pads the sample list like
    DistributedSampler (wrap-around) so every shard sees equal batches.
    """

    def __init__(self, dataset: MMDataset, batch_size: int, tokenizer=None,
                 media_loaders: Optional[Dict[str, Callable]] = None,
                 shuffle: bool = True, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0, drop_last: bool = False,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.media_loaders = media_loaders or {}
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        per_shard = math.ceil(len(self.dataset) / self.num_shards)
        if self.drop_last:
            return per_shard // self.batch_size
        return math.ceil(per_shard / self.batch_size)

    def _shard_indices(self) -> np.ndarray:
        order = epoch_order(len(self.dataset), self.shuffle, self.seed,
                            self.epoch)
        n = len(order)
        per_shard = math.ceil(n / self.num_shards)
        total = per_shard * self.num_shards
        if total > n:  # wrap-around padding (DistributedSampler)
            order = np.concatenate([order, order[: total - n]])
        idx = order[self.shard_index::self.num_shards]
        # wrap duplicates occupy positions n..total-1 of the strided
        # order, i.e. the TAIL of each affected shard. Record how many
        # of this shard's rows are real so eval can exclude the
        # duplicates from metrics (the reference's DistributedSampler
        # counts them — a documented defect fixed here, docs/PARITY.md).
        self.shard_real_count = len(idx) - sum(
            1 for p in range(n, total)
            if p % self.num_shards == self.shard_index)
        return idx

    def _decode_map(self, loader: Callable, column):
        """Per-item media decode, fanned over `num_workers` threads (the
        native ingest releases the GIL in its ctypes calls, PIL in its
        decoder, torch in its ops). Ordered-rng loaders (reference
        randomness parity runs, which consume a shared sequential
        Generator) stay on the calling thread so the draw order is
        worker-count-invariant."""
        if self.num_workers <= 1 or len(column) <= 1 or getattr(
                loader, "ordered_rng", False):
            return [_as_item(loader(x)) for x in column]
        pool = _decode_pool(self.num_workers)
        return list(pool.map(lambda x: _as_item(loader(x)), column))

    def _collate(self, items):
        raws, labels, codes = zip(*items)
        data = {}
        for m in self.dataset.spec.modalities:
            column = [r[m] for r in raws]
            if m == "language":
                if self.tokenizer is None:
                    raise ValueError("language modality needs a tokenizer")
                data[m] = self.tokenizer(list(column))
            else:
                decoded = self._decode_map(self.media_loaders[m], column)
                data[m] = (torch.stack(decoded)
                           if torch.is_tensor(decoded[0])
                           else np.stack(decoded))
        return (data, np.asarray(labels, np.int32),
                np.asarray(codes, np.int32))

    def __iter__(self) -> Iterator:
        idx = self._shard_indices()
        bs = self.batch_size
        n_batches = len(idx) // bs if self.drop_last else math.ceil(
            len(idx) / bs)
        for b in range(n_batches):
            chunk = idx[b * bs:(b + 1) * bs]
            yield self._collate([self.dataset[i] for i in chunk])


def _read_csv(csv_path: str):
    import pandas as pd
    return pd.read_csv(csv_path, converters={"clip_id": str})


def training_loader(args, csv_path: str, tokenizer, media_loaders,
                    num_shards: int = 1, shard_index: int = 0):
    """(train_loader, valid_loader, num_classes) — reference
    data_loader.py:289-315."""
    spec = DATASET_SPECS[args.datasetName]
    data_path = "/".join(csv_path.split("/")[:-1])
    df = _read_csv(csv_path)
    labels, num_classes = encode_labels(list(df["annotation"]))

    train_df = df[df["mode"] == "train"]
    valid_df = df[df["mode"] == "valid"]
    train_data = MMDataset(spec, train_df, data_path,
                           labels[df["mode"] == "train"], "train",
                           args.train_missing,
                           retrieval=args.fusion_type == "retrieval")
    val_data = MMDataset(spec, valid_df, data_path,
                         labels[df["mode"] == "valid"], "val", False)

    nw = getattr(args, "num_workers", 0)
    mk = lambda ds: BatchLoader(ds, args.batch_size, tokenizer, media_loaders,
                                shuffle=True, num_shards=num_shards,
                                shard_index=shard_index, num_workers=nw)
    return mk(train_data), mk(val_data), num_classes


def testing_loader(args, csv_path: str, tokenizer, media_loaders,
                   missing_path: Optional[str] = None):
    """(train_loader, {missing_type: {ratio: loader}}, num_classes) —
    reference data_loader.py:318-361. ratio 0.0 is the complete test set."""
    spec = DATASET_SPECS[args.datasetName]
    data_path = "/".join(csv_path.split("/")[:-1])
    df = _read_csv(csv_path)
    labels, num_classes = encode_labels(list(df["annotation"]))

    train_df = df[df["mode"] == "train"]
    test_df = df[df["mode"] == "test"]
    test_labels = labels[df["mode"] == "test"]

    missing_path = missing_path or (data_path + "/missing_index.pkl")
    file = load_missing_index(missing_path)

    train_data = MMDataset(spec, train_df, data_path,
                           labels[df["mode"] == "train"], "train", False,
                           retrieval=args.fusion_type == "retrieval")
    mk = lambda ds: BatchLoader(ds, args.batch_size, tokenizer, media_loaders,
                                shuffle=False,
                                num_workers=getattr(args, "num_workers", 0))
    test_loader: Dict[str, Dict[float, BatchLoader]] = {}
    for modal in args.test_missing_type:
        per_ratio = {}
        for r in MISSING_RATIOS:
            ds = MMDataset(spec, test_df, data_path, test_labels, "test",
                           True, file["test"][modal][r],
                           args.fusion_type == "retrieval", train_data)
            per_ratio[r] = mk(ds)
        per_ratio[0.0] = mk(MMDataset(spec, test_df, data_path, test_labels,
                                      "test", False))
        test_loader[modal] = per_ratio

    return mk(train_data), test_loader, num_classes


# keep pytest from collecting these API names (they mirror the reference's
# function names, which start with "test"/"train")
training_loader.__test__ = False  # type: ignore[attr-defined]
testing_loader.__test__ = False  # type: ignore[attr-defined]
