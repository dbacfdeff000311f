"""Checkpointing with the reference's two-artifact contract, after
missm_tpu/train/checkpoint.py:

1. best full checkpoint — {epoch, model params, opt state, val_metrics,
   args} saved whenever val accuracy improves (train_ddp.py:300-306);
2. final model params — the best params re-saved standalone at the end
   (train_ddp.py:320-323), what test.py loads (:92).

A checkpoint is a directory holding the tree (nested dicts and lists of
CPU tensors, numbers, strings, None) as one `torch.save` file, `tree.pt`,
and the metadata as `missm_meta.json` beside it, as in the JAX package.
Loads use `torch.load(..., weights_only=True)`. The format is the port's
own: it does not read the JAX package's Orbax checkpoints, nor they its.

Across processes (a `torch.distributed` group of more than one rank) the
tree a save receives is already the full logical tree: the caller gathers
the FSDP and TP shards and the pipeline stages first
(parallel.partitioning.Layout.gather, a collective), as the JAX package's
`_host_value` all-gathers sharded leaves. Rank 0 writes, through its serial
writer; every rank then meets at a barrier once the write has landed (the
JAX package's swap barrier), so a restore on any rank, or a one-process
`cli.test`, reads the whole checkpoint. A restore reads the full tree on
every rank; the caller re-shards it (Layout.partition).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..models.finetune import tree_map

TREE_FILE = "tree.pt"
META_FILE = "missm_meta.json"


def _world() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only one."""
    return _world() == 1 or torch.distributed.get_rank() == 0


def _barrier():
    if _world() > 1:
        torch.distributed.barrier()


def _host_value(x):
    """A leaf as the file holds it: tensors detached on the CPU (a new
    tensor when `x` lies on the card, the same storage when it lies on the
    CPU), numpy arrays as tensors sharing their memory, anything else (a
    number, a string, None) as it is."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


class _SerialWriter:
    """All checkpoint writes in a process run on one daemon thread, in
    submission order: a synchronous save (the preemption's resume
    checkpoint) queues behind any in-flight asynchronous write and cannot
    interleave with it. The JAX package needs the order for its
    multi-process barriers too; here one process writes.

    At interpreter exit the writes already submitted finish first: the
    thread is a daemon, and one stopped inside torch.save at finalization
    aborts the process (std::terminate) instead of letting it exit with
    its own code. A kill by signal skips this; the atomic swap covers it."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._q = None
        self._thread = None
        self._last = None

    def _drain(self):
        job = self._last
        if job is not None:
            job.done.wait()

    def submit(self, fn):
        """Enqueue fn; returns a job with .done (Event) and .err."""
        import queue
        import threading

        class _Job:
            __slots__ = ("fn", "err", "done")

            def __init__(self, fn):
                self.fn = fn
                self.err = None
                self.done = threading.Event()

        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._q = queue.Queue()

                def run(q=self._q):
                    while True:
                        job = q.get()
                        try:
                            job.fn()
                        except BaseException as e:  # noqa: BLE001
                            job.err = e
                        finally:
                            job.done.set()

                # daemon: see AsyncSaver (crash safety comes from _write's
                # atomic swap, not from draining at exit)
                self._thread = threading.Thread(
                    target=run, daemon=True, name="missm-ckpt-writer")
                self._thread.start()
                if self._last is None:
                    import atexit
                    atexit.register(self._drain)
            job = _Job(fn)
            self._last = job
            self._q.put(job)
        return job


_WRITER = _SerialWriter()


def _meta_json(metadata: Optional[dict]) -> Optional[str]:
    """Serialize metadata at submission time: callers pass live structures
    (the train loop's growing `history` list) and the write runs later on
    the writer thread; serializing then would capture mutations newer than
    the checkpoint's tensors."""
    return None if metadata is None else json.dumps(metadata, default=str)


def _write(path: str, host_tree: Any, metadata: Optional[str]):
    """torch.save + disk, on the _WRITER thread. `host_tree` already holds
    CPU tensors (see AsyncSaver); `metadata` is a JSON string.

    Crash-safe: writes into `path + ".tmp"` and swaps it in only once
    complete, demoting the previous checkpoint to `path + ".old"` for the
    moment between the two renames, so a process dying mid-write (OOM,
    preemption, SIGKILL) never destroys the previous checkpoint at `path`;
    _resolve_ckpt_dir recovers from `.old` when the kill fell between the
    renames."""
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)  # debris of a write that died
    os.makedirs(tmp)
    torch.save(host_tree, os.path.join(tmp, TREE_FILE))
    if metadata is not None:
        with open(os.path.join(tmp, META_FILE), "w") as f:
            f.write(metadata)
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)  # keep the previous checkpoint until the
    os.rename(tmp, path)      # new one is in place
    if os.path.isdir(old):
        shutil.rmtree(old)


def save_checkpoint(path: str, tree: Any, metadata: Optional[dict] = None):
    """Save a tree + metadata dict at `path` (a directory). Blocks until
    the write lands; routed through the process-wide serial writer, so it
    lands after every write submitted before it. Across processes rank 0
    writes and every rank returns once the write has landed."""
    err = None
    if _writes():
        host_tree = tree_map(_host_value, tree)
        job = _WRITER.submit(lambda: _write(path, host_tree,
                                            _meta_json(metadata)))
        job.done.wait()
        err = job.err
    _barrier()
    if err is not None:
        raise err


class AsyncSaver:
    """Checkpoint saves off the training path.

    save() copies the tree to the host before it returns: the train step
    updates params and optimizer state in place, so the write must not
    read them later. A tensor on the card is copied by its transfer; one
    on the CPU (and a numpy array) is cloned. The write — torch.save and
    the disk — runs on the process-wide _WRITER thread, in submission
    order with every other write. Per saver, at most one write is in
    flight: a newer save joins the previous one first, and errors surface
    at the next save()/wait().

    Crash semantics: _write writes to a temp dir and swaps atomically, so
    a process killed with a write in flight loses at most the new
    checkpoint; the previous one at `path` stays intact. A process that
    exits (an exception unwinding past the loop) finishes the writes it
    submitted first (_SerialWriter).

    Across processes rank 0 writes, and wait() ends on a barrier of every
    rank once the write has landed (every rank calls save() and wait() in
    the same order).
    """

    def __init__(self):
        self._job = None
        self._pending = False

    @staticmethod
    def _snapshot(x):
        if torch.is_tensor(x):
            h = x.detach().cpu()
            return h.clone() if x.device.type == "cpu" else h
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x))
        return x

    def save(self, path: str, tree: Any, metadata: Optional[dict] = None):
        host_tree = tree_map(self._snapshot, tree) if _writes() else None
        meta_json = _meta_json(metadata)  # snapshot now, not at write time
        self.wait()
        self._pending = True
        if _writes():
            self._job = _WRITER.submit(lambda: _write(path, host_tree,
                                                      meta_json))

    def wait(self):
        """Block until the in-flight write (if any) lands; re-raise its
        error. Call it before restoring a path this saver wrote."""
        if not self._pending:
            return
        self._pending = False
        err = None
        if self._job is not None:
            job, self._job = self._job, None
            job.done.wait()
            err = job.err
        _barrier()
        if err is not None:
            raise err


def _resolve_ckpt_dir(path: str) -> str:
    path = os.path.abspath(path)
    if not os.path.isdir(path) and os.path.isdir(path + ".old"):
        # a crash between _write's two renames leaves only the
        # demoted-but-complete previous checkpoint: recover from it
        return path + ".old"
    return path


def read_metadata(path: str) -> Optional[dict]:
    """The metadata dict saved alongside a checkpoint, without loading
    its tensors."""
    meta_path = os.path.join(_resolve_ckpt_dir(path), META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None


def restore_checkpoint(path: str):
    """(tree, metadata), the tree's tensors on the CPU. The JAX package's
    `like` and `structure` have no counterpart: torch.load rebuilds the
    saved dicts, lists and tuples as they were, with their dtypes. Every
    rank reads the whole tree."""
    path = _resolve_ckpt_dir(path)
    tree = torch.load(os.path.join(path, TREE_FILE), map_location="cpu",
                      weights_only=True)
    return tree, read_metadata(path)
