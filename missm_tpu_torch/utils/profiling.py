"""Tracing, after missm_tpu/utils/profiling.py.

- `trace(logdir, device=...)`: a context manager around
  `torch.profiler.profile`, recording host and, on the card, CUDA activity,
  and writing a Chrome trace (`trace.json`) under `logdir`: the counterpart
  of the JAX package's `jax.profiler.trace`. The train loop's
  `--profile_dir` window uses the same profiler (`start_profiler`,
  `stop_profiler`).
- `span(name)`: the port's layer boundaries (`missm.*`) as
  `record_function` ranges while a profiler records, so that they land in
  the same trace as the card's kernels and copies, on the profiler's clock;
  a shared null context, and nothing recorded, otherwise.
- `count(name, k)` and `counters()`: the port's counters, process-wide int
  totals, always on.
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

from ..core.device import resolve_device

_NULL = contextlib.nullcontext()


def span(name: str):
    """A `torch.profiler.record_function(name)` range while a profiler
    records, else a shared null context. `name` is a constant of the
    caller's module: it is never built per call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


_counts: dict = {}
_counts_lock = threading.Lock()


def count(name: str, k: int = 1) -> None:
    """Add `k` to the counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + k


def counters() -> dict:
    """A snapshot of every counter: {name: int total since the process
    started}; the difference of two snapshots is what happened between
    them."""
    with _counts_lock:
        return dict(_counts)


def start_profiler(dev):
    """A started `torch.profiler.profile` of host activity, and of CUDA
    activity when `dev` is the card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof, logdir: str, name: str) -> str:
    """Stop `prof` and write its Chrome trace to logdir/name; the path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, *, device="cuda"):
    """Profile the body on `device` (the card unless the caller asks for
    the CPU) and write logdir/trace.json; yields the profiler."""
    dev = resolve_device(device)
    prof = start_profiler(dev)
    try:
        yield prof
    finally:
        stop_profiler(prof, logdir, "trace.json")
