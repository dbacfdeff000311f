"""Tracing and step-time observability, after missm_tpu/utils/profiling.py.

- `trace(logdir, device=...)`: a context manager around
  `torch.profiler.profile`, recording host and, on the card, CUDA activity,
  and writing a Chrome trace (`trace.json`) under `logdir`: the counterpart
  of the JAX package's `jax.profiler.trace`. The train loop's
  `--profile_dir` window uses the same profiler (`start_profiler`,
  `stop_profiler`).
- `StepTimer`: host-side step and input accounting with a duty-cycle
  estimate (the share of wall time spent in steps against input stalls),
  the JAX class's methods, properties and `summary()` keys.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List

from ..core.device import resolve_device


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


class StepTimer:
    def __init__(self):
        self.step_times: List[float] = []
        self.input_times: List[float] = []
        self._t = None

    def input_start(self):
        self._t = time.perf_counter()

    def input_end(self):
        if self._t is not None:
            self.input_times.append(time.perf_counter() - self._t)
        self._t = time.perf_counter()

    def step_end(self):
        """Call after the step's result is on the host (or after
        `torch.cuda.synchronize()`): launches return before the card
        finishes."""
        if self._t is not None:
            self.step_times.append(time.perf_counter() - self._t)
        self._t = None

    @property
    def duty_cycle(self) -> float:
        total = sum(self.step_times) + sum(self.input_times)
        if total == 0:
            return 0.0
        return sum(self.step_times) / total

    def summary(self) -> dict:
        import numpy as np
        st = np.asarray(self.step_times or [0.0])
        it = np.asarray(self.input_times or [0.0])
        return {
            "steps": len(self.step_times),
            "step_ms_mean": float(st.mean() * 1000),
            "step_ms_p50": float(np.percentile(st, 50) * 1000),
            "input_ms_mean": float(it.mean() * 1000),
            "duty_cycle": self.duty_cycle,
        }
