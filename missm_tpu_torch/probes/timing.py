"""CUDA-event timing shared by the probes."""
from __future__ import annotations

import torch


def event_ms(fn, runs: int, warmup: int = 2) -> list:
    """The device time in ms of each of `runs` calls of fn, each between two
    CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times
