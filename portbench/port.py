"""The port's services the harness calls: its kernel build and its
counters. With models/<family>.py (a configuration's model and inputs) and
the traffic kinds (the port's entry points), the only modules that import
the port.
"""
from __future__ import annotations


def build_kernels(names) -> None:
    """Build (or find in the build cache) the port's CUDA libraries
    `names` at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    from missm_tpu_torch.kernels import build
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.load, names))


def counters() -> dict:
    """A snapshot of the port's counters: {name: int total so far}."""
    from missm_tpu_torch.utils.profiling import counters
    return counters()
