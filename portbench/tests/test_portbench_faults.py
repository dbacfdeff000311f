"""The check catches a broken timed path. Each test skips the look for a
card and drives the rest of a run on the CPU, at a tiny size in float32
under the cell's own limits: the sound run comes out correct, and a run
with each fault the cell can have (faults.py) planted underneath comes out
not correct."""
import time

import pytest
import torch

from conftest import load, tiny_config, tiny_mix
from portbench import faults, harness

CELLS = {"image-text.sweep": faults.SWEEP_FAULTS,
         "video-audio-text.sweep": faults.SWEEP_FAULTS,
         "video-audio-text.train": faults.TRAIN_FAULTS,
         "image-text.train": faults.TRAIN_FAULTS}
CASES = [(c, f) for c, fs in CELLS.items() for f in (None,) + fs]


def _correct(cell, fault, seed=2 ** 31 + 3):
    w = load("workloads", cell)
    cfg = tiny_config(w["config"])
    cfg["compute_dtype"] = "float32"
    mix = tiny_mix(w["traffic"])
    runner = harness.kind_runner(mix["kind"])(cfg, mix, seed,
                                              torch.device("cpu"))
    if fault is None:
        harness.measure(runner, 0.3, False, time.perf_counter())
    else:
        with faults.planted(fault):
            harness.measure(runner, 0.3, False, time.perf_counter())
    checks = runner.check(w["limits"])
    return all(c.ok for c in checks), checks


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    ok, checks = _correct(cell, fault)
    assert ok == (fault is None), checks
