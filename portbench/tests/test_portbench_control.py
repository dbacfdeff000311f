"""The control on the card: at each cell's own size, the plain reference at
float8 put in the port's place fails at least one of the numbers the cell's
check compares, under the cell's limits, on three seeds."""
import time

import pytest

from conftest import load
from portbench import harness

CELLS = ["image-text.sweep", "video-audio-text.train", "image-text.train",
         "video-audio-text.sweep"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(card, cell, seed):
    w = load("workloads", cell)
    _, cfg, mix = harness.cell_files(cell)
    runner = harness.kind_runner(mix["kind"])(cfg, mix, seed, card)
    harness.measure(runner, 1.0, False, time.perf_counter())
    checks = runner.control(w["limits"])
    assert not all(c.ok for c in checks), checks
