"""run.py without a card, and in a directory that holds only the
benchmark: a non-zero exit and no result."""
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

ARGS = ["--workload", "image-text.sweep", "--seed", str(2 ** 31 + 5),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode != 0
    assert "metrics" not in r.stdout and r.stdout.strip() == ""


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert "metrics" not in r.stdout
