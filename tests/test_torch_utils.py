"""The port's utilities against the JAX package's: utils/profiling.py
(StepTimer, trace), core/prng.py (PRNGSeq) and core/cache.py
(enable_compilation_cache).

- StepTimer.summary() equals missm_tpu.utils.profiling.StepTimer's on the
  same fed times (time.perf_counter patched for both);
- PRNGSeq's discipline, not its bits (a torch.Generator cannot draw
  JAX's): one seed gives one sequence of generators; successive
  generators and the n of one split draw differently; split(n) advances
  the root as next() does;
- enable_compilation_cache: its path, $MISSM_TORCH_CACHE, the unchanged
  default, and a directory that cannot be created raises;
- trace(..., device="cpu") writes a Chrome trace.
"""
import json
import time

import numpy as np
import pytest
import torch

from missm_tpu.utils import profiling as jprof
from missm_tpu_torch.core import PRNGSeq
from missm_tpu_torch.core.cache import enable_compilation_cache
from missm_tpu_torch.kernels import build
from missm_tpu_torch.utils import StepTimer, trace


def _drive(timer_cls, monkeypatch, ticks):
    clock = iter(ticks)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = timer_cls()
    for _ in range(4):
        t.input_start()
        t.input_end()
        t.step_end()
    t.input_end()  # an input that no step followed
    return t


def test_step_timer_summary_equals_jax(monkeypatch):
    # 4 clock reads a step, 2 for the last input
    ticks = np.cumsum(np.random.default_rng(0).exponential(0.05, 18)
                      ).tolist()
    got = _drive(StepTimer, monkeypatch, ticks)
    want = _drive(jprof.StepTimer, monkeypatch, ticks)
    assert got.step_times == want.step_times
    assert got.input_times == want.input_times
    assert got.duty_cycle == want.duty_cycle
    assert got.summary() == want.summary()
    assert set(got.summary()) == {"steps", "step_ms_mean", "step_ms_p50",
                                  "input_ms_mean", "duty_cycle"}
    assert StepTimer().summary() == jprof.StepTimer().summary()


def _draws(gens):
    return [torch.randint(0, 2 ** 31, (8,), generator=g).tolist()
            for g in gens]


def test_prng_seq_discipline():
    a, b = PRNGSeq(7, device="cpu"), PRNGSeq(7, device="cpu")
    first = _draws([a.next(), a.next()] + a.split(3))
    assert first == _draws([b.next(), b.next()] + b.split(3))
    # every generator draws its own stream
    assert len({tuple(d) for d in first}) == len(first)
    assert _draws([PRNGSeq(8, device="cpu").next()])[0] != first[0]
    # split(n) advances the root once, as next() does
    c, d = PRNGSeq(3, device="cpu"), PRNGSeq(3, device="cpu")
    c.split(4)
    d.next()
    assert _draws([c.next()]) == _draws([d.next()])
    # a generator as the root: the same generator state, the same sequence
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    assert (_draws(PRNGSeq(g1, device="cpu").split(2))
            == _draws(PRNGSeq(g2, device="cpu").split(2)))
    assert all(g.device.type == "cpu" for g in a.split(2))


def test_enable_compilation_cache(monkeypatch, tmp_path):
    default = build.BUILD_DIR
    monkeypatch.setattr(build, "BUILD_DIR", default)
    monkeypatch.delenv("MISSM_TORCH_CACHE", raising=False)
    # neither given: the default stays, and nothing is created
    assert enable_compilation_cache() == default == build.BUILD_DIR
    assert default == build.PACKAGE_DIR.parent / "build" / "missm_tpu_torch"
    # the path argument
    there = tmp_path / "a" / "kernels"
    assert enable_compilation_cache(str(there)) == there
    assert build.BUILD_DIR == there and there.is_dir()
    assert build._library_path("attention").parent == there
    # the environment variable
    env = tmp_path / "env"
    monkeypatch.setenv("MISSM_TORCH_CACHE", str(env))
    assert enable_compilation_cache() == env and env.is_dir()
    # a directory that cannot be created raises
    (tmp_path / "file").write_text("x")
    with pytest.raises(OSError):
        enable_compilation_cache(str(tmp_path / "file" / "sub"))


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
