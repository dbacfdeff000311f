"""The port's spans and counters (utils/profiling.py: span, count,
counters), on a tiny image+text model with the `sum` head, f32 on the CPU.

- with no profiler recording, `span` is one shared null context;
- under torch.profiler, a sweep point (eval/sweep.py) and a train step
  (train/step.py, one pass and two microbatches) record the layer spans,
  each nested where the port's layers nest;
- the spans add no op: the profile's other events, counted by name, are
  the same with `span` stubbed to a null context;
- `eval.rows` and `eval.padded_rows` count the padded batches and their
  rows that count for nothing, with and without `shard_real_count`.
"""
import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.eval import sweep
from missm_tpu_torch.models import encoder, finetune
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train import step as tstep
from missm_tpu_torch.utils import count, counters, span

CFG = finetune.ModelConfig(
    towers=(("image", tiny_tower("image")),),
    fusion=FusionConfig(fusion_type="sum",
                        modality_types=("language", "image"), output_dims=3,
                        feature_dims=24, fusion_dim=8))
MODEL_SPANS = ("missm.model.upload", "missm.model.cast",
               "missm.model.tower.language", "missm.model.tower.image",
               "missm.model.fusion")
SPANNING = (sweep, finetune, encoder, tstep)   # the modules that call span


class ListLoader:
    def __init__(self, n, batch_size, seed=0):
        rng = np.random.default_rng(seed)
        ids = rng.integers(1, 98, size=(n, 16)).astype(np.int32)
        ids[:, -1] = 98
        self.data = {"language": ids,
                     "image": rng.standard_normal((n, 3, 32, 32)).astype(
                         np.float32)}
        self.labels = rng.integers(0, 3, size=n).astype(np.int32)
        self.missing = rng.choice(np.array([0, 1, 4], np.int32), n)
        self.batch_size = batch_size

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            sl = slice(i, i + self.batch_size)
            yield ({k: v[sl] for k, v in self.data.items()},
                   self.labels[sl], self.missing[sl])


@pytest.fixture(scope="module")
def params():
    return finetune.init_model_params(CFG, seed=0, device="cpu")


def _sweep_point(params, tmp_path, n=10, batch=4):
    step = tstep.make_eval_step(CFG, device="cpu")
    sweep.run_missing_sweep(params, CFG, step,
                            {"language": {0.5: ListLoader(n, batch)}},
                            str(tmp_path), "mvsa", "sum", verbose=False,
                            device="cpu")


def _train_steps(params, A, steps=1):
    state, tx = tstep.init_train_state(params, CFG)
    fn = tstep.make_train_step(CFG, tx, accum_steps=A, device="cpu")
    gen = torch.Generator().manual_seed(0)
    data, labels, missing = next(iter(ListLoader(4, 4)))
    for _ in range(steps):
        state, _ = fn(state, data, labels, missing, 1e-3, gen)


def _profiled(run):
    """(start, end, thread, name) of every event of a CPU profile of
    `run()`."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
            for e in prof.profiler.kineto_results.events()]


def _spans(events, name):
    return [e for e in events if e[3] == name]


def _inside(child, parents):
    """Whether `child` lies within one of `parents` on its thread."""
    return any(p[2] == child[2] and p[0] <= child[0] and child[1] <= p[1]
               for p in parents)


def _assert_nested(events, child, parent, n):
    kids = _spans(events, child)
    assert len(kids) == n, (child, len(kids))
    assert all(_inside(k, _spans(events, parent)) for k in kids), child


def test_span_without_a_profiler_is_one_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span("missm.x"), span("missm.y")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a as entered:
        assert entered is None
    before = counters().get("test.spans", 0)
    count("test.spans", 2)
    count("test.spans")
    counters()["test.spans"] = -1       # a snapshot is a copy
    assert counters()["test.spans"] == before + 3


def test_sweep_point_records_the_eval_and_model_spans(params, tmp_path):
    _sweep_point(params, tmp_path)                  # warm
    ev = _profiled(lambda: _sweep_point(params, tmp_path))
    assert len(_spans(ev, "missm.eval.point")) == 1
    # 10 rows at B = 4: three batches, and a fourth wait that ends the
    # loader
    _assert_nested(ev, "missm.eval.wait", "missm.eval.point", 4)
    _assert_nested(ev, "missm.eval.step", "missm.eval.point", 3)
    _assert_nested(ev, "missm.eval.readback", "missm.eval.point", 3)
    for name in MODEL_SPANS:
        _assert_nested(ev, name, "missm.eval.step", 3)
    assert not [e for e in ev if e[3].startswith("missm.train.")]


@pytest.mark.parametrize("A", [1, 2])
def test_train_step_records_the_train_and_model_spans(params, A):
    _train_steps(params, A)                         # warm
    ev = _profiled(lambda: _train_steps(params, A))
    assert len(_spans(ev, "missm.train.step")) == 1
    _assert_nested(ev, "missm.train.forward", "missm.train.step", A)
    _assert_nested(ev, "missm.train.backward", "missm.train.step", A)
    _assert_nested(ev, "missm.train.optimizer", "missm.train.step", 1)
    for name in MODEL_SPANS:
        _assert_nested(ev, name, "missm.train.forward", A)
    # the backward's ops run inside its span, the optimizer's inside its own
    for child, parent in (("autograd::engine::evaluate_function",
                           "missm.train.backward"),
                          ("Optimizer.step", "missm.train.optimizer")):
        found = [e for e in ev if e[3].startswith(child)]
        assert found and all(_inside(e, _spans(ev, parent)) for e in found)


@pytest.mark.parametrize("kind", ["sweep", "train"])
def test_spans_add_no_op(params, tmp_path, monkeypatch, kind):
    def run():
        if kind == "sweep":
            _sweep_point(params, tmp_path)
        else:
            _train_steps(params, 2)

    def others(events):
        return collections.Counter(e[3] for e in events
                                   if not e[3].startswith("missm."))

    run()                                            # warm
    with_spans = _profiled(run)
    assert any(e[3].startswith("missm.") for e in with_spans)
    null = contextlib.nullcontext()
    for mod in SPANNING:
        monkeypatch.setattr(mod, "span", lambda name: null)
    without = _profiled(run)
    assert not any(e[3].startswith("missm.") for e in without)
    assert others(with_spans) == others(without)


class ShardLoader(ListLoader):
    def __init__(self, n, batch_size, real):
        super().__init__(n, batch_size)
        self.shard_real_count = real


@pytest.mark.parametrize("loader, rows, padded", [
    # 480 rows at B = 64: 7 full batches and one of 32 rows padded to 64
    (ListLoader(480, 64), 512, 32),
    # 457 rows at B = 64: the last batch holds 9
    (ListLoader(457, 64), 512, 55),
    # a shard of 6 rows at B = 4 whose last real row is its 5th: the
    # second batch holds 1 real row, 1 duplicate and 2 padded
    (ShardLoader(6, 4, real=5), 8, 3),
    # ... whose 4th is: the second batch is duplicates only
    (ShardLoader(6, 4, real=4), 8, 4),
])
def test_eval_counters_count_rows_and_padding(params, loader, rows, padded):
    step = tstep.make_eval_step(CFG, device="cpu")
    before = counters()
    sweep.evaluate_loader(params, step, loader)
    after = counters()
    assert after["eval.rows"] - before.get("eval.rows", 0) == rows
    assert (after["eval.padded_rows"] - before.get("eval.padded_rows", 0)
            == padded)
