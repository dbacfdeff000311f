"""spans.py: the port's spans against arithmetic written out here, on a
synthetic event list and on a rehearsed tiny window on the CPU; and
trace.py's readings unchanged by the spans' events."""
import time

import pytest
import torch

from conftest import tiny_config, tiny_mix
from portbench import harness, spans, trace
from test_portbench_layout import _Ev

NS = 1e-9


def _events():
    """Thread 1: a point [0, 1000] holding a wait [0, 100], a step
    [100, 600] (an upload [100, 200] inside it) and a readback [600, 900],
    then a second wait [1000, 1050]; thread 2: a cast [520, 560]. Device
    operations 50-80, 150-500, 650-700, 950-990, 1100-1200, so the idle
    gaps are 80-150, 500-650, 700-950 and 990-1100."""
    host = [("missm.eval.point", 0, 1000), ("missm.eval.wait", 0, 100),
            ("missm.eval.step", 100, 600), ("missm.model.upload", 100, 200),
            ("missm.eval.readback", 600, 900),
            ("missm.eval.wait", 1000, 1050)]
    evs = [_Ev(n, s, e, kind="user_annotation") for n, s, e in host]
    evs += [_Ev("missm.model.cast", 520, 560, kind="user_annotation",
                thread=2),
            _Ev(trace.WINDOW_SPAN, 0, 1200, kind="user_annotation"),
            _Ev("aten::mm", 110, 190),
            _Ev("cudaLaunchKernel", 120, 130, kind="cuda_runtime")]
    evs += [_Ev(n, s, e, True, k) for n, s, e, k in (
        ("gemm", 50, 80, "kernel"),
        ("void attention_bf16<64, true>(x)", 150, 500, "kernel"),
        ("Memcpy HtoD", 650, 700, "gpu_memcpy"),
        ("gemm", 950, 990, "kernel"), ("Memset", 1100, 1200, "gpu_memset"))]
    # the device-side ranges the profiler adds for host ranges
    evs += [_Ev("missm.eval.step", 150, 500, True, "gpu_user_annotation"),
            _Ev(trace.WINDOW_SPAN, 50, 1200, True, "gpu_user_annotation")]
    return evs


def test_span_times_and_idle_by_span():
    times, by_span = spans.summarise(_events())
    got = {n: (t.calls, t.inclusive_s / NS, t.self_s / NS, t.idle_s / NS)
           for n, t in times.items()}
    want = {
        # calls, inclusive, self (less its children on its thread), idle
        "missm.eval.point": (1, 1000, 1000 - 100 - 500 - 300,
                             70 + 150 + 250 + 10),
        "missm.eval.wait": (2, 100 + 50, 100 + 50, 20 + 50),
        "missm.eval.step": (1, 500, 500 - 100, 50 + 100),
        "missm.model.upload": (1, 100, 100, 50),
        "missm.eval.readback": (1, 300, 300, 50 + 200),
        "missm.model.cast": (1, 40, 40, 40),
    }
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name] == pytest.approx(w), name
    # each gap's time under the span under way that started last, on any
    # thread: 80-100 the wait (it ends before the point that started with
    # it), 100-150 the upload, 500-520 and 560-600 the step, 520-560 the
    # other thread's cast, 600-650 and 700-900 the readback, 900-950 and
    # 990-1000 the point, 1000-1050 the second wait, 1050-1100 none
    want_by = {"missm.eval.wait": 20 + 50, "missm.model.upload": 50,
               "missm.eval.step": 20 + 40, "missm.model.cast": 40,
               "missm.eval.readback": 50 + 200,
               "missm.eval.point": 50 + 10, spans.NO_SPAN: 50}
    assert {k: v / NS for k, v in by_span.items()} == pytest.approx(want_by)
    assert sum(by_span.values()) / NS == pytest.approx(70 + 150 + 250 + 110)


def test_readings_of_a_batch():
    times, _ = spans.summarise(_events())
    got = spans.readings("sweep", times,
                         {"eval.rows": 128, "eval.padded_rows": 8}, 2)
    assert got == pytest.approx({
        "eval_host_ms_per_batch.sweep": 1e3 * 100 * NS / 2,
        "input_wait_ms_per_batch.sweep": 1e3 * 150 * NS / 2,
        "padded_rows.sweep": 100 * 8 / 128,
        "upload_ms_per_batch.sweep": 1e3 * 100 * NS / 2,
        "cast_ms_per_batch.sweep": 1e3 * 40 * NS / 2})
    # no counters, no backward or optimizer span: nothing to read
    assert spans.readings("sweep", times, {}, 2)["padded_rows.sweep"] is None
    train = spans.readings("train", times, {}, 2)
    assert train["backward_ms_per_step.train"] is None
    assert train["optimizer_ms_per_step.train"] is None
    assert spans.readings("train", {}, {}, 0) == dict.fromkeys(train)


def test_the_spans_leave_the_trace_readings_as_they_were():
    """trace.summarise reads the same device time, kernels, attention and
    launches with and without the port's spans (and the device-side ranges
    the profiler adds for them)."""
    def summary(evs):
        s = trace.summarise(_prof(evs), 1200 * NS)
        return (s.busy_s, s.device_ops, s.attention_s, s.attention_kernels,
                s.kernels, s.launches, s.launch_names)

    evs = _events()
    bare = [e for e in evs if not e.name().startswith("missm.")]
    assert summary(evs) == summary(bare)
    assert summary(evs)[0] == pytest.approx((30 + 350 + 50 + 40 + 100) * NS)


def _prof(evs):
    from types import SimpleNamespace
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


@pytest.mark.parametrize("cell, mix, want", [
    ("lb-image-text", "mvsa-test-sweep",
     {"missm.eval.point", "missm.eval.wait", "missm.eval.step",
      "missm.eval.readback"}),
    ("lb-video-audio-text", "sims-train-b16",
     {"missm.train.step", "missm.train.forward", "missm.train.backward",
      "missm.train.optimizer"}),
])
def test_a_rehearsed_window(cell, mix, want):
    """A tiny cell's window traced on the CPU as the harness traces it:
    the layer's spans and the model's, and every reading of the cell's
    kind."""
    mix = tiny_mix(mix)
    r = harness.kind_runner(mix["kind"])(tiny_config(cell), mix, 5,
                                         torch.device("cpu"))
    harness.measure(r, 0.1, False, time.perf_counter())
    window = spans.trace_window(r, 0.2)
    units, counts = window[0], window[4]
    times, by_span = spans.summarise(window[2])
    model = {"missm.model.upload", "missm.model.cast", "missm.model.fusion",
             "missm.model.tower.language"}
    assert want | model <= set(times)
    got = spans.readings(r.kind, times, counts, units)
    assert got and all(v is not None and v >= 0 for v in got.values())
    if r.kind == "sweep":
        # 11 rows at B = 4: 12 rows run a point, 1 of them padding
        assert got["padded_rows.sweep"] == 100 * 1 / 12
        assert counts["eval.rows"] == 12 * units // 3
    assert by_span == {}            # no device: no idle gap
    out = spans.report(r.kind, *window)
    assert out["readings"] == got and out["idle_under_a_span_pct"] is None
    assert out["spans_ms_per_unit"].keys() == times.keys()


SPAN_METRICS = {
    "sweep": ["eval_host_ms_per_batch.sweep", "input_wait_ms_per_batch.sweep",
              "padded_rows.sweep", "upload_ms_per_batch.sweep",
              "cast_ms_per_batch.sweep"],
    "train": ["upload_ms_per_step.train", "cast_ms_per_step.train",
              "backward_ms_per_step.train", "optimizer_ms_per_step.train"],
}


@pytest.mark.parametrize("cell, mix", [
    ("lb-image-text", "mvsa-test-sweep"),
    ("lb-video-audio-text", "sims-train-b16"),
])
def test_the_harness_keeps_the_spans_and_counters(cell, mix):
    """A rehearsed --trace 1 measure on the CPU: its Context holds the spans
    and counters that spans.trace_window gives a window, each span metric
    reads spans.readings of them, and the breakdown carries idle_by_span."""
    mix = tiny_mix(mix)
    r = harness.kind_runner(mix["kind"])(tiny_config(cell), mix, 5,
                                         torch.device("cpu"))
    ctx = harness.measure(r, 0.1, True, time.perf_counter())
    times, by_span = ctx.spans
    window = spans.trace_window(r, 0.2)
    assert set(times) == set(spans.summarise(window[2])[0])
    assert set(ctx.counters) == set(window[4])

    want = spans.readings(r.kind, times, ctx.counters, ctx.units)
    got = {n: harness.reader(n)(ctx) for n in SPAN_METRICS[r.kind]}
    assert got == want and all(v is not None for v in got.values())
    if r.kind == "sweep":
        assert got["padded_rows.sweep"] == 100 * 1 / 12
        theirs = spans.readings(r.kind, spans.summarise(window[2])[0],
                                window[4], window[0])
        assert theirs["padded_rows.sweep"] == got["padded_rows.sweep"]
    line = harness.result_line(ctx, [], [], {}, True)
    assert line["breakdown"]["idle_by_span"] == trace.top(by_span)


@pytest.mark.parametrize("kind", ["sweep", "train"])
def test_span_metrics_read_nothing_untraced(kind):
    """On an untraced run, and on a traced run of the other kind, each of
    the nine span metrics reads None."""
    bare = harness.Context(kind=kind, cfg={}, batch=4, setup_s=1.0, work=8,
                           seconds=1.0, peak_bytes=0)
    times, _ = spans.summarise(_events())
    other = harness.Context(kind="train" if kind == "sweep" else "sweep",
                            cfg={}, batch=4, setup_s=1.0, work=8, seconds=1.0,
                            peak_bytes=0, units=2, spans=(times, {}),
                            counters={"eval.rows": 8})
    for name in SPAN_METRICS["sweep"] + SPAN_METRICS["train"]:
        assert harness.reader(name)(bare) is None, name
    for name in SPAN_METRICS[kind]:
        assert harness.reader(name)(other) is None, name
