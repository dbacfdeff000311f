"""The port's spans in a traced window.

The port marks its layer boundaries with `missm.*` ranges
(missm_tpu_torch/utils/profiling.py::span) while a profiler records, so they
lie in the kineto trace beside the card's operations, on the same clock.
From the events of one `torch.profiler.profile` this takes every `missm.*`
host event (name, thread, start, end) and gives, for each span name:
- calls: its events;
- inclusive_s: the union of its intervals;
- self_s: the part of that in which it is the innermost `missm.*` span of
  its thread (the one under way that started last);
- idle_s: the device-idle seconds inside its intervals, the idle intervals
  being trace.py's gaps between the union of the device operations;
and `idle_by_span`: each idle gap's seconds under the innermost `missm.*`
span under way on any thread, or under NO_SPAN where none is.

`readings` turns those into the per-layer numbers of a batch or a step.

Run from the root of a checkout on a machine with a CUDA card,

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

sets the cell up as run.py does, runs an untraced window of --seconds, then
traces a window of harness.TRACE_SECONDS as the harness's --trace 1 run
does, with the port's counters read before and after it, and prints one
JSON line: the traced window's units, seconds and launches, every span's
milliseconds a unit, the counters' change, the readings and idle_by_span.
The harness keeps the same spans, counters and idle_by_span in a --trace 1
run (harness.measure), and its span metrics (metrics/*.py) are `readings`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import asdict, dataclass

from . import trace
from .trace import DEVICE_KINDS, _device_kind, _gaps, top

PREFIX = "missm."
NO_SPAN = "no program span"


@dataclass(frozen=True)
class Span:
    name: str
    thread: int
    start: int          # ns, the profiler's clock
    end: int


@dataclass
class SpanTime:
    calls: int = 0
    inclusive_s: float = 0.0
    self_s: float = 0.0
    idle_s: float = 0.0


def _on_device(e):
    return str(e.device_type()).endswith("CUDA")


def spans_of(events):
    """The `missm.*` host events of `events` as Spans."""
    return [Span(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
            for e in events
            if not _on_device(e) and e.name().startswith(PREFIX)]


def device_intervals(events):
    """(start, end) in ns of every device operation (kernel, copy, set),
    as trace.summarise takes them."""
    hosts = {e.name() for e in events if not _on_device(e)}
    return [(e.start_ns(), e.end_ns()) for e in events
            if _on_device(e) and _device_kind(e, hosts) in DEVICE_KINDS]


def _innermost(active):
    """The span of `active` that started last (of two that started
    together, the one that ends first)."""
    return max(active, key=lambda s: (s.start, -s.end))


def analyse(spans, gaps):
    """({name: SpanTime}, {name: idle seconds}) of `spans` against the idle
    `gaps` ((start, end) in ns, disjoint)."""
    times = {}
    for s in spans:
        times.setdefault(s.name, SpanTime()).calls += 1
    by_span = {}
    marks = [(s.start, 1, s) for s in spans] + [(s.end, -1, s) for s in spans]
    marks += [(g[0], 2, None) for g in gaps] + [(g[1], -2, None)
                                                for g in gaps]
    marks.sort(key=lambda m: m[0])
    active, idle, prev = set(), 0, None
    for t, kind, s in marks:
        if prev is not None and t > prev:
            dt = (t - prev) * 1e-9
            for name in {a.name for a in active}:
                times[name].inclusive_s += dt
                if idle:
                    times[name].idle_s += dt
            for thread in {a.thread for a in active}:
                inner = _innermost([a for a in active if a.thread == thread])
                times[inner.name].self_s += dt
            if idle:
                name = _innermost(active).name if active else NO_SPAN
                by_span[name] = by_span.get(name, 0.0) + dt
        if kind == 1:
            active.add(s)
        elif kind == -1:
            active.discard(s)
        else:
            idle += kind // 2
        prev = t
    return times, by_span


def summarise(events):
    """analyse() of the `missm.*` spans of kineto `events` against their
    device-idle gaps."""
    return analyse(spans_of(events), _gaps(device_intervals(events)))


def _ms(times, name, units, part="inclusive_s"):
    t = times.get(name)
    return None if t is None or not units else 1e3 * getattr(t, part) / units


def _share(counts, part, whole):
    if not counts.get(whole):
        return None
    return 100.0 * counts.get(part, 0) / counts[whole]


def readings(kind, times, counts, units):
    """The per-layer numbers of a sweep's batch or a training step, by
    name; None where the trace or the counters hold nothing for one.
    `counts` is the counters' change over the window."""
    if kind == "sweep":
        return {
            "eval_host_ms_per_batch.sweep": _ms(times, "missm.eval.point",
                                                units, "self_s"),
            "input_wait_ms_per_batch.sweep": _ms(times, "missm.eval.wait",
                                                 units),
            "padded_rows.sweep": _share(counts, "eval.padded_rows",
                                        "eval.rows"),
            "upload_ms_per_batch.sweep": _ms(times, "missm.model.upload",
                                             units),
            "cast_ms_per_batch.sweep": _ms(times, "missm.model.cast", units),
        }
    return {
        "upload_ms_per_step.train": _ms(times, "missm.model.upload", units),
        "cast_ms_per_step.train": _ms(times, "missm.model.cast", units),
        "backward_ms_per_step.train": _ms(times, "missm.train.backward",
                                          units),
        "optimizer_ms_per_step.train": _ms(times, "missm.train.optimizer",
                                           units),
    }


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()}


def trace_window(runner, seconds):
    """One window of `runner` traced as the harness's --trace 1 run traces
    it, the port's counters read before and after: (units, seconds, kineto
    events, trace.Summary, the counters' change)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .port import counters
    acts = [ProfilerActivity.CPU]
    if runner.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = counters()
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            _, units, window_s = runner.window(seconds, record=False)
    counts = _delta(before, counters())
    return (units, window_s, prof.profiler.kineto_results.events(),
            trace.summarise(prof, window_s), counts)


def report(kind, units, window_s, events, summary, counts):
    """The command's numbers of one traced window (trace_window's)."""
    times, by_span = summarise(events)
    gaps_s = sum(by_span.values())
    return {
        "units": units, "window_s": window_s, "units_per_s": units / window_s,
        "launches_per_unit": summary.launches / units,
        "device_idle_pct": 100.0 * (1.0 - summary.busy_s / window_s),
        "readings": readings(kind, times, counts, units),
        "counters": counts,
        "spans_ms_per_unit": {
            name: {k: (v if k == "calls" else 1e3 * v / units)
                   for k, v in asdict(t).items()}
            for name, t in sorted(times.items())},
        "idle_gaps_s": gaps_s,
        "idle_under_a_span_pct": (100.0 * (1.0 - by_span.get(NO_SPAN, 0.0)
                                           / gaps_s) if gaps_s else None),
        "idle_by_span": top(by_span, n=20),
        "idle_gaps": top(summary.idle_gaps, n=20),
    }


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description="the port's spans in a cell's "
                                "traced window")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from .run import _card_line, _environment
    _environment()
    _card_line()

    import torch

    from . import harness
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    _, cfg, mix = harness.cell_files(args.workload)
    runner = harness.kind_runner(mix["kind"])(cfg, mix, args.seed,
                                              torch.device("cuda", 0))
    runner.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    runner.window(args.seconds, record=False)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), "setup_s": setup_s}
    out.update(report(runner.kind, *trace_window(runner,
                                                 harness.TRACE_SECONDS)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
