"""One run of one cell: resolve the cell's files by name, set up, measure
the window, trace a second window where asked, check the outputs, print the
result line.

Everything that belongs to one configuration, traffic mix, cell, metric or
model family is a file found by its name:
- configs/<config>.json: the sizes, source, assumed and reduced keys, and
  under "reference" the name of its model family;
- a model family <family>: three modules (`family`):
  reference/<family>.py, the plain reference and the seeded weights' maker
  and layout; counts/<family>.py, the family's matrix products and
  attention calls; models/<family>.py, the port's model config of a
  configuration and the input makers;
- traffic/<mix>.json: the mix's parameters; its "kind" names the code that
  generates and drives it (traffic/<kind>.py);
- workloads/<cell>.json: the cell's configuration and mix, and the limit of
  each number its check compares;
- metrics/<metric>.py: `read(ctx)`, the metric's value for this run, or
  None where the run has nothing for it to read.
BENCHMARK.json, at the checkout's root, says which metrics a cell reports.
Of what a run loads, only port.py, models/<family>.py and the traffic kinds
import the port.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SECONDS = 5.0     # the traced window of a --trace 1 run, at least
FORBIDDEN = ("jax", "jaxlib", "flax", "missm_tpu")


@dataclass
class Context:
    """What a metric reader reads: the run's kind and sizes, the untraced
    window's work and seconds, and with --trace 1 the traced window's units,
    trace summary (trace.Summary), the port's spans in it (spans.summarise:
    ({span: spans.SpanTime}, {span: idle seconds})) and the change of the
    port's counters over it ({counter: int})."""
    kind: str
    cfg: dict
    batch: int
    setup_s: float
    work: float
    seconds: float
    peak_bytes: int
    units: int = 0
    trace: object = None
    spans: tuple = None
    counters: dict = None


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_files(name: str, root: Path = HERE):
    """(workload, configuration, mix) dicts of cell `name`."""
    cell = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{cell['config']}.json")
    mix = load_json(root / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def list_workloads(root: Path = HERE):
    """The cells that workloads/ holds, by name."""
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FAMILY_FOLDERS = {"reference": "reference", "counts": "counts",
                  "port": "models"}


def family(cfg: dict, part: str):
    """Module `part` ("reference", "counts" or "port") of the model family
    that configuration `cfg` names: portbench.<folder>.<family>."""
    return importlib.import_module(
        f"portbench.{FAMILY_FOLDERS[part]}.{cfg['reference']}")


def kind_runner(kind: str):
    """The Runner class of traffic/<kind>.py."""
    return importlib.import_module(f"portbench.traffic.{kind}").Runner


def reader(metric: str):
    """`read` of metrics/<metric>.py."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   f"portbench_metric_{metric.replace('.', '_')}").read


def cell_metrics(bench: dict, cell: str, trace: bool):
    """The metrics (BENCHMARK.json entries) a cell reports: its end-to-end
    metrics, or with --trace 1 its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def measure(runner, seconds: float, trace: bool, t0: float):
    """Set-up, the window and, with `trace`, a traced window; the Context."""
    import torch

    runner.setup()
    cuda = runner.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    work, _, elapsed = runner.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = Context(kind=runner.kind, cfg=runner.cfg, batch=runner.batch,
                  setup_s=setup_s, work=work, seconds=elapsed,
                  peak_bytes=peak)
    if trace:
        from . import spans
        ctx.units, _, events, ctx.trace, ctx.counters = spans.trace_window(
            runner, TRACE_SECONDS)
        ctx.spans = spans.summarise(events)
    return ctx


def result_line(ctx, metrics, checks, device_info, trace):
    from .trace import top
    values = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = all(c.ok for c in checks)
    out = {"correct": correct, "attempted": int(ctx.work), "failed": 0,
           "metrics": values, "device": device_info}
    if trace:
        out["device"] = dict(device_info, busy_s=ctx.trace.busy_s,
                             window_s=ctx.trace.window_s)
        out["breakdown"] = {"device_ops": top(ctx.trace.device_ops),
                            "idle_gaps": top(ctx.trace.idle_gaps),
                            "idle_by_span": top(ctx.spans[1])}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out


def run(args, t0: float) -> int:
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell, cfg, mix = cell_files(args.workload)
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        print(f"workloads/{args.workload}.json disagrees with BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    runner = kind_runner(mix["kind"])(cfg, mix, args.seed, device)
    ctx = measure(runner, args.seconds, args.trace, t0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": entry["chips"], "memory_peak_bytes": ctx.peak_bytes}
    checks = runner.check(cell["limits"])
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the run must not load: {found}",
              file=sys.stderr)
        return 4
    line = result_line(ctx, cell_metrics(bench, args.workload, args.trace),
                       checks, info, args.trace)
    print(f"setup_s {ctx.setup_s!r}, {ctx.work} done in {ctx.seconds!r} s",
          file=sys.stderr)
    if ctx.trace is not None:
        t = ctx.trace
        print(f"traced: {ctx.units} units in {t.window_s!r} s, {t.kernels} "
              f"kernels, {t.attention_kernels} attention kernels, launch "
              f"calls {t.launch_names}, counters {ctx.counters}",
              file=sys.stderr)
    for c in checks:
        if c.note:
            print(f"{c.name}: {c.note}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
