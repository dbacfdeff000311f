"""The harness is driven by data: cells, configurations and metrics are
files found by name; the trace reader's arithmetic."""
import json
import shutil
from types import SimpleNamespace

import pytest

from conftest import BENCH, ROOT
from portbench import harness, trace


def test_every_cell_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell, cfg, mix = harness.cell_files(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert cfg["name"] == w["config"] and cfg["reduced"] == []
        assert harness.kind_runner(mix["kind"]).kind == mix["kind"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


def test_a_dropped_in_workload_is_listed_and_resolved(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = harness.list_workloads(copy)
    (copy / "workloads" / "image-text.sweep-b32.json").write_text(json.dumps(
        {"config": "lb-image-text", "traffic": "mvsa-test-sweep",
         "limits": {"metric_err": 0, "logit_err": 1, "pred_gap": 1}}))
    assert harness.list_workloads(copy) == sorted(
        before + ["image-text.sweep-b32"])
    cell, cfg, mix = harness.cell_files("image-text.sweep-b32", copy)
    assert cfg["name"] == "lb-image-text" and mix["kind"] == "sweep"
    assert (copy / "traffic" / f"{mix['kind']}.py").exists()


def test_metrics_of_a_cell():
    bench = {"end_to_end": [{"name": "a", "workloads": ["x"]}, {"name": "b"}],
             "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.cell_metrics(bench, "x", False)] == \
        ["a", "b"]
    assert harness.cell_metrics(bench, "x", True) == []


class _Ev:
    def __init__(self, name, start, end, device=False, kind="cpu_op",
                 thread=1):
        self._n, self._s, self._e = name, start, end
        self._d, self._k, self._t = device, kind, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def activity_type(self):
        return self._k

    def start_thread_id(self):
        return self._t


def test_trace_summary():
    evs = [_Ev(trace.WINDOW_SPAN, 0, 1000, kind="user_annotation"),
           _Ev("aten::mm", 10, 100),
           _Ev("cudaLaunchKernel", 20, 30, kind="cuda_runtime"),
           _Ev("cuLaunchKernelEx", 40, 50, kind="cuda_driver"),
           _Ev("cudaStreamSynchronize", 500, 900, kind="cuda_runtime"),
           _Ev("void attention_bf16<64, true>(x)", 100, 300, True, "kernel"),
           _Ev("ampere_gemm", 200, 400, True, "kernel"),
           _Ev("Memcpy HtoD", 600, 700, True, "gpu_memcpy"),
           _Ev("autograd engine", 450, 1000, thread=2)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    s = trace.summarise(prof, 1e-6)
    assert s.busy_s == pytest.approx(400e-9)       # 100-400 and 600-700
    assert s.kernels == 2 and s.attention_kernels == 1
    assert s.attention_s == pytest.approx(200e-9)
    assert s.launches == 2
    # the gap 400-600 is named by the event that started last: the
    # synchronise (500) on the window's thread, not the engine's (450)
    assert s.idle_gaps == {"cudaStreamSynchronize": pytest.approx(200e-9)}
    assert [n for n, _ in trace.top(s.device_ops)] == [
        "void attention_bf16<64, true>(x)", "ampere_gemm", "Memcpy HtoD"]
