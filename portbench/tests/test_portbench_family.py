"""A configuration's model family is three files found by its name, and a
second family is added by new files and BENCHMARK.json entries alone."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, load, tiny_config, tiny_mix
from portbench import harness

CONFIGS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]]
EXPORTS = {
    "reference": ("Model", "eval_logits", "train_steps", "make_params",
                  "paths_of", "trainable", "to_device", "seeded_dropout"),
    "counts": ("products", "attention_calls"),
    "port": ("model_config", "text", "media"),
}
FOLDERS = {"reference": "reference", "counts": "counts", "port": "models"}


@pytest.mark.parametrize("name", CONFIGS)
def test_a_configuration_resolves_its_family(name):
    cfg = load("configs", name)
    for part, names in EXPORTS.items():
        mod = harness.family(cfg, part)
        assert Path(mod.__file__) == \
            BENCH / FOLDERS[part] / f"{cfg['reference']}.py"
        assert mod.__name__ == \
            f"portbench.{FOLDERS[part]}.{cfg['reference']}"
        assert all(callable(getattr(mod, n)) for n in names), part
        assert harness.family(cfg, part) is mod   # loaded once


# Each of the toy family's files stands in for LanguageBind's and marks
# every call that reaches it.
TOY = '''"""The toy family's {part}: LanguageBind's, each call marked."""
import importlib

BASE = importlib.import_module("portbench.{folder}.languagebind")
CALLS = []


def __getattr__(name):
    value = getattr(BASE, name)
    if not callable(value):
        return value

    def marked(*args, **kwargs):
        CALLS.append(name)
        return value(*args, **kwargs)
    return marked
'''

DRIVE = """
import json, sys, time
sys.path[:0] = [{copy!r}, {root!r}]   # the copy's portbench, the port
import torch
from portbench import harness
bench = json.loads(harness.ROOT.joinpath("BENCHMARK.json").read_text())
out = {{"harness": harness.__file__}}
for cell, trace in (("toy.sweep", True), ("toy.train", False)):
    w, cfg, mix = harness.cell_files(cell)
    r = harness.kind_runner(mix["kind"])(cfg, mix, 2 ** 31 + 77,
                                         torch.device("cpu"))
    ctx = harness.measure(r, 0.3, trace, time.perf_counter())
    checks = r.check(w["limits"])
    metrics = harness.cell_metrics(bench, cell, False)
    if trace:
        metrics += harness.cell_metrics(bench, cell, True)
    out[cell] = harness.result_line(ctx, metrics, checks, {{}}, trace)
out["calls"] = {{p: sorted(set(harness.family(cfg, p).CALLS))
                for p in ("reference", "counts", "port")}}
out["files"] = {{p: harness.family(cfg, p).__file__
                for p in ("reference", "counts", "port")}}
print(json.dumps(out))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_dropped_in_family_does_the_work(tmp_path):
    """In a copy of the benchmark, a family `toy` added by new files and
    BENCHMARK.json entries only: a tiny sweep (traced) and train cell of it
    set up, run a window and check on the CPU through the copy's own
    resolution, and the toy family's files do the work."""
    copy = tmp_path / "portbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)

    cfg = tiny_config("lb-image-text")
    cfg.update(name="toy", reference="toy", compute_dtype="float32")
    files = {
        "configs/toy.json": cfg,
        "traffic/toy-sweep.json": tiny_mix("mvsa-test-sweep"),
        "traffic/toy-train.json": tiny_mix("mvsa-train-b64"),
        "workloads/toy.sweep.json": dict(
            load("workloads", "image-text.sweep"), config="toy",
            traffic="toy-sweep"),
        "workloads/toy.train.json": dict(
            load("workloads", "image-text.train"), config="toy",
            traffic="toy-train"),
    }
    for rel, body in files.items():
        assert not (copy / rel).exists()
        (copy / rel).write_text(json.dumps(body))
    for part, folder in FOLDERS.items():
        assert not (copy / folder / "toy.py").exists()
        (copy / folder / "toy.py").write_text(
            TOY.format(part=part, folder=folder))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    for cell in ("toy.sweep", "toy.train"):
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": f"toy-{cell[4:]}", "chips": 1,
                                   "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for kind in ("sweep", "train"):
            if f"image-text.{kind}" in m.get("workloads", ()):
                m["workloads"].append(f"toy.{kind}")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = subprocess.run(
        [sys.executable, "-c", DRIVE.format(copy=str(tmp_path),
                                            root=str(ROOT))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])

    assert Path(out["harness"]) == copy / "harness.py"
    assert {p: Path(f) for p, f in out["files"].items()} == {
        p: copy / folder / "toy.py" for p, folder in FOLDERS.items()}
    assert out["calls"] == {
        "reference": ["Model", "eval_logits", "make_params", "paths_of",
                      "seeded_dropout", "to_device", "train_steps",
                      "trainable"],
        "counts": ["products"],
        "port": ["media", "model_config", "text"]}
    sweep, train = out["toy.sweep"], out["toy.train"]
    assert sweep["correct"] and train["correct"], (sweep, train)
    assert sweep["metrics"]["sweep_rows_per_s"]["value"] > 0
    assert sweep["metrics"]["mfu.sweep"]["value"] > 0
    assert sweep["metrics"]["padded_rows.sweep"]["value"] == 100 * 1 / 12
    assert train["metrics"]["train_samples_per_s"]["value"] > 0
    assert "idle_by_span" in sweep["breakdown"]
    # nothing the copy had was edited
    after = _digests(copy)
    assert {k: after[k] for k in before} == before
