"""What the harness loads: a rehearsal of a run (a tiny cell on the CPU)
loads no module whose top-level name is jax, jaxlib, flax or missm_tpu,
compared whole; a model family's plain reference and counts load nothing of
missm_tpu_torch. Each runs in a fresh interpreter."""
import json
import subprocess
import sys

from conftest import HERE, ROOT

REHEARSE = """
import json, sys, time
sys.path[:0] = [{root!r}, {tests!r}]
import torch
from conftest import tiny_config, tiny_mix
from portbench import harness
for cell, mix in (("lb-image-text", "mvsa-test-sweep"),
                  ("lb-video-audio-text", "sims-train-b16")):
    cfg = tiny_config(cell)
    r = harness.kind_runner(tiny_mix(mix)["kind"])(
        cfg, tiny_mix(mix), 5, torch.device("cpu"))
    harness.measure(r, 0.2, True, time.perf_counter())
    r.check(json.loads(json.dumps({{"metric_err": 1, "logit_err": 1,
        "pred_gap": 1, "loss_err": 1, "grad_err": 1, "change_err": 1,
        "frozen_err": 1}})))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
import torch
from conftest import tiny_config
from portbench import harness
cfg = tiny_config("lb-video-audio-text")
ref = harness.family(cfg, "reference")
harness.family(cfg, "counts").attention_calls(cfg, 2, True)
params = ref.make_params(cfg, 1, "cpu")
data = {{"language": torch.full((2, 16), 98), "video": torch.randn(2, 3, 4, 32, 32),
        "audio": torch.randn(2, 3, 32, 48)}}
ref.eval_logits(ref.Model(cfg), params, data, torch.tensor([0, 2]), 1)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), tests=str(HERE))], capture_output=True, text=True,
        timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_rehearsed_run_loads_no_jax():
    loaded = _modules(REHEARSE)
    assert "missm_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "missm_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules(REFERENCE)
    assert "portbench" in loaded
    assert not loaded & {"missm_tpu_torch", "missm_tpu", "jax", "jaxlib"}
