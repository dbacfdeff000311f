"""The port stands alone: importing it pulls in neither JAX nor the JAX
package and builds nothing, and its entry points run on the card unless the
caller asks for the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.models import finetune
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.train.step import make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import missm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(missm_tpu_torch.__path__,
                                                "missm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from missm_tpu_torch.kernels import build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "missm_tpu" or m.startswith("missm_tpu."))
assert not bad, bad
assert build.load.cache_info().currsize == 0, "a kernel was built on import"
print(len(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # every module was imported


def _cfg():
    return finetune.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16))


@pytest.mark.parametrize("entry", ["init_model_params", "make_eval_step",
                                   "model_forward", "from_jax"])
def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    ids = np.full((2, 16), 98, np.int32)
    data = {"language": ids, "image": np.zeros((2, 3, 32, 32), np.float32)}
    calls = {
        "init_model_params": lambda: finetune.init_model_params(cfg),
        "make_eval_step": lambda: make_eval_step(cfg),
        "model_forward": lambda: finetune.model_forward(
            params, cfg, data, np.zeros(2, np.int32)),
        "from_jax": lambda: from_jax({"w": np.zeros(3, np.float32)}),
    }
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        calls[entry]()
    # the same call on the CPU, asked for, runs
    logits, _ = finetune.model_forward(params, cfg, data,
                                       np.zeros(2, np.int32), device="cpu")
    assert logits.shape == (2, 3) and torch.isfinite(logits).all()
