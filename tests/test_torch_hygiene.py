"""The port stands alone: importing it pulls in neither JAX nor the JAX
package and builds nothing, needs neither pandas nor PIL (nor PyYAML,
safetensors or tensorboard) to import,
chip_smoke.py imports neither JAX nor the JAX package, and its entry
points (export, the serving artifact's loader and cli.export among them)
run on the card unless the caller asks for the CPU, the media loaders'
samples included."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from missm_tpu_torch.cli.export import main as export_main
from missm_tpu_torch.cli.common import maybe_init_distributed
from missm_tpu_torch.compat.args import train_args
from missm_tpu_torch.parallel.dryrun import dryrun
from missm_tpu_torch.compat.from_jax import from_jax
from missm_tpu_torch.core import PRNGSeq
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.data.preprocess import make_media_loaders
from missm_tpu_torch.eval.artifact import export_artifact, load_artifact
from missm_tpu_torch.models import finetune
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.ops.image_transforms import image_transform
from missm_tpu_torch.ops.melfbank import FbankConfig, audio_model_input
from missm_tpu_torch.train.step import (init_train_state, make_eval_step,
                                        make_train_step)
from missm_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import missm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(missm_tpu_torch.__path__,
                                                "missm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"missm_tpu_torch.utils.profiling", "missm_tpu_torch.core.prng",
        "missm_tpu_torch.core.cache"} <= set(names)
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
    assert int(proc.stdout.strip()) >= 17  # every module was imported


_IMPORT_WITHOUT = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "PIL", "yaml", "safetensors",
                                  "tensorboard"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import missm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(missm_tpu_torch.__path__,
                                                "missm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "missm_tpu_torch.data.loaders" in sys.modules
assert "missm_tpu_torch.cli.train" in sys.modules
print(len(names))
"""


def test_port_imports_without_pandas_or_pil():
    """The data layer imports pandas and PIL inside the functions that
    read a CSV or decode an image, and the entry points PyYAML,
    safetensors and tensorboard inside the functions that read a config,
    load a safetensors checkpoint or open a writer, never at import
    time."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_WITHOUT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 17


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "missm_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "missm_tpu"}, sorted(names)


def _cfg():
    return finetune.ModelConfig(
        towers=(("image", tiny_tower("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=3, feature_dims=24, fusion_dim=16))


@pytest.mark.parametrize("entry", ["init_model_params", "make_eval_step",
                                   "make_train_step", "model_forward",
                                   "from_jax", "make_media_loaders",
                                   "image_transform", "audio_model_input",
                                   "export_artifact", "load_artifact",
                                   "cli.export", "parallel.dryrun",
                                   "maybe_init_distributed", "trace",
                                   "PRNGSeq"])
def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                tmp_path,
                                                                entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    params = finetune.init_model_params(cfg, seed=0, device="cpu")
    ids = np.full((2, 16), 98, np.int32)
    data = {"language": ids, "image": np.zeros((2, 3, 32, 32), np.float32)}
    calls = {
        "init_model_params": lambda: finetune.init_model_params(cfg),
        "make_eval_step": lambda: make_eval_step(cfg),
        "make_train_step": lambda: make_train_step(
            cfg, init_train_state(params, cfg)[1]),
        "model_forward": lambda: finetune.model_forward(
            params, cfg, data, np.zeros(2, np.int32)),
        "from_jax": lambda: from_jax({"w": np.zeros(3, np.float32)}),
        "make_media_loaders": lambda: make_media_loaders(cfg.tower_dict),
        "image_transform": lambda: image_transform(
            np.zeros((40, 56, 3), np.uint8), 32),
        "audio_model_input": lambda: audio_model_input(
            np.zeros(1600, np.float32), FbankConfig(num_mel_bins=32), 48,
            (0, 0, 0), 0.0, 1.0),
        "export_artifact": lambda: export_artifact(params, cfg, data,
                                                   str(tmp_path / "art")),
        "load_artifact": lambda: load_artifact(str(tmp_path / "art")),
        "cli.export": lambda: export_main([
            "--datasetName", "mvsa", "--csv_path", str(tmp_path / "x.csv"),
            "--modality_types", "language", "image", "--model_scale",
            "tiny", "--hash_tokenizer"]),
        "parallel.dryrun": lambda: dryrun(4),
        "maybe_init_distributed": lambda: maybe_init_distributed(
            train_args(["--distributed", "10.0.0.1:1234,2,0"])),
        "trace": lambda: trace(str(tmp_path / "trace")).__enter__(),
        "PRNGSeq": lambda: PRNGSeq(0),
    }
    if entry == "load_artifact":  # a CPU artifact, asked for on the card
        export_artifact(params, cfg, data, str(tmp_path / "art"),
                        device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        calls[entry]()
    # the same call on the CPU, asked for, runs
    logits, _ = finetune.model_forward(params, cfg, data,
                                       np.zeros(2, np.int32), device="cpu")
    assert logits.shape == (2, 3) and torch.isfinite(logits).all()


def test_make_mesh_defaults_to_the_card():
    """The mesh is built for the card unless the caller names the CPU (the
    tests' gloo worlds pass device_type="cpu")."""
    import inspect

    from missm_tpu_torch.core.mesh import make_mesh
    assert inspect.signature(make_mesh).parameters[
        "device_type"].default == "cuda"


@pytest.mark.parametrize("modality", ["image", "depth", "audio"])
def test_media_loaders_follow_their_device(monkeypatch, tmp_path, modality):
    """make_media_loaders(device=...)[m](path) gives a tensor on that
    device, with no host path beside it: built for the card without one it
    raises; built for the CPU its sample lies on the CPU."""
    import wave

    from PIL import Image

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    if modality == "audio":
        path = str(tmp_path / "a.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(4000) * 3000).astype(
                "<i2").tobytes())
    else:
        path = str(tmp_path / "x.png")
        Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
                        if modality == "image" else
                        rng.integers(0, 9000, (30, 40), dtype=np.uint16)
                        ).save(path)
    towers = {modality: tiny_tower(modality)}
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_media_loaders(towers)
    out = make_media_loaders(towers, device="cpu")[modality](path)
    assert torch.is_tensor(out) and out.device.type == "cpu"
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
