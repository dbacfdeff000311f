"""Serving artifacts through `torch.export`, after missm_tpu/eval/artifact.py.

A trained model's inference function is exported once, at one static batch
shape, with its parameters inside; serving it needs torch and the port's
custom-op registrations (missm_tpu_torch/kernels/ops.py, which
`load_artifact` imports), but no model code, config or checkpoint plumbing.
Unlike the JAX package's StableHLO it does not run on a bare runtime: the
program calls the `missm` ops, whose CUDA kernels the port builds.

Contents of an artifact directory:
  model.pt2       torch.export.save of the ExportedProgram, params inside
  manifest.json   the input/output contract: batch size, each input's
                  shape and dtype, class count, the device it was exported
                  on, the torch version and the op namespace it needs

The exported function is `Predictor._predict` without the params:
`(data, missing_index) -> {"probs", "preds"}`. Serve partial batches
through `ServingArtifact.predict_arrays`, which pads and slices as the
Predictor does.

A multi-device artifact (`mesh=`, missm_tpu/eval/artifact.py:63-67,
88-100, 135-160) serves a batch over the data axis: the program is one
rank's, at batch / n_data rows, with the params replicated in it, and the
manifest records `num_devices` and `data_axis`. `ServingArtifact`, under a
process group of that many ranks, runs each rank's rows and gathers the
results to every rank; under fewer ranks it raises, as JAX does.
"""
from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import ops
from ..models.finetune import ModelConfig, cast_tree, model_forward, tree_map
from .sweep import _pad_batch

ARTIFACT_FILE = "model.pt2"
MANIFEST_FILE = "manifest.json"


class _Serving(torch.nn.Module):
    """model_forward(train=False) over params held as buffers (the encoder
    already in its compute type, as model_forward would cast it), returning
    {"probs", "preds"}."""

    def __init__(self, params, cfg: ModelConfig, device):
        super().__init__()
        self.cfg, self.device = cfg, device
        params = dict(params, encoder=cast_tree(
            params["encoder"], getattr(torch, cfg.compute_dtype)))
        leaves = []
        # the tree's structure with None leaves; tree_map visits the leaves
        # in one order, so forward() refills it from the buffers in order
        self._skeleton = tree_map(leaves.append, params)
        for i, t in enumerate(leaves):
            self.register_buffer(f"p{i}", t.to(device))

    def forward(self, data, missing_index):
        values = iter(self.buffers())
        params = tree_map(lambda _: next(values), self._skeleton)
        logits, _ = model_forward(params, self.cfg, data, missing_index,
                                  train=False, device=self.device)
        return {"probs": torch.softmax(logits, dim=-1),
                "preds": torch.argmax(logits, dim=-1)}


def _to_tensors(tree, device):
    return tree_map(lambda x: torch.as_tensor(x, device=device), tree)


def _batch_rows(data: Mapping) -> int:
    return len(next(iter(v["input_ids"] if isinstance(v, Mapping) else v
                         for v in data.values())))


def export_artifact(params, cfg: ModelConfig, example_data: Mapping,
                    out_dir: str, *, mesh=None,
                    extra_manifest: Optional[Mapping] = None,
                    device="cuda") -> str:
    """Export the inference function of `params` / `cfg` on `device` to
    `out_dir`. example_data: one batch ({modality: array, tensor or token
    dict}) fixing the shapes and types; its batch dim is the artifact's
    batch size. `mesh`: a multi-device artifact over its data axis (the
    params full and replicated, the batch dividing the axis); under a
    process group rank 0 writes it."""
    from ..core.mesh import DATA_AXIS, axis_size

    dev = resolve_device(device)
    batch = _batch_rows(example_data)
    n_dev = axis_size(mesh, DATA_AXIS)
    if batch % n_dev:
        raise ValueError(
            f"batch {batch} not divisible by the mesh's data axis {n_dev} — "
            f"the exported program shards the batch dim")
    data = _to_tensors(dict(example_data), dev)
    local = _rows(data, slice(0, batch // n_dev))
    missing = torch.zeros(batch // n_dev, dtype=torch.int32, device=dev)
    with torch.no_grad():
        program = torch.export.export(_Serving(params, cfg, dev),
                                      (local, missing), strict=False)
    writes = not _grouped() or torch.distributed.get_rank() == 0
    path = os.path.join(out_dir, ARTIFACT_FILE)
    if writes:
        os.makedirs(out_dir, exist_ok=True)
        torch.export.save(program, path)

    def spec(x):
        return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1]}

    n_cls = int(cfg.fusion.output_dims)
    manifest = {
        "format": "torch.export/pt2",
        "batch_size": batch,
        "num_classes": n_cls,
        "modality_types": list(cfg.fusion.modality_types),
        "inputs": tree_map(spec, data),
        "missing_index": {"shape": [batch], "dtype": "int32"},
        "outputs": {"probs": {"shape": [batch, n_cls], "dtype": "float32"},
                    "preds": {"shape": [batch], "dtype": "int64"}},
        "device": dev.type,
        "torch_version": torch.__version__,
        "op_namespace": ops.NAMESPACE,
        "num_devices": n_dev,
        "data_axis": DATA_AXIS,
    }
    if writes:
        manifest["artifact_bytes"] = os.path.getsize(path)
        manifest.update(dict(extra_manifest or {}))
        with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
    if _grouped():
        torch.distributed.barrier()
    return out_dir


def _grouped() -> bool:
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _rows(tree, sl):
    if isinstance(tree, Mapping):
        return {k: _rows(v, sl) for k, v in tree.items()}
    return tree[sl]


class ServingArtifact:
    """A loaded artifact: `.predict_arrays` pads a partial batch to the
    exported batch size and slices the results back, as Predictor does.
    A multi-device artifact (manifest num_devices > 1) needs a process
    group of that many ranks: each runs its rows of the batch and the
    results are gathered to every rank."""

    def __init__(self, program, manifest: Mapping):
        self._module = program.module()
        self.manifest = dict(manifest)
        self.batch_size = int(manifest["batch_size"])
        self.device = resolve_device(manifest["device"])
        self.num_devices = int(manifest.get("num_devices", 1))
        if self.num_devices > 1:
            dist = torch.distributed
            have = (dist.get_world_size() if dist.is_available()
                    and dist.is_initialized() else 1)
            if have < self.num_devices:
                raise ValueError(
                    f"artifact was exported for {self.num_devices} "
                    f"devices; only {have} available")
            if have > self.num_devices:
                raise ValueError(
                    f"artifact was exported for {self.num_devices} "
                    f"devices; the process group has {have} ranks")

    def _typed(self, tree, specs):
        if isinstance(tree, Mapping):
            return {k: self._typed(v, specs[k]) for k, v in tree.items()}
        x = torch.as_tensor(tree, device=self.device)
        want = getattr(torch, specs["dtype"])
        if x.dtype == torch.uint8 and want.is_floating_point:
            # a cast would feed the raw 0-255 values unnormalised
            raise ValueError("uint8 media (--uint8_upload) given to an "
                             "artifact exported for normalised float "
                             "input")
        return x.to(want)

    def predict_arrays(self, data: Mapping, missing_index=None):
        """data: {modality: batched array, tensor or token dict}; returns
        (preds, probs) as numpy, cut to the batch's own length."""
        n = _batch_rows(data)
        target = self.batch_size
        if n > target:
            raise ValueError(
                f"got a batch of {n} rows but the artifact was exported at "
                f"batch_size {target}; chunk the input")
        data = _pad_batch({k: v if isinstance(v, Mapping) or torch.is_tensor(v)
                           else np.asarray(v) for k, v in data.items()},
                          target)
        if missing_index is None:
            missing_index = np.zeros((target,), np.int32)
        else:
            missing_index = _pad_batch(np.asarray(missing_index, np.int32),
                                       target)
        data = self._typed(data, self.manifest["inputs"])
        missing_index = self._typed(missing_index,
                                    self.manifest["missing_index"])
        if self.num_devices > 1:
            from ..parallel.collectives import all_gather
            b = target // self.num_devices
            r = torch.distributed.get_rank()
            with torch.no_grad():
                out = self._module(_rows(data, slice(r * b, (r + 1) * b)),
                                   missing_index[r * b:(r + 1) * b])
            out = {k: all_gather(v, 0, None) for k, v in out.items()}
        else:
            with torch.no_grad():
                out = self._module(data, missing_index)
        return (out["preds"].cpu().numpy()[:n],
                out["probs"].float().cpu().numpy()[:n])


def load_artifact(path: str, *, device="cuda") -> ServingArtifact:
    """The artifact in directory `path`, to serve on `device` (the card by
    default), which must be the device it was exported on: its program
    holds its params and constants there. Importing this module registered
    the `missm` ops the program calls."""
    dev = resolve_device(device)
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest["device"] != dev.type:
        raise ValueError(f"the artifact at {path} was exported on "
                         f"{manifest['device']}; load it with "
                         f"device={manifest['device']!r}")
    return ServingArtifact(torch.export.load(os.path.join(path,
                                                          ARTIFACT_FILE)),
                           manifest)
