"""What the ranks of the parallel tests' gloo worlds run (tests/torch_world.py
calls these as `function(rank, world, **kwargs)`). Torch and the port only:
the parents hold the results against the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from missm_tpu_torch.compat.from_jax import from_jax, to_numpy
from missm_tpu_torch.core.config import tiny_tower
from missm_tpu_torch.core.mesh import make_mesh
from missm_tpu_torch.models.finetune import ModelConfig, model_forward
from missm_tpu_torch.models.fusion import FusionConfig
from missm_tpu_torch.parallel import (PipeConfig, make_layout, shard_batch)
from missm_tpu_torch.train.step import init_train_state, make_train_step


def model_config(towers, fusion, layers=None, vision_kw=None, remat=False):
    """The port's ModelConfig of (modality, ...) tiny towers; `layers`
    deepens every tower, `vision_kw` overrides the vision configs."""
    over = dict(vision_kw or {})
    if layers is not None:
        over["num_layers"] = layers
    tcfg = []
    for m in towers:
        t = tiny_tower(m, **over)
        if layers is not None:
            t = dataclasses.replace(t, text=dataclasses.replace(
                t.text, num_layers=layers))
        tcfg.append((m, t))
    return ModelConfig(towers=tuple(tcfg), fusion=FusionConfig(**fusion),
                       remat=remat)


def setup(cfg, tree, n_data, n_model, n_pipe, fsdp, schedule="gpipe",
          microbatches=0, fsdp_min_size=128):
    """(cfg with its layout and pipe, the layout, full port params)."""
    mesh = make_mesh(n_data, n_model, n_pipe, device_type="cpu")
    full = from_jax(tree, device="cpu")
    lay = make_layout(full, mesh, tp=n_model > 1, fsdp=fsdp,
                      fsdp_min_size=fsdp_min_size, pipe=n_pipe > 1,
                      towers=cfg.tower_dict)
    pipe = (PipeConfig(mesh, n_pipe, microbatches, schedule)
            if n_pipe > 1 else None)
    return dataclasses.replace(cfg, parallel=lay, pipe=pipe), lay, full


def _local(path_leaf, params):
    node = params
    for k in path_leaf:
        node = node[k]
    return (len(node),) if isinstance(node, list) else tuple(node.shape)


def train_case(rank, world, *, tree, batch, towers, fusion, n_data, n_model,
               n_pipe, fsdp=False, schedule="gpipe", microbatches=0,
               layers=None, vision_kw=None, lr=1e-4, accums=(1, 2),
               probe=None, fsdp_min_size=128, remat=False):
    """Eval logits of this rank's rows, then one Adam step at each of
    `accums` from the same params: {"data_index", "logits", "steps": [(loss,
    full params after the step (rank 0), probe leaf's local shape)]}."""
    cfg = model_config(towers, fusion, layers, vision_kw, remat)
    cfg, lay, full = setup(cfg, tree, n_data, n_model, n_pipe, fsdp,
                           schedule, microbatches, fsdp_min_size)
    data, labels, missing = batch
    out = {"data_index": lay.data_index, "steps": []}
    params = lay.partition(full)
    d, _, m = shard_batch((data, labels, missing), lay.mesh)
    with torch.no_grad():
        logits, _ = model_forward(params, cfg, d, m, device="cpu")
    out["logits"] = logits.numpy().copy()
    for A in accums:
        params = lay.partition(from_jax(tree, device="cpu"))
        state, tx = init_train_state(params, cfg)
        step = make_train_step(cfg, tx, accum_steps=A, device="cpu")
        d, lab, m = shard_batch((data, labels, missing), lay.mesh,
                                microbatches=A)
        state, met = step(state, d, lab, m, lr, torch.Generator())
        shape = None if probe is None else _local(probe, state.params)
        gathered = lay.gather(state.params)
        out["steps"].append((float(met["loss"]),
                             to_numpy(gathered) if rank == 0 else None,
                             shape))
    return out


def numpy_batch(B, L, *, modalities, seed=2, frames=4):
    """A tiny batch: text ids with an EOT and a padding mask (a masked
    token before EOT in every other row), image [B, 3, 32, 32], video [B, 3,
    frames, 32, 32]; labels of 3 classes, missing codes."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 98, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for i, n in enumerate(rng.integers(4, L + 1, size=B)):
        ids[i, n - 1] = 98
        mask[i, n:] = 0
    mask[::2, 1] = 0
    data = {"language": {"input_ids": ids, "attention_mask": mask}}
    if "image" in modalities:
        data["image"] = rng.standard_normal((B, 3, 32, 32)).astype(np.float32)
    if "video" in modalities:
        data["video"] = rng.standard_normal(
            (B, 3, frames, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 3, size=B).astype(np.int32)
    codes = [0, 1, 4] + ([2] if "video" in modalities else [])
    missing = rng.choice(codes, B).astype(np.int32)
    return data, labels, missing


class ArrayLoader:
    """An in-memory loader over (data, labels, missing) numpy arrays with
    data/loaders.py::BatchLoader's shards: each rank takes every n-th row
    of the (unshuffled) order, the order wrapped to a multiple of n, and
    `shard_real_count` says how many of its rows are real."""

    def __init__(self, data, labels, missing, batch_size, num_shards=1,
                 shard_index=0, sigterm_at=None):
        self.data, self.labels, self.missing = data, labels, missing
        self.batch_size = batch_size
        self.num_shards, self.shard_index = num_shards, shard_index
        self.sigterm_at = sigterm_at  # (iteration, batch): raise SIGTERM
        self.iterations = 0

    def _indices(self):
        n = len(self.labels)
        per = -(-n // self.num_shards)
        order = np.arange(per * self.num_shards) % n
        idx = order[self.shard_index::self.num_shards]
        self.shard_real_count = int(np.sum(
            np.arange(per * self.num_shards)[self.shard_index::self.num_shards]
            < n))
        return idx

    def __len__(self):
        return -(-len(self._indices()) // self.batch_size)

    def __iter__(self):
        import os
        import signal
        idx = self._indices()
        it = self.iterations
        self.iterations += 1
        for b, i in enumerate(range(0, len(idx), self.batch_size)):
            if self.sigterm_at == (it, b):
                os.kill(os.getpid(), signal.SIGTERM)
            rows = idx[i:i + self.batch_size]
            data = {k: ({n: v[rows] for n, v in d.items()}
                        if isinstance(d, dict) else d[rows])
                    for k, d in self.data.items()}
            yield data, self.labels[rows], self.missing[rows]


def eval_case(rank, world, *, tree, batch, towers, fusion, batch_size):
    """evaluate_loader and the concat_mean statistics over this rank's
    shard of `batch`, gathered over the data group."""
    from missm_tpu_torch.eval.sweep import evaluate_loader, statistics_pass
    from missm_tpu_torch.train.step import make_eval_step

    cfg = model_config(towers, fusion)
    cfg, lay, full = setup(cfg, tree, world, 1, 1, False)
    loader = ArrayLoader(*batch, batch_size=batch_size, num_shards=world,
                         shard_index=rank)
    losses, labels, preds, probs = evaluate_loader(
        full, make_eval_step(cfg, device="cpu"), loader,
        group=lay.data_group)
    stats = statistics_pass(full, cfg, loader, "mean", device="cpu")
    return {"losses": losses, "labels": labels, "preds": preds,
            "probs": probs, "stats": stats}


def checkpoint_case(rank, world, *, tree, towers, fusion, n_data, n_model,
                    fsdp, path):
    """One train step on a layout, then checkpoint.save_checkpoint of the
    gathered params and Adam state (rank 0 writes); returns this rank's
    local fc1 shape and, on rank 0, the gathered tree."""
    from missm_tpu_torch.train.checkpoint import save_checkpoint
    from missm_tpu_torch.train.loop import _opt_tree

    cfg = model_config(towers, fusion)
    cfg, lay, full = setup(cfg, tree, n_data, n_model, 1, fsdp)
    params = lay.partition(full)
    state, tx = init_train_state(params, cfg)
    step = make_train_step(cfg, tx, device="cpu")
    data, labels, missing = shard_batch(numpy_batch(
        4 * n_data, 16, modalities=towers), lay.mesh)
    state, _ = step(state, data, labels, missing, 1e-3, torch.Generator())
    gathered = lay.gather(state.params)
    opt = _opt_tree(state.params, tx, lay)
    save_checkpoint(path, {"params": gathered, "opt_state": opt})
    local = state.params["encoder"]["image"]["vision"]["blocks"][0]["mlp"][
        "fc1"]["w"]
    return {"local": tuple(local.shape),
            "params": to_numpy(gathered) if rank == 0 else None}


def loop_case(rank, world, *, tree, batch, towers, fusion, save_dir,
              sigterm_at=None, resume=False, epochs=2):
    """train_loop on a DP layout over this rank's shard; SIGTERM on
    `sigterm_at` = (rank, iteration, batch). Returns how it ended, the
    gathered final params and the preempted metadata."""
    from missm_tpu_torch.train.checkpoint import read_metadata
    from missm_tpu_torch.train.loop import PreemptedError, train_loop

    cfg = model_config(towers, fusion)
    cfg, lay, full = setup(cfg, tree, world, 1, 1, False)
    params = lay.partition(full)
    hit = None if sigterm_at is None or sigterm_at[0] != rank else \
        sigterm_at[1:]
    mk = lambda sig: ArrayLoader(*batch, batch_size=2, num_shards=world,
                                 shard_index=rank, sigterm_at=sig)
    out = {"rank": rank}
    try:
        _, hist = train_loop(
            params, cfg, mk(hit), mk(None), num_epochs=epochs,
            learning_rate=1e-3, seed=0, save_dir=save_dir,
            final_path=save_dir + "/final", device="cpu", checkpoint_every=1,
            sync_every=0, resume_from=save_dir + "/last" if resume else None,
            log=lambda *a: None)
        out["end"] = "done"
        out["epochs"] = len(hist)
    except PreemptedError:
        out["end"] = "preempted"
        out["meta"] = read_metadata(save_dir + "/last")["preempted"]
    out["params"] = to_numpy(lay.gather(params))
    return out


def artifact_case(rank, world, *, tree, towers, fusion, batch, out_dir):
    """A DP serving artifact over `world` ranks: export (rank 0 writes),
    load, serve `batch` (each rank its rows, gathered)."""
    from missm_tpu_torch.core.mesh import make_mesh as mk_mesh
    from missm_tpu_torch.eval.artifact import export_artifact, load_artifact

    cfg = model_config(towers, fusion)
    mesh = mk_mesh(device_type="cpu")
    params = from_jax(tree, device="cpu")
    data, _, missing = batch
    export_artifact(params, cfg, data, out_dir, mesh=mesh, device="cpu")
    art = load_artifact(out_dir, device="cpu")
    preds, probs = art.predict_arrays(data, missing)
    return {"preds": preds, "probs": probs, "manifest": art.manifest}


def predict_case(rank, world, *, argvs, cwd):
    """cli.predict --distributed of each argv of `argvs` in turn, in `cwd`,
    on this rank (the world's gloo group up, as torchrun's would be): for
    each, how many samples this rank's Predictor collated and how many
    parameter elements it holds."""
    import os

    from missm_tpu_torch.cli import predict as cli_predict
    from missm_tpu_torch.eval.predictor import Predictor

    out = []
    init, collate = Predictor.__init__, Predictor._collate_raw

    def counted_init(self, params, *a, **kw):
        init(self, params, *a, **kw)
        leaves = []
        torch.utils._pytree.tree_map(leaves.append, self.params)
        out[-1]["numel"] = sum(t.numel() for t in leaves
                               if isinstance(t, torch.Tensor))

    def counted_collate(self, samples):
        out[-1]["rows"] += len(samples)
        return collate(self, samples)
    Predictor.__init__, Predictor._collate_raw = counted_init, counted_collate
    os.chdir(cwd)
    try:
        for argv in argvs:
            out.append({"rows": 0, "numel": 0})
            cli_predict.main(argv + ["--distributed", "true"])
    finally:
        Predictor.__init__, Predictor._collate_raw = init, collate
    return out
