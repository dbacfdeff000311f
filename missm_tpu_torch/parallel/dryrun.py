"""The port's `dryrun_multichip`, after __graft_entry__.py:65-248: every
layout of the JAX dryrun takes one real train step and one accum_steps=2
step on the tiny self_distill model (image, video and audio towers and the
text tower; 2 rows a data rank, times the pipeline's microbatches), the
layouts in turn in one N-rank gloo world, each with its own mesh:

    python -m missm_tpu_torch.parallel.dryrun N [--device cpu]

The layouts (n_data, n_model, n_pipe, fsdp, schedule): DP, FSDP, and for
even N >= 4 DP x TP, DP x GPipe and DP x 1F1B, and for N a multiple of 4
(N >= 8) DP x TP x pipe under both schedules. Each world asserts a finite
loss, that the FSDP shard and the pipeline stage's blocks survive the
step, and prints JAX's `dryrun_multichip(N): mesh=(...) ... OK` line. On
the card (the default) the N ranks share it over gloo, their CUDA tensors
staged through the host for the ops gloo lacks; each rank reports the hand
kernels it launched (kernels/launches.py), and `dryrun` returns them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

FSDP_MIN = 128


def layouts(n: int):
    """(n_data, n_model, n_pipe, fsdp, schedule) of the JAX dryrun
    (__graft_entry__.py::_dryrun_layouts)."""
    out = [(n, 1, 1, False, "gpipe"), (n, 1, 1, True, "gpipe")]
    if n % 2 == 0 and n >= 4:
        out += [(n // 2, 2, 1, False, "gpipe"), (n // 2, 1, 2, False, "gpipe"),
                (n // 2, 1, 2, False, "1f1b")]
    if n % 4 == 0 and n >= 8:
        out += [(n // 4, 2, 2, False, "gpipe"), (n // 4, 2, 2, False, "1f1b")]
    return out


def _model():
    from ..core.config import tiny_tower
    from ..models.finetune import ModelConfig
    from ..models.fusion import FusionConfig

    towers = (("image", tiny_tower("image")), ("video", tiny_tower("video")),
              ("audio", tiny_tower("audio")))
    fusion = FusionConfig(fusion_type="self_distill",
                          modality_types=("language", "video", "audio",
                                          "image"),
                          output_dims=3, feature_dims=24, fusion_dim=8)
    return ModelConfig(towers=towers, fusion=fusion)


def _batch(B):
    import numpy as np
    rng = np.random.default_rng(0)
    data = {
        "language": np.asarray(rng.integers(1, 98, (B, 16)), np.int32),
        "image": rng.standard_normal((B, 3, 32, 32)).astype(np.float32),
        "video": rng.standard_normal((B, 3, 4, 32, 32)).astype(np.float32),
        "audio": rng.standard_normal((B, 3, 32, 48)).astype(np.float32),
    }
    labels = np.asarray(rng.integers(0, 3, B), np.int32)
    missing = np.asarray(rng.choice([0, 1, 2, 3, 4], B), np.int32)
    return data, labels, missing


def run_layout(n: int, n_data: int, n_model: int, n_pipe: int, fsdp: bool,
               schedule: str, device: str) -> dict:
    """One rank of one layout's world (the process group is up): the two
    steps and the checks; returns this rank's losses and launches."""
    import dataclasses
    import math

    import torch

    from ..core.device import resolve_device
    from ..core.mesh import make_mesh
    from ..kernels.launches import LAUNCHES, reset_launches
    from ..models.finetune import init_model_params
    from .partitioning import make_layout, shard_batch
    from .pipeline import PipeConfig
    from ..train.step import init_train_state, make_train_step

    dev = resolve_device(device)
    cfg = _model()
    mesh = make_mesh(n_data, n_model, n_pipe, device_type=dev.type)
    full = init_model_params(cfg, seed=0, device=dev)
    lay = make_layout(full, mesh, tp=n_model > 1, fsdp=fsdp,
                      fsdp_min_size=FSDP_MIN, pipe=n_pipe > 1,
                      towers=cfg.tower_dict)
    pipe = PipeConfig(mesh, n_pipe, schedule=schedule) if n_pipe > 1 else None
    cfg = dataclasses.replace(cfg, parallel=lay, pipe=pipe)
    state, tx = init_train_state(lay.partition(full), cfg)
    gen = torch.Generator(device=dev).manual_seed(1 + lay.data_index)
    # JAX's 2 rows a data shard, times the microbatches: here each data
    # rank pipelines its own rows, so a rank's accum microbatch must split
    # into M pipeline microbatches (GSPMD splits the global batch instead)
    batch = _batch(2 * n_data * n_pipe)
    reset_launches()
    losses = []
    for accum in (1, 2):
        step = make_train_step(cfg, tx, accum_steps=accum, device=dev)
        data, labels, missing = shard_batch(batch, mesh, microbatches=accum)
        state, met = step(state, data, labels, missing, 1e-3, gen)
        losses.append(float(met["loss"]))
        assert math.isfinite(losses[-1]), losses
    if dev.type == "cuda":
        torch.cuda.synchronize()
    blocks = state.params["encoder"]["image"]["vision"]["blocks"]
    w = blocks[0]["mlp"]["fc1"]["w"]
    full_w = full["encoder"]["image"]["vision"]["blocks"][0]["mlp"]["fc1"][
        "w"]
    if fsdp:
        # the memory lever is real only if the shard survives the step
        assert w.numel() * n_data == full_w.numel(), tuple(w.shape)
    if n_pipe > 1:
        # the depth lever is real only if the stage keeps its own blocks
        n_blocks = len(full["encoder"]["image"]["vision"]["blocks"])
        assert len(blocks) * n_pipe == n_blocks, len(blocks)
    return {"losses": losses, "launches": dict(LAUNCHES)}


def _line(n, n_data, n_model, n_pipe, fsdp, schedule, losses) -> str:
    return (f"dryrun_multichip({n}): mesh=({n_data}x{n_model}"
            f"{f'x{n_pipe}pipe' if n_pipe > 1 else ''}"
            f"{f'[{schedule}]' if n_pipe > 1 and schedule != 'gpipe' else ''}"
            f"{' fsdp' if fsdp else ''}) "
            f"loss={losses[0]:.4f} accum2_loss={losses[1]:.4f} OK")


def dryrun(n: int, *, device: str = "cuda", timeout: float = 600.0,
           echo: bool = True):
    """Every layout of `layouts(n)`, in turn, in one n-rank gloo world
    (each layout its own mesh and groups; the JAX dryrun's child a layout
    guards against XLA:CPU's collective interlock, which this world does
    not have); returns [(layout, [each rank's result])]. A rank that
    fails, or a world that hangs past `timeout`, fails the run."""
    from ..core.device import resolve_device
    resolve_device(device)  # the card unless asked, before any process
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as work:
        logs = [open(os.path.join(work, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "missm_tpu_torch.parallel.dryrun",
             "--rank", str(r), str(n), work, device, str(timeout)],
            env=env, cwd=repo, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"dryrun({n}): a rank hung past {timeout} s")
        finally:
            text = []
            for log in logs:
                log.seek(0)
                text.append(log.read())
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(f"dryrun({n}) failed on ranks {bad}:\n"
                               + "\n".join(text[r][-3000:] for r in bad))
        ranks = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    out = []
    for i, spec in enumerate(layouts(n)):
        results = [rank[i] for rank in ranks]
        if echo:
            print(_line(n, *spec, results[0]["losses"]), flush=True)
        out.append((spec, results))
    return out


def _rank_main(rank, n, work, device, timeout):
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "rendezvous"),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=float(timeout)))
    try:
        res = [run_layout(n, *spec, device) for spec in layouts(n)]
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--rank":
        _rank_main(int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5])
        return
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    dryrun(int(argv[0]) if argv else 8, device=device)


if __name__ == "__main__":
    main()
