"""Training entry point, after missm_tpu/cli/train.py — mirrors
`train_ddp.py` end to end, on one device (`--device`, the card by
default) or, with `--distributed`, on one process a device in a parallel
layout (`--mesh_model`, `--fsdp`, `--mesh_pipe`; pure DP without them):

python -m missm_tpu_torch.cli.train --datasetName mvsa --fusion_type sum \
    --modality_types language image --csv_path .../label.csv
torchrun --nproc_per_node 8 -m missm_tpu_torch.cli.train \
    --distributed true --mesh_model 2 ...

`--batch_size` is a rank's, as the reference's DDP batch is a device's
(train_ddp.py:38): a data replica's ranks read the same rows of its shard.

Writes ./experiments/<dataset>_<fusion>/<save_path> (best_model, and last
with --checkpoint_every or on SIGTERM), TensorBoard scalars under
./experiments/<dataset>_<fusion>/<log_dir> when tensorboard is installed,
and the final model at ./final_model/<dataset>_<fusion>. A SIGTERM exits
with code 75 once the resume checkpoint has landed.
"""
from __future__ import annotations

import os

from ..compat.args import train_args
from ..data.loaders import training_loader
from ..train.checkpoint import restore_checkpoint
from ..train.loop import PreemptedError, train_loop
from ..core.mesh import data_coordinate
from .common import (FORCE_TRAIN_MISSING, build_model_config, init_params,
                     make_loader_fns, make_tokenizer, setup_layout,
                     setup_mesh, to_device, validate_pipe_batch)


def main(argv=None):
    args = train_args(argv)
    if args.fusion_type in FORCE_TRAIN_MISSING:
        args.train_missing = True  # reference train_ddp.py:163-164

    # set_seed equivalent (train_ddp.py:50-54). Beyond the reference:
    # python `random` is seeded too, so the train-time missing draws
    # (random.choice in the datasets) are reproducible.
    import random

    import numpy as np
    mesh = setup_mesh(args)
    validate_pipe_batch(args, mesh)
    shard, n_shards = data_coordinate(mesh)
    # the train-missing draws of a data replica's ranks agree; replicas'
    # differ, as their rows do
    random.seed(args.seed + shard)
    np.random.seed(args.seed + shard)

    experiment = f"{args.datasetName}_{args.fusion_type}"
    save_path = os.path.join("./experiments", experiment, args.save_path)
    log_dir = os.path.join("./experiments", experiment, args.log_dir)
    final_dir = "./final_model"
    os.makedirs(save_path, exist_ok=True)
    os.makedirs(final_dir, exist_ok=True)

    tokenizer = make_tokenizer(args)
    media_loaders = make_loader_fns(args)
    train_loader_, valid_loader, num_classes = training_loader(
        args, args.csv_path, tokenizer, media_loaders, num_shards=n_shards,
        shard_index=shard)

    cfg = build_model_config(args, num_classes, mesh=mesh)
    params = init_params(args, cfg, args.seed)

    teacher_fusion = None
    if args.fusion_type in ("MTD_stu", "KL_stu"):
        # load the Distill_tea final model; its encoder weights replace the
        # (shared) student encoder, its fusion params become the teacher
        # (the reference shares one encoder object, train_ddp.py:191-196)
        tea_path = os.path.join(final_dir,
                                f"{args.datasetName}_Distill_tea")
        tree, _ = restore_checkpoint(tea_path)
        params = {"encoder": to_device(tree["params"]["encoder"],
                                       args.device),
                  "fusion": params["fusion"]}
        teacher_fusion = to_device(tree["params"]["fusion"], args.device)

    if args.frozen_bf16:
        # bit-identical under --bf16 (model_forward casts the encoder tree
        # to bf16 anyway); drops the frozen partition's unread f32 copy
        from ..train.trainability import cast_frozen_params
        params = cast_frozen_params(params, cfg)

    # this rank's slices of the full tree (the teacher's fusion like the
    # student's)
    cfg, params = setup_layout(args, cfg, params, mesh)
    if cfg.parallel is not None and teacher_fusion is not None:
        teacher_fusion = cfg.parallel.partition(
            {"fusion": teacher_fusion})["fusion"]

    writer = None
    if cfg.parallel is None or _rank() == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass

    resume_from = args.resume
    if resume_from == "auto":
        # pick up a prior run's resume point when one exists (the
        # preemption-restart idiom: the same command line works for the
        # first launch and every restart)
        cand = os.path.join(save_path, "last")
        # .old: a crash between _write's two renames leaves only the
        # demoted-but-complete checkpoint; restore_checkpoint resolves it,
        # so it counts as resumable here too (a fresh restart would rmtree
        # it on its first checkpoint write, destroying the one recoverable
        # artifact in exactly the window the atomic swap exists for)
        resume_from = cand if (os.path.isdir(cand)
                               or os.path.isdir(cand + ".old")) else None
        if resume_from is None:
            print("--resume auto: no checkpoint at "
                  f"{cand} — starting fresh")

    try:
        best_params, history = train_loop(
            params, cfg, train_loader_, valid_loader,
            num_epochs=args.num_epochs, learning_rate=args.learning_rate,
            weight_decay=args.weight_decay, patience=args.patience,
            teacher_fusion=teacher_fusion, seed=args.seed,
            save_dir=save_path,
            final_path=os.path.join(final_dir, experiment),
            device=args.device, writer=writer,
            args_metadata=dict(vars(args)),
            accum_steps=args.grad_accum,
            profile_dir=args.profile_dir,
            checkpoint_every=args.checkpoint_every,
            resume_from=resume_from)
    except PreemptedError:
        # the resume checkpoint has landed; EX_TEMPFAIL tells schedulers
        # the run is retriable (relaunch the same command: --resume auto
        # picks the checkpoint up)
        if writer is not None:
            writer.close()
        raise SystemExit(75)

    if writer is not None:
        writer.close()
    if _rank() == 0:
        print("Training completed!")
    return best_params, history


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    main()
