"""Smoke run of the PyTorch/CUDA port (missm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--only parallel|cli|probes]

Phases, each of which fails the run (non-zero exit, no result line):
  1. device   - needs a CUDA GPU; prints its name and power limit.
  2. build    - compiles every csrc/*.cu with nvcc (one process per source,
                all started together).
  3. kernels  - each kernel through its wrapper, at the shapes and template
                variants each step gives it (eval: K1 and K2(a) with the key
                bias at B=64; train: K1 writing the log-sum-exp, its K3
                backward through autograd and K2(a) without a key bias at
                B=16; eval3: K2(a) without a key bias at B=16, K2(b) on the
                audio tower's [16, 593] and K2(c) on the video tower's
                temporal [16*257, 8]; train3, recorded: K1 and K3 at
                [64, 257], K2(b) and K4 unmasked at [8, 593], K2(c) and K4
                block-diagonal at [8*257, 8], K2(a) at B=8; each backward
                through torch.autograd.grad; distill: K1 without the
                log-sum-exp at B=16, the teacher's no-grad forward (the
                sweep's shapes are eval's); ln2fc1: K5 at the eval image
                [64*257, 1024] -> 4096 with bias and text [64*77, 768] ->
                3072 without, and at the train microbatch's image and ragged
                text [16*77, 768] rows with its backward; probes: K6 at
                [16448, 1024, 4096], and the probes' attention kernels, P1
                at [1024, 257, 64], P2 at [64, 16, 257, 64], P3 and P4 in
                each of its modes at [64, 257, 16*64]), against its plain
                PyTorch version in f32 and bf16, each launch counted under
                its own name; times the kernel, the plain version and one
                PyTorch library call doing the same work where there is one
                (CUDA events, median of 7 runs of 20 launches, inputs
                rotated through enough copies to miss the 50 MB L2), and
                works out the least time the card could take.
  4. eval     - the flagship eval step (LanguageBind ViT-L/14 image tower +
                CLIP text tower + `sum` head, seeded random weights, bf16
                encoder, B=64, missing codes rotating over {0, 1, 4}) through
                make_eval_step; checks that every step launched K1 24 times
                and K2 12 times, that the outputs are finite and the probs sum
                to 1, and times samples/s. Then holds the card's f32 logits
                for 4 rows against the CPU's plain path.
  5. train    - the flagship train step (bench.py's train workload: the same
                model, B=64 as 4 microbatches of 16, LoRA-only vision grads,
                Adam at lr 1e-4, head dropout 0.1, no remat) through
                make_train_step; checks that every step launched K1 96, K3 96
                and K2 48 times, that the loss is finite, that no frozen leaf
                moved and the trainable ones did, and times samples/s. Then
                holds the card's f32 gradients for 4 rows (LoRA B non-zero,
                TF32 off) against the CPU's plain path.
  6. eval3    - bench.py's eval3 workload: the video+audio+language `sum` eval
                step (LanguageBind video tower with temporal attention over
                8 frames, audio tower on the 112x1036 grid, the audio
                tower's text tower; seeded random weights, bf16 encoder,
                B=16, video [16, 3, 8, 224, 224], audio [16, 3, 112, 1036],
                ids without a mask, missing codes rotating over {0, 1, 2,
                3}) through make_eval_step; checks that every step launched
                K1 24 times (video spatial, [128, 257]), K2(b) 24 (audio,
                [16, 593]), K2(c) 24 (temporal) and K2(a) 12, that the
                outputs are finite and the probs sum to 1, and times
                samples/s. Then holds the card's f32 logits for 2 rows
                against the CPU's plain path.
  7. train3   - bench.py's train3 workload: eval3's model trained (B=8,
                f32 video [8, 3, 8, 224, 224] and audio [8, 3, 112, 1036],
                ids without a mask, missing codes from {0, 1, 2, 3}, frozen
                leaves stored in bf16, bf16 encoder, LoRA on the temporal
                and the audio attention, the text tower in full, Adam at lr
                1e-4, head dropout 0.1, no remat) through make_train_step
                at accum_steps 1; checks that every step launched K1, K3,
                K2(b), K4 unmasked, K2(c) and K4 block-diagonal 24 times
                each and K2(a) 12 times, that the losses are finite, that no
                frozen leaf moved (the video tower's spatial attention among
                them) and the watched trainable ones did, and times
                samples/s and peak memory. Then holds the card's f32
                gradients for 2 complete rows at full depth (LoRA B
                non-zero, TF32 off) against the CPU's plain path.
  8. ln2fc1   - the flagship eval step (B=64) and train step (B=64 as 4 x 16)
                with the pre-LN block's ln2 -> fc1 through K5 (FUSE_LN2_FC1
                on), timed in turns with the switch off (off, on, on, off);
                checks that every fused eval step launched K5 36 times (24
                image + 12 text blocks) beside K1 24 and K2 12, every fused
                train step K5 144 beside 96/96/48 (and the unfused arms 0),
                that the outputs are finite, no frozen leaf moved and the
                trainable ones did (the text tower's fc1 and ln2 among them).
                Then holds the card's fused f32 logits for 8 rows against
                the CPU's plain path, and one step's card f32 gradients for
                8 rows fused against unfused (TF32 off).
  9. probes   - every probe once (missm_tpu_torch.probes): the 24-layer
                image stack at B=64, fused and unfused; 24 chained layers
                of K6 against the cuBLAS chain; P1 at each of its tiles
                beside the einsum forms and SDPA; the image stack with each
                ablation arm (identity, production K1, P4 dotsonly, noexp,
                nostage and full, P3, P2). Prints ms per stack or call,
                checks the launches of K5, K6 and P1-P4 and that the arms
                computing softmax attention agree with production.
 10. heads    - all 13 fusion heads at the flagship's fusion widths (feature
                768, fusion 256, 10 classes) on random f32 embeddings of
                (language, video, audio), B=64, codes rotating over {0, 1,
                2, 3}: logits and the gradient of their sum with respect to
                every head param, card f32 (TF32 off) against the CPU
                (logits within 1e-3, gradients 1e-4 relative); no kernel
                launch.
 11. distill  - the flagship train step with the MTD_stu head (B=64 as 4 x
                16, Adam, a teacher copied from a Distill_tea init) through
                timed_train: every step launches K1 192 times (the student's
                96 and the teacher's no-grad 96), K2(a) 96 and K3 96; then
                one step after which the teacher equals old * 0.999 + the
                updated student fusion * 0.001 within 4 units of f32
                rounding of those terms, element by element, and no frozen
                leaf moved; then one step each of KL_stu (the launches of
                MTD_stu) and self_distill (K1 96, K3 96, K2(a) 48) with a
                finite loss. Prints samples/s beside the train phase's.
 12. sweep    - the flagship model with the concat head and a bf16 encoder
                through run_missing_sweep(concat_mean): the statistics pass
                over 2 x 64 train rows, then missing types (language, image,
                mixed) x ratios (0.1, 0.5, 0.9), each a batch of 64 and a
                partial batch of 37 with codes from the ported
                simulate_missing_modality; checks K1 24 and K2(a) 12
                launches per batch, 9 finite report blocks read back, and
                that the statistics the pass computes are non-zero and the
                ones the sweep evaluated with; prints sweep samples/s.
 13. data     - the data layer: a mvsa-style tree written to a temporary
                directory (label.csv, missing_index.pkl from the ported
                generate_missing_index, 128 train, 64 valid and 136 test
                rows, one seeded JPEG a row at 375x500, 480x640, 720x1280
                or 500x333) through the port's testing_loader (HashTokenizer,
                PIL decode on 8 threads, image_transform on the card) into
                the sweep's model and run_missing_sweep(concat_mean): 3
                missing types x 10 loaders of 64 + 64 + 8 rows and the
                statistics pass over the 128 train rows; checks K1 24 and
                K2(a) 12 launches per batch and 30 finite report blocks and
                prints rows/s. Then two train steps of the flagship `sum`
                model (4 x 16) on training_loader's batches with train-time
                missing codes: K1 96, K3 96, K2(a) 48 a step, finite losses,
                watched leaves moved, frozen ones not. Checks that the disk
                batches equal the same loaders' batches built on the CPU
                (ids, masks, labels and codes exactly, images within 2e-4 +
                1e-4 |ref|), that image_transform (each photo size),
                video_transform ([8, 360, 640, 3], flip off and on) and
                depth_transform (max_depth 10 and 0) on the card agree with
                the CPU within the same limit, and that audio_model_input on
                the card (10 s and 15 s WAVs, 112 bins x 1036 frames) agrees
                with the numpy host path within 2e-3 + 1e-4 |ref|; that
                the image, depth and audio media loaders built for the card
                give samples there, within those limits of the CPU's; and
                that image_transform over 64 distinct source sizes holds no
                card memory after; prints the card ms a sample of each
                transform and that run's peak memory.
 14. cli      - the entry points (missm_tpu_torch.cli) in a temporary working
                directory on the data phase's mvsa tree, written anew:
                cli.train at the flagship's full width (seeded random init,
                bf16 encoder, the CLI's default remat, B=16, 2 epochs, a
                resume checkpoint every epoch) checks two finite epochs,
                best_model, last (loop epoch 1) and final_model/mvsa_sum,
                the final model's frozen leaves equal to a fresh init's bit
                for bit and its watched LoRA and fusion leaves moved, and
                K1 48, K3 24, K2(a) 24 a train step (each block's forward
                recomputed in the backward, every train-step K1 writing the
                log-sum-exp) and K1 24, K2(a) 12 a val batch; the same
                command resumed to 3 epochs continues at epoch 3 with the
                first run's history; a cli.train subprocess (--frozen_bf16,
                --profile_dir) exits 75 on a SIGTERM after its first epoch,
                leaving a `last` that says `preempted` and a Chrome trace
                that holds device kernels, and its --resume auto exits 0;
                cli.test (sum, 3 missing types x 10 loaders of 64 + 64 +
                8 rows) writes 30 finite report blocks in the reference's
                format, K1 24 and K2(a) 12 a batch; cli.predict writes 136
                rows in range, and Predictor.from_checkpoint equals
                model_forward on the restored params; the converter
                (init_params --init checkpoint on tests/fixtures/lb_ckpt,
                f32, TF32 off) reproduces the reference towers' features
                within 5e-5 + 2e-4 |ref|. Prints each epoch's samples/s and
                duty, each checkpoint write's seconds and size and the
                sweep's rows/s. Then cli.predict --distributed from
                the final model on two ranks sharing the card over gloo
                (`python3 chip_smoke.py --predict-rank` processes), under
                DP 2 and then --mesh_model 2: each rank K1 24 and K2(a) 12
                a batch of its shard, rank 0's predictions.csv against the
                one-process run's (confidences within 1e-2, preds equal
                wherever the top-2 margin exceeds that), rows/s and each
                rank's peak; --uint8_upload true: one cli.train epoch
                against the first run's first epoch (the same launches,
                every batch dequantized by the model, the first step's loss
                within 2e-2 relative), the cli.test sweep of the mixed
                type with the flag and then without (rows/s of each), and
                the loaders' uint8 batch of 16 images on the card,
                dequantized, within 0.5/255/min(std) + 1e-4 of the f32
                batch (both loaders timed in turns).
 15. remat    - the named remat policies (models/tower.py::REMAT_POLICIES):
                the flagship train step (4 x 16) under bench.py's
                save_attn_mlp_qkv_kern, K1 96 (every one writing the
                log-sum-exp), K3 96, K2(a) 48 a step (the no-remat counts:
                no forward kernel again in the backward), and under full
                remat (192 / 96 / 96), samples/s and peak memory; each of
                the nine policies once on a 16-row microbatch, f32 with
                TF32 off, its gradients within 1e-5 relative of no remat's,
                its exact launches and peak; train3 (B=8) under bench.py's
                per-tower spec (video save_attn_mlp_qkv, audio
                save_attn_mlp_kern, language save_attn_mlp), samples/s and
                peak; cli.train --remat save_attn_mlp_qkv_kern for an epoch
                on a mvsa tree (K1 24, K3 24, K2(a) 12 a step).
 16. export   - serving artifacts (eval/artifact.py, torch.export): the
                flagship exported on the card at B=64 (seconds, model.pt2
                bytes), loaded in a fresh subprocess, predict_arrays
                against the Predictor (preds equal, probs within 1e-6) for
                each code set and a partial batch, K1 24 and K2(a) 12 a
                batch from the artifact, rows/s of both; cli.export ->
                cli.predict --artifact against cli.predict from the
                checkpoint on a mvsa tree.
 17. towers   - the tube-3D embedding with patch dropout and 7-D input at
                languagebind_large("video") widths, card f32 (the kernels)
                against the CPU (the plain versions): pooled features and
                temporal LoRA gradients, exact launches.
 18. parallel - the parallel layouts (missm_tpu_torch.parallel) on the
                flagship at full width and depth, each rank a `python3
                chip_smoke.py --parallel-rank` process, each world's
                layouts in turn: one rank over NCCL
                (init_process_group("nccl"), make_mesh), its f32 gradients
                (TF32 off, B=64 as 4 x 16) against the phase-free step's;
                DP 2, FSDP 2, TP 2, GPipe 2 and 1F1B 2 as two ranks sharing
                the card over gloo at the same global batch: loss and every
                trainable leaf's f32 gradient within 1e-5 relative of the
                one-rank step, then bf16 samples/s, each rank's peak memory
                and its exact K1 / K3 / K2(a) launches a step; train3 (B=8)
                under DP 2 x GPipe 2 on four ranks, K1, K3, K2(b), K4,
                K2(c), K4 block-diagonal and K2(a) on every stage; the
                dryrun (missm_tpu_torch.parallel.dryrun) at N = 4 and 8 on
                the card, every rank's hand kernels counted. Ranks sharing
                one card are not a multi-GPU rate.
 19. summary  - a `{"kernels": [...]}` line, the card's name and power limit,
                and as the last line {"ok": true, "device": {...}}.
The kernels phase also times each `missm` custom op's host cost a call
against the `_launch` it wraps.
--profile adds one torch.profiler-traced step of each of eval, train, eval3,
train3, ln2fc1 eval and ln2fc1 train and prints device time by kernel.
--only builds, then runs one phase and prints no result line; `--only
probes` runs the P1-P4 rows of the kernels phase, then the probes phase.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (at the 700 W limit): device memory and dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50e6
B = 64                      # the flagship batch (bench.py eval and train)
ACCUM = 4                   # bench.py's train microbatches (4 x 16)
B3 = 16                     # bench.py's eval3 batch
B3T = 8                     # bench.py's train3 batch
FRAMES = 8                  # frames per video (languagebind_large("video"))
LR = 1e-4                   # bench.py's train learning rate
STEPS = 5
TOL = {torch.float32: (1e-4, 0.0),      # summation order only
       torch.bfloat16: (2e-2, 2 ** -7)}  # P rounded at other places; out ulp
# K3 and K4 vs their plain versions, ||got - ref|| / ||ref|| per gradient.
# f32: summation order only. bf16: P and dS rounded to bf16 as product
# operands (K3: D from the bf16 output), each gradient rounded to bf16.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOGITS_F32_ATOL = 1e-3                  # card f32 vs CPU f32, 24 + 12 layers
GRADS_F32_RTOL = 1e-3                   # the same, for the gradients
# The ablation arms that compute softmax attention (each rounding P at its
# own place) against the production arm's output after 24 bf16 blocks,
# ||arm - production|| / ||production||.
ABLATION_SAME = ("packed full", "packed nostage", "scratch", "bhne")
ABLATION_RTOL = 2e-2
DOTS_BF16_RTOL = 2 ** -8                # P4 dotsonly, ||err|| / ||ref||
# heads: card f32 gradients against the CPU's, ||err|| / ||ref|| per leaf,
# with ||ref|| taken as at least HEAD_FLOOR of the head's largest gradient
# norm: a leaf whose gradient is zero (the attention key bias) or cancels
# to a small remainder (the one-head SuperGAT's attention vectors) holds
# float noise of the size of the head's larger sums
HEAD_GRAD_RTOL = 1e-4
HEAD_FLOOR = 1e-3
HEAD_MODALITIES = ("language", "video", "audio")
# distill: the teacher against its update rule, per element within
# EMA_ULPS units of f32 rounding of the rule's terms, old * decay and
# student * (1 - decay) (the step's fused multiply-add and the check's
# separate products round differently by about one unit). Taking the EMA
# toward the student before its Adam step instead would be off by about
# (1 - decay) x lr = 1e-7, some 20 units at the head's |t| ~ 0.05.
EMA_ULPS = 4
SWEEP_TYPES = ("language", "image", "mixed")
SWEEP_RATIOS = (0.1, 0.5, 0.9)
SWEEP_ROWS = 101                        # a batch of 64 and a partial of 37
SWEEP_TRAIN_ROWS = 2 * B
# data: a mvsa-style tree on disk, its photos at the shapes of real MVSA
# photos; 10 loaders a missing type (the nine ratios and the complete set)
DATA_SPLITS = {"train": 2 * B, "valid": B, "test": 2 * B + 8}
DATA_SIZES = ((375, 500), (480, 640), (720, 1280), (500, 333))
DATA_WORKERS = 8                        # the card machine's cores
# card against CPU: the images and the device transforms as
# tests/test_host_transforms.py:35-56 holds the JAX package's two transform
# paths to each other; the audio model input as its line 77 does
DATA_TOL = dict(atol=2e-4, rtol=1e-4)
AUDIO_TOL = dict(atol=2e-3, rtol=1e-4)
# batches a path's launch counts cover, where they are not STEPS steps
COVERS = {"distill KL_stu": 1, "distill self_distill": 1,
          "sweep": (len(SWEEP_TYPES) * len(SWEEP_RATIOS) * -(-SWEEP_ROWS // B)
                    + SWEEP_TRAIN_ROWS // B),
          "data sweep": (len(SWEEP_TYPES) * 10 * -(-DATA_SPLITS["test"] // B)
                         + DATA_SPLITS["train"] // B),
          "data train": DATA_SPLITS["train"] // B}
# cli: the entry points at the flagship's full width, B=16 (8 train steps
# and 4 val batches an epoch on DATA_SPLITS); the converter on the committed
# fixtures against the reference towers' features at
# tests/test_checkpoint_fixture.py:61's tolerances
CLI_SCALE = "large"
CLI_BATCH = 16
CLI_CHILD_TIMEOUT = 600                 # s, each cli.train subprocess
CONVERT_TOL = dict(atol=5e-5, rtol=2e-4)
# --uint8_upload: the first step's bf16 loss against the f32 upload's
# (GRAD_TOL's bf16 bound; the rounding moves an input by at most 0.5/255 of
# its range, under bf16's own rounding of the normalised input)
U8_LOSS_RTOL = 2e-2
PREDICT_CONF_ATOL = 1e-2                # cli.predict over ranks, bf16
PREDICT_LAYOUTS = {"DP 2": [], "TP 2": ["--mesh_model", "2"]}
COVERS.update({
    "cli train": 2 * (DATA_SPLITS["train"] // CLI_BATCH
                      + DATA_SPLITS["valid"] // CLI_BATCH),
    "cli resume": (DATA_SPLITS["train"] // CLI_BATCH
                   + DATA_SPLITS["valid"] // CLI_BATCH),
    "cli test": 30 * -(-DATA_SPLITS["test"] // 64),
    "cli predict": -(-DATA_SPLITS["test"] // 64),
    # one uint8 epoch; the mixed type's sweep; both ranks' batches
    "cli train --uint8_upload": (DATA_SPLITS["train"] // CLI_BATCH
                                 + DATA_SPLITS["valid"] // CLI_BATCH),
    "cli test --uint8_upload": 10 * -(-DATA_SPLITS["test"] // 64),
    "cli predict DP 2": 2 * -(-(DATA_SPLITS["test"] // 2) // 32),
    "cli predict TP 2": 2 * -(-DATA_SPLITS["test"] // 64)})
# remat: bench.py's train policy and train3 spec (bench.py:142, 208-210);
# a named policy's gradients against no remat's on the card, f32 without
# TF32: the same kernels on the same inputs, so only a changed summation
# would show
REMAT_BENCH = "save_attn_mlp_qkv_kern"
REMAT_TRAIN3 = (("video", "save_attn_mlp_qkv"), ("audio", "save_attn_mlp_kern"),
                ("language", "save_attn_mlp"))
REMAT_GRAD_RTOL = 1e-5
# export: the artifact against the Predictor on the same params and inputs
# (the same ops, traced; bf16 encoder, f32 probs)
EXPORT_PROBS_ATOL = 1e-6
EXPORT_BATCHES = 5                      # timed predict_arrays calls an arm
TOWERS_B = 2                            # towers: videos of the tube-3D case
COVERS.update({
    "remat policies": 9, "remat cli": (DATA_SPLITS["train"] // CLI_BATCH
                                       + DATA_SPLITS["valid"] // CLI_BATCH),
    "export artifact": 4, "export cli": -(-DATA_SPLITS["test"] // B),
    "towers tube3d": 1, "towers 7-D": 1,
    # parallel: one step of each rank of each world, summed
    "parallel": 1})
RATES = {}                              # samples/s by timed_train's name


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def no_tf32():
    """f32 products in full f32 (the reference checks), then the settings
    as they were."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def spread_ms(fn, reps=7, iters=20) -> tuple:
    """(min, median, max) ms a call over `reps` repeats of `iters` calls
    between CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return min(times), statistics.median(times), max(times)


def median_ms(fn, reps=7, iters=20) -> float:
    return spread_ms(fn, reps, iters)[1]


def device_profile(fn, calls=5, sessions=3) -> list:
    """[(kernel name, device ms a call)] of fn, the longest first: one
    untraced call, then `calls` traced by torch.profiler. A session whose
    trace holds no device event (the tracer delivered none) is taken again,
    up to `sessions` times; then it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.device_time_total > 0]
        if events:
            return [(e.key, e.device_time_total / 1e3 / calls)
                    for e in sorted(events, key=lambda e: -e.device_time_total)]
    raise RuntimeError(f"torch.profiler traced no device time in {sessions} "
                       "sessions")


def yardstick(row, kernel, library, label):
    """Time the library call (`library_ms` its median, the spread beside
    it); read the device time by kernel of the kernel's and the library's
    call from the profiler; print the row: kernel, plain and library
    times, the kernel/library ratio and the share of the bound."""
    lo, med, hi = spread_ms(library)
    row["library_ms"] = med
    row["library_spread_ms"] = [lo, med, hi]
    row["device_ms"] = {k: t for k, t in device_profile(kernel)}
    row["library_device_ms"] = {k[:80]: t for k, t in device_profile(library)}
    row["vs_library"] = row["ms"] / med
    row["device_vs_library"] = (sum(row["device_ms"].values())
                                / sum(row["library_device_ms"].values()))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    lib_kernel = next(iter(row["library_device_ms"]))
    print(f"kernel {row['name']} [{row['shape']}]: bf16 kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, {label} "
          f"{med:.4f} ms (min {lo:.4f}, max {hi:.4f}; {lib_kernel[:60]}), "
          f"kernel/library {row['vs_library']:.3f}, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{100 * row['bound_share']:.1f} % of it", flush=True)
    print(f"  device ms a call: kernel "
          f"{sum(row['device_ms'].values()):.4f} "
          f"{[(k[:48], round(t, 4)) for k, t in row['device_ms'].items()]}; "
          f"{label} {sum(row['library_device_ms'].values()):.4f} "
          f"{[(k[:48], round(t, 4)) for k, t in row['library_device_ms'].items()]}"
          f"; kernel/library {row['device_vs_library']:.3f}", flush=True)


def text_batch(rng, batch, vary_length):
    """Token ids laid out as bench.py lays them out (SOT, random tokens, EOT
    repeated to 77) and the attention mask that covers SOT..first EOT."""
    ids = np.full((batch, 77), 49407, np.int64)
    ids[:, 0] = 49406
    lengths = (rng.integers(2, 77, size=batch) if vary_length
               else np.full(batch, 12))
    for i, n in enumerate(lengths):
        ids[i, 1:n] = rng.integers(1, 40000, size=n - 1)
    mask = (np.arange(77)[None] <= lengths[:, None]).astype(np.int64)
    return ids, mask


DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))


def forward_check(dev, gen, label, b, n, heads, run, plain, recorded,
                  counter):
    """A forward wrapper against its plain version on seeded [b, n, heads*64]
    inputs, in f32 and bf16: {"max_abs_err_f32": .., "max_abs_err_bf16": ..}.
    With `recorded` the inputs require grad, so autograd records the call as
    the train step's does (K1 then writes the log-sum-exp). Each call must
    launch once, counted under `counter` and nowhere else."""
    from missm_tpu_torch.kernels import attention as K

    errs = {"shape": f"B={b} N={n} H={heads} hd=64", "recorded": recorded}
    for dtype, tag in DTYPES:
        q, k, v = (torch.randn(b, n, heads * 64, generator=gen, device=dev)
                   .to(dtype).requires_grad_(recorded) for _ in range(3))
        before = dict(K.LAUNCHES)
        got = run(q, k, v)
        via = {name: K.LAUNCHES[name] - before[name] for name in before}
        with torch.no_grad():
            ref = plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        atol, rtol = TOL[dtype]
        bad = err > atol + rtol * ref.float().abs()
        if (bad.any() or not torch.isfinite(got).all()
                or recorded != (got.grad_fn is not None)
                or via != dict(dict.fromkeys(via, 0), **{counter: 1})):
            raise AssertionError(f"{label} {tag}: kernel disagrees with the "
                                 f"plain version, max abs err "
                                 f"{err.max().item():.3e}, grad_fn "
                                 f"{got.grad_fn}, launches {via}")
        errs[f"max_abs_err_{tag}"] = err.max().item()
    print(f"check {label} [{errs['shape']}, recorded={recorded}]: max abs err "
          f"f32 {errs['max_abs_err_f32']:.2e} bf16 "
          f"{errs['max_abs_err_bf16']:.2e}", flush=True)
    return errs


def summarise_checks(row):
    """The row's errors per type: the largest over its paths' checks."""
    for _, tag in DTYPES:
        row[f"max_abs_err_{tag}"] = max(c[f"max_abs_err_{tag}"]
                                        for c in row["checks"].values())
    row["max_abs_err"] = row["max_abs_err_bf16"]


def kernel_phase(dev, rng):
    """Every kernel at the shapes and template variants each path gives it:
    eval K1 (no log-sum-exp) and K2(a) with the key bias at B=64; train K1
    (recorded, writing the log-sum-exp), K3 through autograd and K2(a)
    causal without a key bias at B=16; eval3 K2(a) without a key bias at
    B=16, K2(b) at [16, 593] and K2(c) at [16*257, 8]; train3, all
    recorded, K1 and K3 at [64, 257], K2(b) and K4 unmasked at [8, 593],
    K2(c) and K4 block-diagonal at [8*257, 8] and K2(a) without a key bias
    at B=8; distill K1 without the log-sum-exp at B=16 (the teacher's
    no-grad forward; its K2(a) is eval3's shape, its recorded student
    train's). The sweep's K1 and K2(a) shapes are eval's. Times each at the
    shape of the path it is named for (K1 and K2(a): eval)."""
    from missm_tpu_torch.kernels import attention as K

    neg = torch.finfo(torch.float32).min
    b_train = B // ACCUM
    _, mask = text_batch(rng, B, vary_length=True)
    kbias = torch.where(torch.as_tensor(mask, device=dev)[:, None, :] == 0,
                        neg, 0.0).float().contiguous()
    flash = "missm_tpu/kernels/flash_attention.py"
    # ids without a mask (the train and eval3 batches): causal, no key bias
    causal_ids = dict(
        run=lambda q, k, v: K.causal_attention(q, k, v, None, 12),
        plain=lambda q, k, v: K.attention_plain(q, k, v, 12, causal=True))
    specs = [
        dict(name="attention", path="eval", b=B, n=257, heads=16, kbias=None,
             replaces=f"{flash}:352 (fused_attention_cls)",
             run=lambda q, k, v: K.attention(q, k, v, 16),
             plain=lambda q, k, v: K.attention_plain(q, k, v, 16),
             # the video tower's spatial attention: 16 videos x 8 frames;
             # the distillation teacher's no-grad forward per microbatch
             more={"eval3": dict(b=B3 * FRAMES, recorded=False),
                   "distill": dict(b=b_train, recorded=False)}),
        dict(name="causal_attention", path="eval", b=B, n=77, heads=12,
             kbias=kbias,
             replaces=f"{flash}:277 (fused_attention, causal=True, kbias)",
             run=lambda q, k, v: K.causal_attention(q, k, v, kbias, 12),
             plain=lambda q, k, v: K.attention_plain(
                 q, k, v, 12, causal=True, kbias=kbias),
             more={"train": dict(causal_ids, b=b_train, recorded=True),
                   "eval3": dict(causal_ids, b=B3, recorded=False),
                   "train3": dict(causal_ids, b=B3T, recorded=True)}),
        dict(name="attention_unsplit", path="eval3", b=B3, n=593, heads=16,
             kbias=None,
             replaces=f"{flash}:277 (fused_attention, unmasked, through "
                      f"fused_attention_ad)",
             run=lambda q, k, v: K.attention(q, k, v, 16),
             plain=lambda q, k, v: K.attention_plain(q, k, v, 16)),
        dict(name="short_attention", path="eval3", b=B3 * 257, n=FRAMES,
             heads=16, kbias=None, source="short_attention.cu",
             replaces=f"{flash}:277 (fused_attention, block_diag=8, through "
                      f"missm_tpu/ops/attention.py:176 short_attention)",
             run=lambda q, k, v: K.short_attention(q, k, v, 16),
             plain=lambda q, k, v: K.short_attention_plain(q, k, v, 16)),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for s in specs:
        b, n, heads, hd = s["b"], s["n"], s["heads"], 64
        d = heads * hd
        row = {"name": s["name"], "route": "cuda",
               "source": "missm_tpu_torch/csrc/"
                         + s.get("source", "attention.cu"),
               "replaces": s["replaces"],
               "shape": f"B={b} N={n} H={heads} hd={hd}",
               "checks": {s["path"]: forward_check(
                   dev, gen, f"{s['name']} {s['path']}", b, n, heads,
                   s["run"], s["plain"], recorded=False, counter=s["name"])}}
        for path, c in s.get("more", {}).items():
            row["checks"][path] = forward_check(
                dev, gen, f"{s['name']} {path}", c["b"], n, heads,
                c.get("run", s["run"]), c.get("plain", s["plain"]),
                recorded=c["recorded"], counter=s["name"])

        # timing, bf16 (the main path's type), at the named path's shape
        io_bytes = 4 * b * n * d * 2 + (0 if s["kbias"] is None else b * n * 4)
        copies = max(1, math.ceil(2 * L2_BYTES / io_bytes))
        sets = [[torch.randn(b, n, d, generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(3)] for _ in range(copies)]
        cyc = itertools.cycle(sets)
        row["ms"] = median_ms(lambda: s["run"](*next(cyc)))
        row["plain_ms"] = median_ms(lambda: s["plain"](*next(cyc)))
        mask4 = None
        if s["kbias"] is not None:
            mask4 = (torch.full((n, n), neg, device=dev).triu(1)[None, None]
                     + s["kbias"][:, :, None, :]).to(torch.bfloat16)

        def library(q, k, v):
            def heads_first(t):
                return t.view(b, n, heads, hd).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                heads_first(q), heads_first(k), heads_first(v),
                attn_mask=mask4)
        if s["name"] != "short_attention":
            # what the bf16 kernel's tiles compute per (batch, head)
            p = K.plan(n, hd, causal=s["kbias"] is not None)
            row["scores_per_head"] = p.scores
            row["exponentials_per_head"] = p.exponentials

        # the least time: each input read once and the output written once,
        # against the score and P.V products this run's data needs (causal:
        # the keys at or before each query that are not padded; short: the
        # T x T pairs within each instance)
        if s["kbias"] is None:
            pairs = b * heads * n * n
        else:
            valid = (s["kbias"][:, 0, :] == 0).double()          # [B, N]
            pairs = heads * valid.cumsum(-1).sum().item()
        flops = 4 * pairs * hd
        row["bound_ms"], row["bound_by"] = bound(io_bytes, flops)
        yardstick(row, lambda: s["run"](*next(cyc)),
                  lambda: library(*next(cyc)), "sdpa")
        del sets, cyc
        rows.append(row)
    by_name = {row["name"]: row for row in rows}
    for spec in backward_specs():
        rows.append(backward_row(dev, gen, spec, by_name[spec["forward"]]))
    rows += [ln_linear_row(dev, gen), mlp_bwd_row(dev, gen)]
    rows += probe_rows(dev, gen)
    op_host_us(dev, gen, rows)
    for row in rows:
        summarise_checks(row)
    return rows


def op_host_us(dev, gen, rows, calls=300):
    """Host microseconds a call of each `missm` custom op against a direct
    call of the `_launch` it wraps, at small shapes (one batch row, so the
    card keeps up with the host): the min over two turns of `calls` calls
    each, op and launch in turns (op, launch, launch, op). Adds
    "host_us_op" and "host_us_launch" to the rows of the kernels each op
    launches."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.kernels import ln_linear as lnl

    def qkv(b, n, d):
        return [torch.randn(b, n, d, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(4)]

    q, k, v, g = qkv(1, 257, 1024)
    out, lse = K._launch(q, k, v, None, 16, causal=False, want_lse=True)
    tq, tk, tv, tg = qkv(1, 77, 768)
    sq, sk, sv, sg = qkv(257, FRAMES, 1024)
    x, ln, lin = ln_inputs(dev, gen, 128, 1024, 4096, torch.bfloat16, True)
    ops = {
        "attention": (
            lambda: torch.ops.missm.attention(q, k, v, 16, False),
            lambda: K._launch(q, k, v, None, 16, causal=False)),
        "attention_bwd": (
            lambda: torch.ops.missm.attention_bwd(q, k, v, out, lse, g, 16),
            lambda: K._launch_bwd(q, k, v, out, lse, g, 16)),
        "causal_attention": (
            lambda: torch.ops.missm.causal_attention(tq, tk, tv, None, 12),
            lambda: K._launch(tq, tk, tv, None, 12, causal=True)),
        "short_attention": (
            lambda: torch.ops.missm.short_attention(sq, sk, sv, 16),
            lambda: K._launch_short(sq, sk, sv, 16)),
        "short_attention_bwd": (
            lambda: torch.ops.missm.short_attention_bwd(sq, sk, sv, sg, 16),
            lambda: K._launch_short_bwd(sq, sk, sv, sg, 16)),
        "ln_linear": (
            lambda: torch.ops.missm.ln_linear(x, ln["scale"], ln["bias"],
                                              lin["w"], lin["b"], 1e-5),
            lambda: lnl._launch(x, ln["scale"], ln["bias"], lin["w"],
                                lin["b"], 1e-5))}
    per_row = {"attention": "attention", "attention_unsplit": "attention",
               "attention_bwd": "attention_bwd",
               "attention_unsplit_bwd": "attention_bwd",
               "causal_attention": "causal_attention",
               "short_attention": "short_attention",
               "short_attention_bwd": "short_attention_bwd",
               "ln_linear": "ln_linear"}
    result = {}
    for name, (op, launch) in ops.items():
        times = {"op": [], "launch": []}
        for arm in ("op", "launch", "launch", "op"):
            fn = op if arm == "op" else launch
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[arm].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        result[name] = (min(times["op"]), min(times["launch"]))
        print(f"host us a call: missm::{name} {result[name][0]:.2f}, its "
              f"_launch {result[name][1]:.2f} (+{result[name][0] - result[name][1]:.2f})",
              flush=True)
    for row in rows:
        if row["name"] in per_row:
            row["host_us_op"], row["host_us_launch"] = result[
                per_row[row["name"]]]
    return result


def bound(io_bytes, flops):
    """(the least time in ms, what bounds it): the bytes at the card's memory
    rate against the operations at its bf16 tensor-core rate."""
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ln_inputs(dev, gen, m, d, f, dtype, bias):
    """Seeded x [m, d] and the ln2 / fc1 params of one block at the model's
    init scale (fc1 std (2d)^-0.5), all of `dtype`."""
    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)
    ln = {"scale": randn(d, scale=0.1, shift=1.0), "bias": randn(d, scale=0.1)}
    lin = {"w": randn(d, f, scale=(2 * d) ** -0.5)}
    if bias:
        lin["b"] = randn(f, scale=0.1)
    return randn(m, d, scale=2.0, shift=0.5), ln, lin


def ln_linear_row(dev, gen):
    """K5 through its wrapper at the ln2fc1 paths' shapes: eval image
    [64*257, 1024] -> 4096 with the bias, eval text [64*77, 768] -> 3072
    without it (the kernel's other variant), and the train microbatch's
    image [16*257, 1024] and ragged text [16*77, 768] rows, recorded, with
    the gradient of every input through torch.autograd.grad (the plain
    backward) against autograd of the plain version in f32. Each forward
    must launch K5 once. Timed at the eval image shape through `yardstick`
    against F.layer_norm + F.linear, with kernels/ln_linear.py::plan's
    grid, tiles, cluster, stages and shared memory."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.kernels import ln_linear as lnl

    tower = flagship_config("bfloat16").towers[0][1]
    image = (tower.vision.seq_len, tower.vision.hidden_size,
             tower.vision.intermediate_size)
    text = (tower.text.max_position_embeddings, tower.text.hidden_size,
            tower.text.intermediate_size)
    b = B // ACCUM
    cases = {"ln2fc1 eval image": (B * image[0], *image[1:], True, False),
             "ln2fc1 eval text": (B * text[0], *text[1:], False, False),
             "ln2fc1 train image": (b * image[0], *image[1:], True, True),
             "ln2fc1 train text": (b * text[0], *text[1:], True, True)}
    timed = cases["ln2fc1 eval image"][:3]
    row = {"name": "ln_linear", "route": "cuda",
           "source": "missm_tpu_torch/csrc/ln_linear.cu",
           "replaces": "missm_tpu/kernels/ln_linear.py:64 "
                       "(_ln_linear_fwd_pallas, pallas_call at 92)",
           "shape": "M={} D={} F={} bias".format(*timed), "checks": {}}
    for path, (m, d, f, bias, recorded) in cases.items():
        check = row["checks"][path] = {"shape": f"M={m} D={d} F={f} "
                                                f"bias={bias}"}
        for dtype, tag in DTYPES:
            x, ln, lin = ln_inputs(dev, gen, m, d, f, dtype, bias)
            leaves = [x, ln["scale"], ln["bias"], *lin.values()]
            for t in leaves:
                t.requires_grad_(recorded)
            before = dict(K.LAUNCHES)
            with no_tf32():
                got = lnl.ln_linear(x, ln, lin)
                via = {k: K.LAUNCHES[k] - before[k] for k in before}
                with torch.no_grad():
                    ref = lnl.ln_linear_plain(x, ln, lin)
                torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            atol, rtol = TOL[dtype]
            if ((err > atol + rtol * ref.float().abs()).any()
                    or not torch.isfinite(got).all()
                    or via != dict(dict.fromkeys(via, 0), ln_linear=1)):
                raise AssertionError(f"ln_linear {path} {tag}: kernel disagrees "
                                     f"with the plain version, max abs err "
                                     f"{err.max().item():.3e}, launches {via}")
            check[f"max_abs_err_{tag}"] = err.max().item()
            if recorded:
                g = torch.randn(m, f, generator=gen, device=dev)
                with no_tf32():
                    grads = torch.autograd.grad(got, leaves, g.to(dtype))
                    ref_leaves = [t.detach().float().requires_grad_()
                                  for t in leaves]
                    ref_out = lnl.ln_linear_plain(
                        ref_leaves[0], {"scale": ref_leaves[1],
                                        "bias": ref_leaves[2]},
                        dict(zip(lin, ref_leaves[3:])))
                    ref_grads = torch.autograd.grad(ref_out, ref_leaves, g)
                rel = max(((a.float() - r).norm() / r.norm()).item()
                          for a, r in zip(grads, ref_grads))
                if not (rel <= GRAD_TOL[dtype]
                        and all(torch.isfinite(a).all() for a in grads)):
                    raise AssertionError(f"ln_linear backward {path} {tag}: "
                                         f"relative error {rel:.3e} (limit "
                                         f"{GRAD_TOL[dtype]})")
                check[f"grad_rel_err_{tag}"] = rel
            del x, ln, lin, leaves, got, ref
        print(f"check ln_linear {path} [{check['shape']}]: max abs err f32 "
              f"{check['max_abs_err_f32']:.2e} bf16 "
              f"{check['max_abs_err_bf16']:.2e}"
              + (f"; gradients rel err f32 {check['grad_rel_err_f32']:.2e} "
                 f"bf16 {check['grad_rel_err_bf16']:.2e}"
                 if recorded else ""), flush=True)

    # timing, bf16, at the eval image shape (176.8 MB of inputs and output:
    # larger than L2 without copies)
    m, d, f = timed
    x, ln, lin = ln_inputs(dev, gen, m, d, f, torch.bfloat16, True)
    row["ms"] = median_ms(lambda: lnl.ln_linear(x, ln, lin))
    row["plain_ms"] = median_ms(lambda: lnl.ln_linear_plain(x, ln, lin))
    row["bound_ms"], row["bound_by"] = bound((m * d + d * f + m * f + 2 * d + f)
                                             * 2, 2 * m * d * f)
    p = lnl.plan(m, d, f)
    row["plan"] = {"grid": p.grid, "row_tile": lnl.ROWS, "col_tile": p.bn,
                   "cluster": p.groups, "col_tiles_per_block":
                   len(p.col_tiles(0)), "stages": p.stages,
                   "smem_bytes": p.smem_bytes}
    print(f"  plan ln_linear: {p.grid} blocks in clusters of {p.groups}, "
          f"row tiles of {lnl.ROWS}, {len(p.col_tiles(0))} column tiles of "
          f"{p.bn} a block, {p.stages} stages, {p.smem_bytes} bytes of shared "
          f"memory", flush=True)
    yardstick(row, lambda: lnl.ln_linear(x, ln, lin),
              lambda: torch.nn.functional.linear(
                  torch.nn.functional.layer_norm(x, (d,), ln["scale"],
                                                 ln["bias"]),
                  lin["w"].t(), lin["b"]), "F.layer_norm + F.linear")
    return row


def mlp_inputs(dev, gen, m, d, ff, dtype):
    """Seeded dy [m, d], wide [m, ff], w1 [d, ff], w2 [ff, d] at the probe's
    scales."""
    return [(torch.randn(*shape, generator=gen, device=dev) * s).to(dtype)
            for shape, s in (((m, d), 1.0), ((m, ff), 0.5), ((d, ff), 0.02),
                             ((ff, d), 0.02))]


def mlp_bwd_row(dev, gen):
    """K6 through its wrapper at the probe's shape [16448, 1024, 4096]
    against its plain version in f32 and bf16 (one launch each), timed in
    bf16 through `yardstick` against the library chain (cuBLAS writing
    dwide in f32, the derivative, cuBLAS again), with the device time of
    the chain's two products alone beside it and kernels/mlp_bwd.py::plan's
    grid, cluster, waves, stages and shared memory."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.kernels import mlp_bwd
    from missm_tpu_torch.ops.basic import matmul_f32
    from missm_tpu_torch.probes import mlp_bwd_probe

    m, d, ff = mlp_bwd_probe.M, mlp_bwd_probe.D, mlp_bwd_probe.FF
    row = {"name": "mlp_bwd_dx", "route": "cuda",
           "source": "missm_tpu_torch/csrc/mlp_bwd.cu",
           "replaces": "missm_tpu/kernels/mlp_bwd.py:73 (mlp_bwd_dx, "
                       "pallas_call at 87)",
           "shape": f"M={m} D={d} FF={ff}", "checks": {}}
    check = row["checks"]["probes"] = {"shape": row["shape"]}
    for dtype, tag in DTYPES:
        args = mlp_inputs(dev, gen, m, d, ff, dtype)
        before = dict(K.LAUNCHES)
        with no_tf32():
            got = mlp_bwd.mlp_bwd_dx(*args)
            via = {k: K.LAUNCHES[k] - before[k] for k in before}
            ref = mlp_bwd.mlp_bwd_dx_plain(*args)
            torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        atol, rtol = TOL[dtype]
        if ((err > atol + rtol * ref.float().abs()).any()
                or not torch.isfinite(got).all()
                or via != dict(dict.fromkeys(via, 0), mlp_bwd_dx=1)):
            raise AssertionError(f"mlp_bwd_dx {tag}: kernel disagrees with "
                                 f"the plain version, max abs err "
                                 f"{err.max().item():.3e}, launches {via}")
        check[f"max_abs_err_{tag}"] = err.max().item()
        del args, got, ref
    print(f"check mlp_bwd_dx [{row['shape']}]: max abs err f32 "
          f"{check['max_abs_err_f32']:.2e} bf16 "
          f"{check['max_abs_err_bf16']:.2e}", flush=True)

    dy, wide, w1, w2 = mlp_inputs(dev, gen, m, d, ff, torch.bfloat16)

    def library():
        dwide = matmul_f32(dy, w2.t())  # torch.mm(..., out_dtype=f32)
        dwide = dwide * mlp_bwd.quick_gelu_grad(wide.float())
        return torch.mm(dwide.to(dy.dtype), w1.t())

    dwide_bf16 = (matmul_f32(dy, w2.t())
                  * mlp_bwd.quick_gelu_grad(wide.float())).to(dy.dtype)

    def products():
        # the chain's two products alone: what the kernel's GEMM half does
        return matmul_f32(dy, w2.t()), torch.mm(dwide_bf16, w1.t())

    row["ms"] = median_ms(lambda: mlp_bwd.mlp_bwd_dx(dy, wide, w1, w2))
    row["plain_ms"] = median_ms(lambda: mlp_bwd.mlp_bwd_dx_plain(dy, wide,
                                                                 w1, w2))
    row["bound_ms"], row["bound_by"] = bound(
        (2 * m * d + m * ff + 2 * d * ff) * 2, 4 * m * d * ff)
    p = mlp_bwd.plan(m, d, ff)
    row["plan"] = {"grid": p.grid, "tile": [p.rows, p.cluster],
                   "cluster": p.cluster, "out_cols_per_block": p.nout,
                   "ff_steps": p.steps, "waves": p.waves, "stages": p.stages,
                   "smem_bytes": p.smem_bytes}
    print(f"  plan mlp_bwd_dx: {p.grid} blocks in clusters of {p.cluster} "
          f"on {p.rows} rows, {p.nout} output columns a block, {p.steps} FF "
          f"steps of {p.cluster * mlp_bwd.DEPTH}, {p.waves} waves, "
          f"{p.stages} stages, {p.smem_bytes} bytes of shared memory",
          flush=True)
    yardstick(row, lambda: mlp_bwd.mlp_bwd_dx(dy, wide, w1, w2), library,
              "cuBLAS chain")
    row["chain_products_device_ms"] = {k[:80]: t for k, t in
                                       device_profile(products)}
    total = sum(row["chain_products_device_ms"].values())
    row["device_vs_chain_products"] = (sum(row["device_ms"].values())
                                       / total)
    print(f"  device ms a call of the chain's two products alone: "
          f"{total:.4f} "
          f"{[(k[:48], round(t, 4)) for k, t in row['chain_products_device_ms'].items()]}"
          f"; kernel/products {row['device_vs_chain_products']:.3f}",
          flush=True)
    del dwide_bf16
    return row


def probe_check(dev, gen, label, shape, run, plain, counter,
                unnormalised=False):
    """A forward-only probe wrapper against its plain version on seeded
    inputs of `shape`, in f32 and bf16, each call launching once under
    `counter` and nowhere else. `unnormalised` (P4 dotsonly, whose outputs
    are sums of s v, ~100 here): f32 within 1e-4 of the output's scale, and
    bf16 within DOTS_BF16_RTOL in norm, since where the two f32 scores
    straddle a bf16 rounding boundary e = s rounds one way in each and the
    output moves by one ulp of s times v, more than TOL's atol."""
    from missm_tpu_torch.kernels import attention as K

    check = {"shape": "x".join(map(str, shape))}
    for dtype, tag in DTYPES:
        q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        before = dict(K.LAUNCHES)
        with torch.no_grad():
            got = run(q, k, v)
            via = {name: K.LAUNCHES[name] - before[name] for name in before}
            ref = plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        atol, rtol = TOL[dtype]
        if unnormalised:
            scale = max(1.0, ref.float().abs().max().item())
            rel = (err.norm() / ref.float().norm()).item()
            check[f"rel_err_{tag}"] = rel
            bad = (err.max().item() > atol * scale if dtype == torch.float32
                   else rel > DOTS_BF16_RTOL)
        else:
            bad = (err > atol + rtol * ref.float().abs()).any()
        if (bad or not torch.isfinite(got).all()
                or via != dict(dict.fromkeys(via, 0), **{counter: 1})):
            raise AssertionError(f"{label} {tag}: kernel disagrees with the "
                                 f"plain version, max abs err "
                                 f"{err.max().item():.3e}, launches {via}")
        check[f"max_abs_err_{tag}"] = err.max().item()
        del q, k, v, got, ref, err
    print(f"check {label} [{check['shape']}]: max abs err f32 "
          f"{check['max_abs_err_f32']:.2e} bf16 {check['max_abs_err_bf16']:.2e}",
          flush=True)
    return check


def probe_rows(dev, gen):
    """The timing probes' kernels (csrc/probe_attention.cu) through their
    wrappers at the probes' shapes: P1 [1024, 257, 64] head-major, P2 [64,
    16, 257, 64], P3 and each mode of P4 [64, 257, 16*64]; each against its
    plain version in f32 and bf16, timed in bf16 against the plain version
    and SDPA through `yardstick` (none for noexp and dotsonly, which no
    PyTorch call computes: their kernel's device time alone), with
    kernels/probe_attention.py::plan's tiles. The bound: q, k and v read
    and the output written once (134.7 MB) against 4 N^2 hd FLOP per
    (batch, head) slice (17.3 GFLOP)."""
    from missm_tpu_torch.kernels import probe_attention as pa
    from missm_tpu_torch.probes import ablation_probe, attn_probe

    cfg = ablation_probe.config()
    b, n, heads = ablation_probe.B, cfg.seq_len, cfg.num_heads
    hd = cfg.hidden_size // heads
    tokens = (b, n, heads * hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_tokens(q, k, v):
        def heads_first(t):
            return t.view(b, n, heads, hd).transpose(1, 2)
        return sdpa(heads_first(q), heads_first(k), heads_first(v))

    script = "scripts/ablation_probe.py"
    specs = [
        dict(name="attn_probe_fused", shape=(attn_probe.BH, attn_probe.N,
                                             attn_probe.HD),
             replaces="scripts/attn_probe.py:47 (make_fused, pallas_call at "
                      "73)",
             run=pa.attn_probe_fused, plain=pa.rows_attention_plain,
             library=attn_probe.sdpa, kernel="rows"),
        dict(name="tower_bhne", shape=(b, heads, n, hd),
             replaces=f"{script}:84 (make_tower_bhne, pallas_call at 112)",
             run=pa.tower_bhne, plain=pa.rows_attention_plain, library=sdpa,
             kernel="rows"),
        dict(name="tower_scratch", shape=tokens,
             replaces=f"{script}:152 (make_tower_scratch, pallas_call at "
                      f"183)",
             run=lambda q, k, v: pa.tower_scratch(q, k, v, heads),
             plain=lambda q, k, v: pa.rows_attention_plain(
                 q, k, v, layout="tokens", num_heads=heads),
             library=sdpa_tokens, kernel="scratch"),
        *[dict(name=f"tower_packed_debug[{mode}]", counter="tower_packed_debug",
               arm=f"packed {mode}", shape=tokens,
               unnormalised=mode == "dotsonly",
               replaces=f"{script}:210 (make_tower_packed_debug, mode "
                        f"{mode!r}, pallas_call at 291)",
               run=lambda q, k, v, mode=mode: pa.tower_packed_debug(
                   q, k, v, heads, mode),
               plain=lambda q, k, v, mode=mode: pa.packed_attention_plain(
                   q, k, v, heads, mode),
               library=sdpa_tokens if mode in ("full", "nostage") else None,
               kernel="nostage" if mode == "nostage" else "rows",
               mode="full" if mode == "nostage" else mode)
          for mode in pa.MODES],
    ]
    rows = []
    for s in specs:
        counter = s.get("counter", s["name"])
        row = {"name": s["name"], "route": "cuda",
               "source": "missm_tpu_torch/csrc/probe_attention.cu",
               "replaces": s["replaces"], "shape": "x".join(map(str, s["shape"])),
               "checks": {"probes": probe_check(
                   dev, gen, s["name"], s["shape"], s["run"], s["plain"],
                   counter, s.get("unnormalised", False))}}
        for key in ("counter", "arm"):
            if key in s:
                row[key] = s[key]
        q, k, v = (torch.randn(*s["shape"], generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        row["ms"] = median_ms(lambda: s["run"](q, k, v))
        row["plain_ms"] = median_ms(lambda: s["plain"](q, k, v))
        slices = q.numel() // (n * hd)
        row["bound_ms"], row["bound_by"] = bound(4 * q.numel() * 2,
                                                 4 * slices * n * n * hd)
        p = pa.plan(n, s["kernel"], slices=slices, mode=s.get("mode", "full"))
        row["plan"] = {"kernel": p.kernel, "warpgroups": p.warpgroups,
                       "grid": p.grid, "query_tiles": list(p.rows),
                       "key_tiles": list(p.cols), "passes": p.passes,
                       "smem_bytes": p.smem_bytes,
                       "scores_per_slice": p.scores}
        print(f"  plan {s['name']}: {p.kernel} kernel, {p.grid} blocks of "
              f"{p.warpgroups} warpgroup(s), {len(p.rows)} query tiles "
              f"(last {p.rows[-1]}), key tiles "
              f"{[w for _, w in p.cols]}, {p.passes} pass(es), "
              f"{p.smem_bytes} bytes of shared memory", flush=True)
        if s["library"] is None:
            row["library_ms"] = None
            row["library"] = "none: no PyTorch call computes this function"
            row["device_ms"] = dict(device_profile(lambda: s["run"](q, k, v)))
            row["bound_share"] = row["bound_ms"] / row["ms"]
            print(f"kernel {s['name']} [{row['shape']}]: bf16 kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"library none, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {100 * row['bound_share']:.1f} % of "
                  f"it; device ms a call "
                  f"{sum(row['device_ms'].values()):.4f}", flush=True)
        else:
            yardstick(row, lambda: s["run"](q, k, v),
                      lambda: s["library"](q, k, v), "sdpa")
        del q, k, v
        rows.append(row)
    return rows


def backward_specs():
    """The backward kernels, each with the forward wrapper whose gradient it
    is and the batch each train path gives it ({path: b}, the first timed):
    K3 on the flagship train step's microbatch of 16 images and train3's 64
    video frames; K4 unmasked on train3's audio tower, [8, 593]; K4
    block-diagonal on train3's temporal attention, 8 videos x 257 tokens of
    8 frames. The kernel alone is timed from what the forward saved."""
    from missm_tpu_torch.kernels import attention as K

    flash = "missm_tpu/kernels/flash_attention.py"

    def with_lse(q, k, v, g):
        out, lse = K._launch(q, k, v, None, 16, causal=False, want_lse=True)
        return q, k, v, out, lse, g

    unsplit = dict(run=lambda q, k, v: K.attention(q, k, v, 16),
                   plain=lambda q, k, v: K.attention_plain(q, k, v, 16),
                   plain_bwd=K.attention_bwd_plain, saved=with_lse,
                   kernel=lambda *x: K._launch_bwd(*x, 16))
    return [
        dict(unsplit, name="attention_bwd", forward="attention", n=257,
             batches={"train": B // ACCUM, "train3": B3T * FRAMES},
             source="attention_bwd.cu",
             replaces=f"{flash}:512 (fused_attention_cls_bwd)"),
        dict(unsplit, name="attention_unsplit_bwd",
             forward="attention_unsplit", n=593, batches={"train3": B3T},
             source="attention_bwd.cu",
             replaces=f"{flash}:760 (fused_attention_bwd, unmasked, through "
                      f"fused_attention_ad's _fa_bwd)"),
        dict(name="short_attention_bwd", forward="short_attention", n=FRAMES,
             batches={"train3": B3T * 257}, source="short_attention_bwd.cu",
             replaces=f"{flash}:760 (fused_attention_bwd, block_diag=8, "
                      f"through missm_tpu/ops/attention.py:176 "
                      f"short_attention)",
             run=lambda q, k, v: K.short_attention(q, k, v, 16),
             plain=lambda q, k, v: K.short_attention_plain(q, k, v, 16),
             plain_bwd=K.short_attention_bwd_plain,
             saved=lambda q, k, v, g: (q, k, v, g),
             kernel=lambda *x: K._launch_short_bwd(*x, 16)),
    ]


def backward_row(dev, gen, s, fwd_row):
    """A backward kernel at each train path's shape. Its check goes through
    the wrappers as the train step does: the forward wrapper on inputs that
    require grad (checked into the forward's row under the same path), then
    torch.autograd.grad, which launches the backward kernel; each must
    launch once, under its own count. Timed at the first path's shape."""
    from missm_tpu_torch.kernels import attention as K

    n, heads, hd = s["n"], 16, 64
    d = heads * hd
    b = next(iter(s["batches"].values()))
    row = {"name": s["name"], "route": "cuda",
           "source": "missm_tpu_torch/csrc/" + s["source"],
           "replaces": s["replaces"], "shape": f"B={b} N={n} H={heads} hd={hd}",
           "checks": {}}
    for path, bp in s["batches"].items():
        shape = f"B={bp} N={n} H={heads} hd={hd}"
        fwd = fwd_row["checks"][path] = {"shape": shape, "recorded": True}
        check = row["checks"][path] = {"shape": shape}
        for dtype, tag in DTYPES:
            q, k, v, g = (torch.randn(bp, n, d, generator=gen, device=dev)
                          .to(dtype) for _ in range(4))
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = dict(K.LAUNCHES)
            out = s["run"](*leaves)
            got = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            via = {name: K.LAUNCHES[name] - before[name] for name in before}
            with torch.no_grad():
                ref_out = s["plain"](q, k, v)
                ref = s["plain_bwd"](q, k, v, g, heads)

            err = (out.detach().float() - ref_out.float()).abs()
            atol, rtol = TOL[dtype]
            if (err > atol + rtol * ref_out.float().abs()).any():
                raise AssertionError(f"{s['forward']} {path} {tag}: kernel "
                                     f"disagrees with the plain version, max "
                                     f"abs err {err.max().item():.3e}")
            fwd[f"max_abs_err_{tag}"] = err.max().item()

            rel = max(((x.float() - r.float()).norm()
                       / r.float().norm()).item() for x, r in zip(got, ref))
            abs_err = max((x.float() - r.float()).abs().max().item()
                          for x, r in zip(got, ref))
            if not (rel <= GRAD_TOL[dtype]
                    and via == dict(dict.fromkeys(via, 0),
                                    **{s["forward"]: 1, s["name"]: 1})
                    and all(torch.isfinite(x).all() for x in got)):
                raise AssertionError(
                    f"{s['name']} {path} {tag}: kernel disagrees with the "
                    f"plain version, relative error {rel:.3e} (limit "
                    f"{GRAD_TOL[dtype]}), launches {via}")
            check[f"max_abs_err_{tag}"] = abs_err
            check[f"rel_err_{tag}"] = rel
            del q, k, v, g, leaves, out, got, ref_out, ref
        print(f"check {s['forward']} {path} [{shape}, recorded=True]: max abs "
              f"err f32 {fwd['max_abs_err_f32']:.2e} bf16 "
              f"{fwd['max_abs_err_bf16']:.2e}; {s['name']} rel err f32 "
              f"{check['rel_err_f32']:.2e} bf16 {check['rel_err_bf16']:.2e} "
              f"(max abs {check['max_abs_err_f32']:.2e} / "
              f"{check['max_abs_err_bf16']:.2e})", flush=True)

    # timing, bf16. The function needs q, k, v and dO read and dq, dk, dv
    # written; what the forward saved beyond q, k, v (K3's output and
    # log-sum-exp) is an extra read of that design and not counted.
    io_bytes = 7 * b * n * d * 2
    copies = max(1, math.ceil(2 * L2_BYTES / io_bytes))
    sets = [s["saved"](*(torch.randn(b, n, d, generator=gen, device=dev)
                         .to(torch.bfloat16) for _ in range(4)))
            for _ in range(copies)]
    cyc = itertools.cycle(sets)

    def plain():
        x = next(cyc)
        return s["plain_bwd"](x[0], x[1], x[2], x[-1], heads)

    row["ms"] = median_ms(lambda: s["kernel"](*next(cyc)))
    row["plain_ms"] = median_ms(plain)

    # the yardstick: the backward alone of SDPA on the same problems ([M, H,
    # T, hd] for the block-diagonal one), on a kept graph
    def sdpa_graph(x):
        def heads_first(t):
            return t.view(b, n, heads, hd).transpose(1, 2)
        leaves = [heads_first(t).detach().requires_grad_() for t in x[:3]]
        o = torch.nn.functional.scaled_dot_product_attention(*leaves)
        return o, leaves, heads_first(x[-1])

    graphs = itertools.cycle([sdpa_graph(x) for x in sets])

    def sdpa_backward():
        o, leaves, g = next(graphs)
        return torch.autograd.grad(o, leaves, g, retain_graph=True)

    # S recomputed, dV, dP, dQ, dK: 5 products of 2 N^2 hd per (batch, head)
    # (N = T, the pairs within each instance, for the block-diagonal one)
    flops = 10 * b * heads * n * n * hd
    row["bound_ms"], row["bound_by"] = bound(io_bytes, flops)
    if s["name"] != "short_attention_bwd":
        # what the bf16 kernels' tiles compute per (batch, head): the dQ
        # launch and the dK/dV launch
        row["scores_per_head"] = {k: K.plan(n, hd, k).scores
                                  for k in ("dq", "dkdv")}
    yardstick(row, lambda: s["kernel"](*next(cyc)), sdpa_backward,
              "sdpa backward")
    del sets, cyc, graphs
    return row


def flagship_config(compute_dtype, dropout_prob=0.1, fusion_type="sum"):
    from missm_tpu_torch.core.config import languagebind_large
    from missm_tpu_torch.models.finetune import ModelConfig
    from missm_tpu_torch.models.fusion import FusionConfig

    return ModelConfig(
        towers=(("image", languagebind_large("image")),),
        fusion=FusionConfig(fusion_type=fusion_type,
                            modality_types=("language", "image"),
                            output_dims=10, feature_dims=768, fusion_dim=256,
                            dropout_prob=dropout_prob),
        compute_dtype=compute_dtype)


def layers(cfg):
    """(vision blocks, text blocks) of the one-tower flagship config."""
    tower = cfg.towers[0][1]
    return tower.vision.num_layers, tower.text.num_layers


def flagship_eval_inputs(dev, rng):
    """bench.py's eval batch for the flagship model (ids with the
    tokenizer's attention mask, bf16 images, codes rotating over {0, 1, 4})
    and its seeded f32 params, with the encoder cast to bf16 once, up front
    (the fusion head stays f32). Returns (cfg, params, params_bf16, (ids,
    mask, image), (data, labels, masks))."""
    from missm_tpu_torch.models import finetune

    cfg = flagship_config("bfloat16")
    params = finetune.init_model_params(cfg, seed=0, device=dev)
    params_bf16 = {"encoder": finetune.cast_tree(params["encoder"],
                                                 torch.bfloat16),
                   "fusion": params["fusion"]}
    ids, mask = text_batch(rng, B, vary_length=False)
    image = rng.standard_normal(
        (B, 3, *cfg.towers[0][1].vision.image_size)).astype(np.float32)
    data = {"language": {"input_ids": torch.as_tensor(ids, device=dev),
                         "attention_mask": torch.as_tensor(mask, device=dev)},
            "image": torch.as_tensor(image, device=dev).to(torch.bfloat16)}
    labels = torch.as_tensor(rng.integers(0, 10, B), device=dev)
    masks = [torch.as_tensor(rng.choice([0, 1, 4], B), device=dev)
             for _ in range(4)]
    return cfg, params, params_bf16, (ids, mask, image), (data, labels, masks)


def timed_eval(name, eval_step, params, data, labels, masks, expect, card):
    """Two warm-up steps of eval_step, then STEPS timed ones with every
    launch count from 0, the missing codes rotating over `masks`. Checks
    that each timed step launched exactly `expect` ({count: launches per
    step}, every other count 0), that the outputs are finite and of the
    batch's shape and that the probs sum to 1. Prints the rate; returns
    (the launch counts of the timed steps, samples/s)."""
    from missm_tpu_torch.kernels import attention as K

    b = len(labels)
    for i in range(2):  # warm-up: cuBLAS/cuDNN plans
        eval_step(params, data, labels, masks[i])
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    for i in range(STEPS):
        out = eval_step(params, data, labels, masks[i % len(masks)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = dict(dict.fromkeys(launches, 0),
                **{k: n * STEPS for k, n in expect.items()})
    if launches != want:
        raise AssertionError(f"{name} kernel launches {launches}, expected "
                             f"{want}")
    probs = out["probs"]
    if not (torch.isfinite(probs).all() and torch.isfinite(out["loss"])):
        raise AssertionError(f"non-finite {name} outputs")
    if not torch.allclose(probs.sum(-1), torch.ones(b, device=probs.device),
                          atol=1e-5):
        raise AssertionError(f"{name} probs do not sum to 1")
    if probs.shape != (b, 10) or out["preds"].shape != (b,):
        raise AssertionError(f"{name} output shapes {tuple(probs.shape)}, "
                             f"{tuple(out['preds'].shape)}")
    rate = b * STEPS / dt
    print(f"{name}: {STEPS} steps of B={b} in {dt:.4f} s = {rate:.2f} "
          f"samples/s, {dt / STEPS * 1e3:.3f} ms/step, loss "
          f"{out['loss'].item():.4f} [{card}]", flush=True)
    return launches, rate


def slice_phase(dev, rng, card, profile):
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import make_eval_step

    t0 = time.perf_counter()
    cfg, params, params_bf16, (ids, mask, image), (data, labels, masks) = \
        flagship_eval_inputs(dev, rng)
    eval_step = make_eval_step(cfg, device=dev)
    print(f"slice set-up {time.perf_counter() - t0:.1f} s", flush=True)
    n_vision, n_text = layers(cfg)
    launches, _ = timed_eval("slice eval", eval_step, params_bf16, data,
                             labels, masks, dict(attention=n_vision,
                                                 causal_attention=n_text),
                             card)

    if profile:
        profile_step("eval", lambda: eval_step(params_bf16, data, labels,
                                               masks[0]))

    # f32 on the card (no TF32) vs f32 on the CPU (plain attention)
    cfg32 = flagship_config("float32")
    rows = {"language": {"input_ids": ids[:4], "attention_mask": mask[:4]},
            "image": image[:4]}
    miss = np.array([0, 1, 4, 0])
    with no_tf32():
        got, _ = finetune.model_forward(params, cfg32, rows, miss, device=dev)
        got_bf16, _ = finetune.model_forward(params_bf16, cfg, rows, miss,
                                             device=dev)
    params_cpu = finetune.tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    ref, _ = finetune.model_forward(params_cpu, cfg32, rows, miss,
                                    device="cpu")
    err = (got.cpu() - ref).abs().max().item()
    err_bf16 = (got_bf16.cpu() - ref).abs().max().item()
    print(f"slice f32 logits, card vs CPU plain (4 rows, CPU "
          f"{time.perf_counter() - t0:.1f} s): max abs err {err:.3e} "
          f"(limit {LOGITS_F32_ATOL}); bf16 card vs f32 CPU {err_bf16:.3e}; "
          f"|logits| max {ref.abs().max().item():.3f}", flush=True)
    if not err <= LOGITS_F32_ATOL:
        raise AssertionError("card f32 logits disagree with the CPU's")
    return launches


def eval3_config(compute_dtype, dropout_prob=0.1):
    """bench.py's eval3 model: LanguageBind video and audio towers, the
    language tower being the audio tower's text tower, and the `sum` head."""
    from missm_tpu_torch.core.config import languagebind_large
    from missm_tpu_torch.models.finetune import ModelConfig
    from missm_tpu_torch.models.fusion import FusionConfig

    return ModelConfig(
        towers=(("video", languagebind_large("video")),
                ("audio", languagebind_large("audio"))),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "video", "audio"),
                            output_dims=10, feature_dims=768, fusion_dim=256,
                            dropout_prob=dropout_prob),
        compute_dtype=compute_dtype)


def eval3_phase(dev, rng, card, profile):
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import make_eval_step

    cfg = eval3_config("bfloat16")
    t0 = time.perf_counter()
    params = finetune.init_model_params(cfg, seed=0, device=dev)
    params_bf16 = {"encoder": finetune.cast_tree(params["encoder"],
                                                 torch.bfloat16),
                   "fusion": params["fusion"]}
    # bench.py's eval3 batch: ids without a mask, bf16 media
    ids, _ = text_batch(rng, B3, vary_length=False)
    video, audio = media(rng, cfg, B3).values()
    data = {"language": torch.as_tensor(ids, device=dev),
            "video": torch.as_tensor(video, device=dev).to(torch.bfloat16),
            "audio": torch.as_tensor(audio, device=dev).to(torch.bfloat16)}
    labels = torch.as_tensor(rng.integers(0, 10, B3), device=dev)
    masks = [torch.as_tensor(rng.choice([0, 1, 2, 3], B3), device=dev)
             for _ in range(4)]
    eval_step = make_eval_step(cfg, device=dev)
    print(f"eval3 set-up {time.perf_counter() - t0:.1f} s", flush=True)
    video_cfg, audio_cfg = (t.vision for _, t in cfg.towers)
    # every other count 0: no backward, so neither attention_bwd nor
    # attention_unsplit_bwd (K4's unmasked math, which nothing here checks)
    launches, _ = timed_eval(
        "eval3", eval_step, params_bf16, data, labels, masks,
        dict(attention=video_cfg.num_layers,
             short_attention=video_cfg.num_layers,
             attention_unsplit=audio_cfg.num_layers,
             causal_attention=cfg.towers[-1][1].text.num_layers), card)

    if profile:
        profile_step("eval3", lambda: eval_step(params_bf16, data, labels,
                                                masks[0]))
    del params_bf16, data

    # f32 on the card (no TF32) vs f32 on the CPU (plain attention), 2 rows:
    # one complete, one without its video
    cfg32 = eval3_config("float32")
    rows = {"language": ids[:2], "video": video[:2], "audio": audio[:2]}
    miss = np.array([0, 2])
    with no_tf32():
        got, _ = finetune.model_forward(params, cfg32, rows, miss, device=dev)
    params_cpu = finetune.tree_map(lambda t: t.cpu(), params)
    del params
    t0 = time.perf_counter()
    ref, _ = finetune.model_forward(params_cpu, cfg32, rows, miss,
                                    device="cpu")
    err = (got.cpu() - ref).abs().max().item()
    print(f"eval3 f32 logits, card vs CPU plain (2 rows, codes {miss.tolist()}"
          f", CPU {time.perf_counter() - t0:.1f} s): max abs err {err:.3e} "
          f"(limit {LOGITS_F32_ATOL}); |logits| max "
          f"{ref.abs().max().item():.3f}", flush=True)
    if not err <= LOGITS_F32_ATOL:
        raise AssertionError("card f32 eval3 logits disagree with the CPU's")
    return launches


def train3_config(compute_dtype, dropout_prob=0.1):
    """bench.py's train3 model: eval3's towers and head. Differs from
    bench.py:208-210 in one setting: no remat, where bench.py passes a
    per-tower spec of named policies (video save_attn_mlp_qkv, audio
    save_attn_mlp_kern, language save_attn_mlp). Those policies are not
    ported, and B=8 without remat fits the 80 GB card."""
    return eval3_config(compute_dtype, dropout_prob)


def media(rng, cfg, batch):
    """Seeded f32 video [batch, 3, frames, H, W] and audio [batch, 3, mel
    bins, target length] at the shapes the config's towers take."""
    video, audio = (t.vision for _, t in cfg.towers)
    return {"video": rng.standard_normal(
                (batch, 3, video.num_frames, *video.image_size))
            .astype(np.float32),
            "audio": rng.standard_normal((batch, 3, *audio.image_size))
            .astype(np.float32)}


def timed_train(name, step, state, batch, params, cfg, moving, expect,
                card):
    """Two warm-up steps of `step` on `batch` (data, labels, missing, lr,
    generator), then STEPS timed ones with every launch count from 0.
    Checks that each timed step launched exactly `expect` ({count: launches
    per step}, every other count 0), that every loss is finite, that no
    frozen leaf of `params` moved and that every leaf of `moving` ({label:
    tensor}) did. Prints the rate and peak memory; returns (state, the
    launch counts of the timed steps, samples/s)."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.train.trainability import (FROZEN, leaves,
                                                    param_labels)

    frozen = [(t, t.clone()) for t, lab in zip(
        leaves(params), leaves(param_labels(params, cfg))) if lab == FROZEN]
    before = {k: t.clone() for k, t in moving.items()}
    losses = []
    t0 = time.perf_counter()
    for _ in range(2):  # warm-up: cuBLAS plans, Adam state
        state, m = step(state, *batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    print(f"{name} warm-up {time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, m = step(state, *batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = dict(dict.fromkeys(launches, 0),
                **{k: n * STEPS for k, n in expect.items()})
    if launches != want:
        raise AssertionError(f"{name} kernel launches {launches}, expected "
                             f"{want}")
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite {name} loss: {losses}")
    moved = sum(not torch.equal(t, t0_) for t, t0_ in frozen)
    if moved:
        raise AssertionError(f"{moved} frozen {name} leaves moved")
    still = [k for k, t in moving.items() if torch.equal(t, before[k])]
    if still:
        raise AssertionError(f"trainable {name} leaves did not move: {still}")
    rate = len(batch[1]) * STEPS / dt
    RATES[name] = rate
    print(f"{name}: {STEPS} steps of B={len(batch[1])} in {dt:.4f} s = "
          f"{rate:.2f} samples/s, "
          f"{dt / STEPS * 1e3:.3f} ms/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]}; {len(frozen)} frozen leaves "
          f"unchanged, {len(moving)} trainable leaves moved [{card}]",
          flush=True)
    return state, launches, rate


def grad_check(dev, name, cfg, params, batch, watched, expect):
    """f32 gradients of the leaves `watched(params)` ({label: leaf}) on the
    card (TF32 off) against the CPU's plain path, for `batch` (data, labels,
    missing). The card's run must launch `expect` ({count: launches})."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import compute_loss, partition_trainable

    def grads(p, device):
        partition_trainable(p, cfg)
        loss, _ = compute_loss(p, None, cfg, *batch, None, device=device)
        loss.backward()
        return loss.item(), {k: t.grad.cpu() for k, t in watched(p).items()}

    card = finetune.tree_map(lambda t: t.detach().to(dev), params)
    before = dict(K.LAUNCHES)
    with no_tf32():
        loss_gpu, g_gpu = grads(card, dev)
        torch.cuda.synchronize()
    via = {k: v - before[k] for k, v in K.LAUNCHES.items()}
    del card
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads(params, "cpu")
    cpu_s = time.perf_counter() - t0
    rel = {k: ((g_gpu[k] - g_cpu[k]).norm() / g_cpu[k].norm()).item()
           for k in g_cpu}
    depth = [t.vision.num_layers for _, t in cfg.towers]
    depth.append(cfg.towers[-1][1].text.num_layers)
    towers = "/".join([m for m, _ in cfg.towers] + ["text"])
    print(f"{name} f32 grads, card vs CPU plain ({len(batch[1])} rows, codes "
          f"{batch[2].tolist()}, {'/'.join(map(str, depth))} {towers} layers, "
          f"CPU {cpu_s:.1f} s, kernels on the card {via}): loss "
          f"{loss_gpu:.6f} vs {loss_cpu:.6f}; relative error by leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (limit {GRADS_F32_RTOL})", flush=True)
    if (any(via[k] != n for k, n in expect.items())
            or not all(v <= GRADS_F32_RTOL for v in rel.values())):
        raise AssertionError(f"card f32 {name} gradients disagree with the "
                             f"CPU's")


def train3_phase(dev, rng, card, profile, remat=None):
    """bench.py's train3 step; given a `remat` (the remat phase: bench.py's
    per-tower spec), under it, without the profile and the f32 gradients."""
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.models.encoder import _remat_for
    from missm_tpu_torch.train.step import init_train_state, make_train_step
    from missm_tpu_torch.train.trainability import (FROZEN, cast_frozen_params,
                                                    leaves, param_labels)

    cfg = dataclasses.replace(train3_config("bfloat16"), remat=remat or False)
    # bench.py's frozen_bf16=True: the frozen leaves stored in bf16
    params = cast_frozen_params(
        finetune.init_model_params(cfg, seed=0, device=dev), cfg)
    # the video tower's spatial attention has no LoRA: all of it frozen
    labels = param_labels(params, cfg)["encoder"]["video"]["vision"]
    if any(lab != FROZEN
           for lab in leaves([b["attn"] for b in labels["blocks"]])):
        raise AssertionError("a video spatial attention leaf is not frozen")
    # bench.py's train3 batch: ids without a mask, f32 media
    ids, _ = text_batch(rng, B3T, vary_length=False)
    data = {"language": torch.as_tensor(ids, device=dev),
            **{m: torch.as_tensor(x, device=dev)
               for m, x in media(rng, cfg, B3T).items()}}
    batch = (data, torch.as_tensor(rng.integers(0, 10, B3T), device=dev),
             torch.as_tensor(rng.choice([0, 1, 2, 3], B3T), device=dev), LR,
             torch.Generator(device=dev).manual_seed(0))
    state, tx = init_train_state(params, cfg)
    step = make_train_step(cfg, tx, accum_steps=1, device=dev)

    video, audio = (params["encoder"][m]["vision"] for m in ("video", "audio"))
    moving = {
        "video block 0 tattn q lora_b": video["blocks"][0]["tattn"]["q"]
        ["lora_b"],
        "video last block tattn out lora_b": video["blocks"][-1]["tattn"]
        ["out"]["lora_b"],
        "audio block 0 attn q lora_b": audio["blocks"][0]["attn"]["q"]
        ["lora_b"],
        "video patch_embedding": video["patch_embedding"]["w"],
        "audio patch_embedding": audio["patch_embedding"]["w"],
        "text block 0 attn q w": params["encoder"]["language"]["text"]
        ["blocks"][0]["attn"]["q"]["w"],
        **{f"fusion proj {m} w": params["fusion"]["proj"][m]["w"]
           for m in ("language", "video", "audio")}}
    video_cfg, audio_cfg = (t.vision for _, t in cfg.towers)
    n_text = cfg.towers[-1][1].text.num_layers
    pv, pa, pl = (_remat_for(cfg.remat, m) for m in ("video", "audio",
                                                     "language"))
    # each forward kernel once per layer, and again where the backward's
    # recompute does not find its output kept; each backward once; the
    # text tower's causal attention has a plain backward
    state, launches, _ = timed_train(
        "train3" + ("" if remat is None else f" remat={remat}"), step,
        state, batch, params,
        cfg, moving,
        dict(attention=video_cfg.num_layers * (1 + replays(pv)),
             attention_bwd=video_cfg.num_layers,
             short_attention=video_cfg.num_layers
             * (1 + replays(pv, "tattn_kernel_out")),
             short_attention_bwd=video_cfg.num_layers,
             attention_unsplit=audio_cfg.num_layers * (1 + replays(pa)),
             attention_unsplit_bwd=audio_cfg.num_layers,
             causal_attention=n_text * (1 + replays(pl))), card)
    if remat is not None:
        return launches

    if profile:
        profile_step("train3", lambda: step(state, *batch))
    del state, tx, step, params, data, batch, moving, video, audio
    torch.cuda.empty_cache()
    train3_grads(dev, rng)
    return launches


def train3_grads(dev, rng):
    """train3's f32 gradients, 2 rows at full depth, both with every
    modality (so every tower reaches the loss), LoRA B non-zero on the
    temporal and the audio attention so the LoRA A gradients are too."""
    from missm_tpu_torch.models import finetune

    cfg = train3_config("float32", dropout_prob=0.0)
    params = finetune.init_model_params(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for mod, attn in (("video", "tattn"), ("audio", "attn")):
        for block in params["encoder"][mod]["vision"]["blocks"]:
            for proj in block[attn].values():
                proj["lora_b"].normal_(0.0, 0.01, generator=gen)
    ids, _ = text_batch(rng, 2, vary_length=True)
    batch = ({"language": ids, **media(rng, cfg, 2)}, np.array([3, 8]),
             np.array([0, 0]))

    def watched(p):
        v, a = (p["encoder"][m]["vision"] for m in ("video", "audio"))
        return {
            "video block 0 tattn q lora_a": v["blocks"][0]["tattn"]["q"]
            ["lora_a"],
            "video block 0 tattn q lora_b": v["blocks"][0]["tattn"]["q"]
            ["lora_b"],
            "video last block tattn out lora_a": v["blocks"][-1]["tattn"]
            ["out"]["lora_a"],
            "video last block tattn v lora_b": v["blocks"][-1]["tattn"]["v"]
            ["lora_b"],
            "audio block 0 attn q lora_a": a["blocks"][0]["attn"]["q"]
            ["lora_a"],
            "audio last block attn k lora_b": a["blocks"][-1]["attn"]["k"]
            ["lora_b"],
            "video patch_embedding": v["patch_embedding"]["w"],
            "audio patch_embedding": a["patch_embedding"]["w"],
            "text block 0 q w": p["encoder"]["language"]["text"]["blocks"][0]
            ["attn"]["q"]["w"],
            **{f"fusion proj {m} w": p["fusion"]["proj"][m]["w"]
               for m in ("language", "video", "audio")}}

    video, audio = (t.vision.num_layers for _, t in cfg.towers)
    grad_check(dev, "train3", cfg, params, batch, watched,
               dict(short_attention_bwd=video, attention_bwd=video,
                    attention_unsplit_bwd=audio))


def flagship_train_inputs(dev, rng, fusion_type="sum", remat=False):
    """bench.py's train batch for the flagship model (ids without a mask,
    f32 images, codes from {0, 1, 4}, lr, the head's dropout generator), its
    seeded f32 params and the train step over 4 x 16 microbatches with its
    Adam state, under `remat`; for MTD_stu and KL_stu the state holds a
    teacher, a copy of a seeded Distill_tea head. Returns (cfg, params,
    state, step, batch)."""
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.models.fusion import init_fusion
    from missm_tpu_torch.train.step import (TEACHER_TYPES, init_train_state,
                                            make_train_step)

    cfg = dataclasses.replace(
        flagship_config("bfloat16", fusion_type=fusion_type), remat=remat)
    params = finetune.init_model_params(cfg, seed=0, device=dev)
    teacher = None
    if fusion_type in TEACHER_TYPES:
        teacher = init_fusion(
            torch.Generator(device=dev).manual_seed(1),
            dataclasses.replace(cfg.fusion, fusion_type="Distill_tea"))
    ids, _ = text_batch(rng, B, vary_length=False)
    data = {"language": torch.as_tensor(ids, device=dev),
            "image": torch.as_tensor(rng.standard_normal(
                (B, 3, *cfg.towers[0][1].vision.image_size))
                .astype(np.float32), device=dev)}
    batch = (data, torch.as_tensor(rng.integers(0, 10, B), device=dev),
             torch.as_tensor(rng.choice([0, 1, 4], B), device=dev), LR,
             torch.Generator(device=dev).manual_seed(0))
    state, tx = init_train_state(params, cfg, teacher_fusion=teacher)
    return cfg, params, state, make_train_step(cfg, tx, accum_steps=ACCUM,
                                               device=dev), batch


def flagship_moving(params):
    """The flagship train step's watched trainable leaves."""
    blocks = params["encoder"]["image"]["vision"]["blocks"]
    return {"vision block 0 q lora_b": blocks[0]["attn"]["q"]["lora_b"],
            "vision last block out lora_b": blocks[-1]["attn"]["out"]
            ["lora_b"],
            "text block 0 q w": params["encoder"]["language"]["text"]
            ["blocks"][0]["attn"]["q"]["w"],
            "patch_embedding": params["encoder"]["image"]["vision"]
            ["patch_embedding"]["w"],
            "fusion proj image w": params["fusion"]["proj"]["image"]["w"]}


def train_phase(dev, rng, card, profile):
    cfg, params, state, step, batch = flagship_train_inputs(dev, rng)
    moving = flagship_moving(params)
    n_vision, n_text = layers(cfg)
    # N=257 takes the CLS-split route, so nothing reaches the unsplit counts
    state, launches, _ = timed_train(
        f"train ({ACCUM} x {B // ACCUM})", step, state, batch, params, cfg,
        moving, dict(attention=n_vision * ACCUM, attention_bwd=n_vision * ACCUM,
                     causal_attention=n_text * ACCUM), card)

    if profile:
        profile_step("train", lambda: step(state, *batch))
    del state, step, params, batch, moving
    flagship_grads(dev, rng)
    return launches


def flagship_grads(dev, rng):
    """The flagship train step's f32 gradients, 4 rows at full depth, LoRA B
    non-zero so the LoRA A gradients are too."""
    from missm_tpu_torch.models import finetune

    cfg = flagship_config("float32", dropout_prob=0.0)
    params = finetune.init_model_params(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    blocks = params["encoder"]["image"]["vision"]["blocks"]
    for block in blocks:
        for proj in block["attn"].values():
            proj["lora_b"].normal_(0.0, 0.01, generator=gen)
    ids, mask = text_batch(rng, 4, vary_length=True)
    batch = ({"language": {"input_ids": ids, "attention_mask": mask},
              "image": rng.standard_normal(
                  (4, 3, *cfg.towers[0][1].vision.image_size))
              .astype(np.float32)},
             np.array([1, 5, 7, 2]), np.array([0, 1, 4, 0]))

    def watched(p):
        b = p["encoder"]["image"]["vision"]["blocks"]
        return {
            "vision block 0 q lora_a": b[0]["attn"]["q"]["lora_a"],
            "vision block 0 q lora_b": b[0]["attn"]["q"]["lora_b"],
            "vision last block out lora_a": b[-1]["attn"]["out"]["lora_a"],
            "vision last block out lora_b": b[-1]["attn"]["out"]["lora_b"],
            "patch_embedding": p["encoder"]["image"]["vision"]
            ["patch_embedding"]["w"],
            "text block 0 q w": p["encoder"]["language"]["text"]["blocks"][0]
            ["attn"]["q"]["w"],
            "fusion proj image w": p["fusion"]["proj"]["image"]["w"],
            "fusion proj language w": p["fusion"]["proj"]["language"]["w"]}

    grad_check(dev, "train", cfg, params, batch, watched,
               dict(attention_bwd=layers(cfg)[0]))


@contextlib.contextmanager
def ln2fc1_switch(on=True):
    """FUSE_LN2_FC1 set to `on` for the block, off again afterwards."""
    from missm_tpu_torch.kernels import ln_linear as lnl

    lnl.FUSE_LN2_FC1 = on
    try:
        yield
    finally:
        lnl.FUSE_LN2_FC1 = False


def in_turns(name, run_arm):
    """run_arm(arm) -> (launch counts, samples/s) for the arms unfused,
    fused, fused, unfused in turns, with FUSE_LN2_FC1 set for each; prints
    both arms' rates side by side. Returns the fused arms' launch counts."""
    rates = {"unfused": [], "fused": []}
    for arm in ("unfused", "fused", "fused", "unfused"):
        with ln2fc1_switch(arm == "fused"):
            launches, rate = run_arm(arm)
        rates[arm].append(rate)
        if arm == "fused":
            fused = launches
    print(f"{name}: fused {rates['fused'][0]:.2f} / {rates['fused'][1]:.2f} "
          f"samples/s against unfused {rates['unfused'][0]:.2f} / "
          f"{rates['unfused'][1]:.2f} in the same run; K5 "
          f"{fused['ln_linear'] // STEPS} launches per step", flush=True)
    return fused


def ln2fc1_phase(dev, rng, card, profile):
    """The flagship eval and train steps with ln2 -> fc1 through K5
    (FUSE_LN2_FC1 on), timed in turns with the switch off; returns the fused
    arms' launch counts {"ln2fc1_eval": .., "ln2fc1_train": ..}."""
    return {"ln2fc1_eval": ln2fc1_eval(dev, rng, card, profile),
            "ln2fc1_train": ln2fc1_train(dev, rng, card, profile)}


def ln2fc1_eval(dev, rng, card, profile):
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import make_eval_step

    cfg, params, params_bf16, (ids, mask, image), (data, labels, masks) = \
        flagship_eval_inputs(dev, rng)
    eval_step = make_eval_step(cfg, device=dev)
    n_vision, n_text = layers(cfg)
    def run_arm(arm):
        expect = dict(attention=n_vision, causal_attention=n_text)
        if arm == "fused":
            expect["ln_linear"] = n_vision + n_text
        return timed_eval(f"ln2fc1 eval {arm}", eval_step, params_bf16, data,
                          labels, masks, expect, card)

    fused_launches = in_turns("ln2fc1 eval", run_arm)
    if profile:
        with ln2fc1_switch():
            profile_step("ln2fc1 eval", lambda: eval_step(params_bf16, data,
                                                          labels, masks[0]))
    del params_bf16, data

    # f32 on the card (no TF32) vs f32 on the CPU (the plain versions), both
    # fused: 8 rows, so that both towers' rows (8 x 257, 8 x 77) pass the gate
    cfg32 = flagship_config("float32")
    rows = {"language": {"input_ids": ids[:8], "attention_mask": mask[:8]},
            "image": image[:8]}
    miss = np.array([0, 1, 4, 0, 0, 1, 4, 0])
    before = dict(K.LAUNCHES)
    with no_tf32(), ln2fc1_switch():
        got, _ = finetune.model_forward(params, cfg32, rows, miss, device=dev)
        torch.cuda.synchronize()
    via = K.LAUNCHES["ln_linear"] - before["ln_linear"]
    params_cpu = finetune.tree_map(lambda t: t.cpu(), params)
    del params
    t0 = time.perf_counter()
    with ln2fc1_switch():
        ref, _ = finetune.model_forward(params_cpu, cfg32, rows, miss,
                                        device="cpu")
    err = (got.cpu() - ref).abs().max().item()
    print(f"ln2fc1 f32 logits, card vs CPU plain (8 rows, CPU "
          f"{time.perf_counter() - t0:.1f} s, K5 launches {via}): max abs err "
          f"{err:.3e} (limit {LOGITS_F32_ATOL}); |logits| max "
          f"{ref.abs().max().item():.3f}", flush=True)
    if via != n_vision + n_text or not err <= LOGITS_F32_ATOL:
        raise AssertionError("card f32 ln2fc1 logits disagree with the CPU's")
    return fused_launches


def ln2fc1_train(dev, rng, card, profile):
    cfg, params, state, step, batch = flagship_train_inputs(dev, rng)
    text = params["encoder"]["language"]["text"]["blocks"]
    vision = params["encoder"]["image"]["vision"]["blocks"]
    # K5's backward reaches the text tower's fc1 weight and bias and ln2
    moving = {"vision block 0 q lora_b": vision[0]["attn"]["q"]["lora_b"],
              "text block 0 fc1 w": text[0]["mlp"]["fc1"]["w"],
              "text block 0 fc1 b": text[0]["mlp"]["fc1"]["b"],
              "text last block ln2 scale": text[-1]["ln2"]["scale"],
              "fusion proj image w": params["fusion"]["proj"]["image"]["w"]}
    n_vision, n_text = layers(cfg)
    base = dict(attention=n_vision * ACCUM, attention_bwd=n_vision * ACCUM,
                causal_attention=n_text * ACCUM)
    def run_arm(arm):
        nonlocal state
        expect = dict(base)
        if arm == "fused":
            expect["ln_linear"] = (n_vision + n_text) * ACCUM
        state, launches, rate = timed_train(
            f"ln2fc1 train {arm} ({ACCUM} x {B // ACCUM})", step, state,
            batch, params, cfg, moving, expect, card)
        return launches, rate

    fused_launches = in_turns("ln2fc1 train", run_arm)
    if profile:
        with ln2fc1_switch():
            profile_step("ln2fc1 train", lambda: step(state, *batch))
    del state, step, params, batch, moving, text, vision
    torch.cuda.empty_cache()
    ln2fc1_grads(dev, rng)
    return fused_launches


def ln2fc1_grads(dev, rng):
    """One f32 step's gradients on the card (TF32 off), fused against
    unfused: 8 rows, so that both towers' rows pass the gate, at full depth,
    LoRA B non-zero. The fused run launches K5 once per block and its plain
    backward gives the text tower's fc1 and ln2 gradients."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import compute_loss, partition_trainable

    cfg = flagship_config("float32", dropout_prob=0.0)
    params = finetune.init_model_params(cfg, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for block in params["encoder"]["image"]["vision"]["blocks"]:
        for proj in block["attn"].values():
            proj["lora_b"].normal_(0.0, 0.01, generator=gen)
    ids, mask = text_batch(rng, 8, vary_length=True)
    batch = ({"language": {"input_ids": ids, "attention_mask": mask},
              "image": rng.standard_normal(
                  (8, 3, *cfg.towers[0][1].vision.image_size))
              .astype(np.float32)},
             np.array([1, 5, 7, 2, 0, 9, 3, 4]),
             np.array([0, 1, 4, 0, 0, 0, 1, 4]))

    def watched(p):
        v = p["encoder"]["image"]["vision"]["blocks"]
        t = p["encoder"]["language"]["text"]["blocks"]
        return {"vision block 0 q lora_a": v[0]["attn"]["q"]["lora_a"],
                "vision last block out lora_b": v[-1]["attn"]["out"]["lora_b"],
                "patch_embedding": p["encoder"]["image"]["vision"]
                ["patch_embedding"]["w"],
                "text block 0 fc1 w": t[0]["mlp"]["fc1"]["w"],
                "text block 0 fc1 b": t[0]["mlp"]["fc1"]["b"],
                "text block 0 ln2 scale": t[0]["ln2"]["scale"],
                "text last block ln2 bias": t[-1]["ln2"]["bias"],
                "text block 0 q w": t[0]["attn"]["q"]["w"],
                "fusion proj language w": p["fusion"]["proj"]["language"]
                ["w"]}

    def grads(on):
        p = finetune.tree_map(lambda t: t.detach().clone(), params)
        partition_trainable(p, cfg)
        before = dict(K.LAUNCHES)
        with no_tf32(), ln2fc1_switch(on):
            loss, _ = compute_loss(p, None, cfg, *batch, None, device=dev)
            loss.backward()
            torch.cuda.synchronize()
        via = {k: v - before[k] for k, v in K.LAUNCHES.items()}
        return loss.item(), {k: t.grad for k, t in watched(p).items()}, via

    loss_on, g_on, via_on = grads(True)
    loss_off, g_off, via_off = grads(False)
    rel = {k: ((g_on[k] - g_off[k]).norm() / g_off[k].norm()).item()
           for k in g_off}
    n_vision, n_text = layers(cfg)
    print(f"ln2fc1 f32 grads on the card, fused vs unfused (8 rows, codes "
          f"{batch[2].tolist()}, K5 launches {via_on['ln_linear']} / "
          f"{via_off['ln_linear']}): loss {loss_on:.6f} vs {loss_off:.6f}; "
          f"relative error by leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (limit {GRADS_F32_RTOL})", flush=True)
    if (via_on["ln_linear"] != n_vision + n_text or via_off["ln_linear"]
            or via_on["attention_bwd"] != n_vision
            or not all(v <= GRADS_F32_RTOL for v in rel.values())):
        raise AssertionError("card f32 ln2fc1 gradients disagree with the "
                             "unfused ones")


def heads_phase(dev, rng, card, profile):
    """All 13 fusion heads at the flagship's fusion widths on random f32
    embeddings of the three modalities (B=64, codes rotating over {0, 1, 2,
    3}): logits and the gradient of their sum with respect to every head
    param, card f32 (TF32 off) against the CPU. Launches no kernel."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models.finetune import tree_map
    from missm_tpu_torch.models.fusion import (FUSION_TYPES, fusion_forward,
                                               init_fusion)
    from missm_tpu_torch.train.trainability import leaves

    base = flagship_config("float32").fusion
    embeds = {m: rng.standard_normal((B, base.feature_dims))
              .astype(np.float32) for m in HEAD_MODALITIES}
    codes = np.arange(B) % 4

    def run(params, cfg, device):
        p = tree_map(
            lambda t: t.detach().to(device, copy=True).requires_grad_(),
            params)
        logits, _ = fusion_forward(
            p, cfg, {m: torch.as_tensor(e, device=device)
                     for m, e in embeds.items()},
            torch.as_tensor(codes, device=device))
        logits.sum().backward()
        return logits.detach().cpu(), [t.grad.cpu() for t in leaves(p)]

    K.reset_launches()
    for i, ftype in enumerate(FUSION_TYPES):
        cfg = dataclasses.replace(base, fusion_type=ftype,
                                  modality_types=HEAD_MODALITIES)
        params = init_fusion(torch.Generator().manual_seed(i), cfg)
        t0 = time.perf_counter()
        with no_tf32():
            got, g_gpu = run(params, cfg, dev)
        card_s = time.perf_counter() - t0
        ref, g_cpu = run(params, cfg, "cpu")
        err = (got - ref).abs().max().item()
        norms = [g.norm().item() for g in g_cpu]
        floor = HEAD_FLOOR * max(norms)
        rel = [(a - b).norm().item() / max(n, floor)
               for a, b, n in zip(g_gpu, g_cpu, norms)]
        print(f"heads {ftype}: {len(g_cpu)} leaves, "
              f"{sum(t.numel() for t in g_cpu)} params, card "
              f"{card_s * 1e3:.1f} ms; f32 logits max abs err {err:.3e} "
              f"(limit {LOGITS_F32_ATOL}); worst gradient rel err "
              f"{max(rel):.3e} (limit {HEAD_GRAD_RTOL}; "
              f"{sum(n < floor for n in norms)} leaves under the floor)",
              flush=True)
        if not (err <= LOGITS_F32_ATOL and torch.isfinite(got).all()
                and max(rel) <= HEAD_GRAD_RTOL):
            raise AssertionError(f"card {ftype} head disagrees with the CPU")
    launches = dict(K.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the heads launched kernels: {launches}")
    return {"heads": launches}


def distill_phase(dev, rng, card, profile):
    """The flagship train step (B=64 as 4 x 16) with the MTD_stu head and
    its EMA teacher through timed_train; then one step checked against the
    EMA rule; then one step each of KL_stu and self_distill on the same
    params (one head shape for all three)."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import (EMA_DECAY, init_train_state,
                                            make_train_step)
    from missm_tpu_torch.train.trainability import (FROZEN, leaves,
                                                    param_labels)

    cfg, params, state, step, batch = flagship_train_inputs(dev, rng,
                                                            "MTD_stu")
    blocks = params["encoder"]["image"]["vision"]["blocks"]
    moving = {"vision block 0 q lora_b": blocks[0]["attn"]["q"]["lora_b"],
              "text block 0 q w": params["encoder"]["language"]["text"]
              ["blocks"][0]["attn"]["q"]["w"],
              "fusion mlp_fc1 w": params["fusion"]["mlp_fc1"]["w"],
              "fusion head fc2 w": params["fusion"]["head"]["fc2"]["w"]}
    n_vision, n_text = layers(cfg)
    # the teacher's no-grad forward beside the student's in every microbatch
    teacher_step = dict(attention=2 * n_vision * ACCUM,
                        attention_bwd=n_vision * ACCUM,
                        causal_attention=2 * n_text * ACCUM)
    state, launches, rate = timed_train(
        f"distill MTD_stu ({ACCUM} x {B // ACCUM})", step, state, batch,
        params, cfg, moving, teacher_step, card)
    paths = {"distill": launches}
    print(f"distill MTD_stu {rate:.2f} samples/s beside train "
          f"{RATES.get(f'train ({ACCUM} x {B // ACCUM})', float('nan')):.2f}"
          f" [{card}]", flush=True)

    # one more step: the teacher moved by the EMA rule toward the updated
    # student fusion, every frozen leaf bit-unchanged
    old = finetune.tree_map(torch.clone, state.teacher_fusion)
    frozen = [(t, t.clone()) for t, lab in zip(
        leaves(params), leaves(param_labels(params, cfg))) if lab == FROZEN]
    state, _ = step(state, *batch)
    want = [w * EMA_DECAY + s * (1.0 - EMA_DECAY)
            for w, s in zip(leaves(old), leaves(params["fusion"]))]
    err = max((t - w).abs().max().item()
              for t, w in zip(leaves(state.teacher_fusion), want))
    # the error in units of f32 rounding of each element's terms
    f32 = torch.finfo(torch.float32)
    ulps = max(((t - w).abs() / (f32.eps * (o.abs() * EMA_DECAY + s.abs()
                                            * (1.0 - EMA_DECAY)) + f32.tiny))
               .max().item()
               for t, w, o, s in zip(leaves(state.teacher_fusion), want,
                                     leaves(old), leaves(params["fusion"])))
    moved = max((t - o).abs().max().item() for t, o in zip(
        leaves(state.teacher_fusion), leaves(old)))
    changed = sum(not torch.equal(t, t0) for t, t0 in frozen)
    print(f"distill EMA: teacher vs old * {EMA_DECAY} + student * "
          f"{1 - EMA_DECAY:.3f}: max abs err {err:.3e}, {ulps:.2f} units of "
          f"f32 rounding (limit {EMA_ULPS}), "
          f"the teacher moved by up to {moved:.3e}; {len(frozen)} frozen "
          f"leaves, {changed} changed", flush=True)
    if not (ulps <= EMA_ULPS and moved > 0 and changed == 0):
        raise AssertionError("the EMA teacher or the frozen leaves are off")
    teacher = state.teacher_fusion
    del state, step, old, want, frozen

    for ftype, expect in (("KL_stu", teacher_step),
                          ("self_distill", dict(
                              attention=n_vision * ACCUM,
                              attention_bwd=n_vision * ACCUM,
                              causal_attention=n_text * ACCUM))):
        fcfg = dataclasses.replace(
            cfg, fusion=dataclasses.replace(cfg.fusion, fusion_type=ftype))
        state, tx = init_train_state(
            params, fcfg,
            teacher_fusion=teacher if ftype == "KL_stu" else None)
        step = make_train_step(fcfg, tx, accum_steps=ACCUM, device=dev)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        loss = m["loss"].item()
        dt = time.perf_counter() - t0
        got = dict(K.LAUNCHES)
        want_l = dict(dict.fromkeys(got, 0), **expect)
        print(f"distill {ftype}: one step of B={B} in {dt:.4f} s, loss "
              f"{loss:.4f}, launches {got}", flush=True)
        if got != want_l or not math.isfinite(loss):
            raise AssertionError(f"distill {ftype}: launches {got}, expected "
                                 f"{want_l}; loss {loss}")
        paths[f"distill {ftype}"] = got
        del state, tx, step
    return paths


class ArrayLoader:
    """(data, labels, missing) batches of `batch_size` rows sliced from
    in-memory arrays (media and ids as tensors on the card, labels and codes
    as numpy); the last batch may be partial."""

    def __init__(self, data, labels, missing, batch_size):
        self.data, self.labels, self.missing = data, labels, missing
        self.batch_size = batch_size

    def __iter__(self):
        def rows(tree, sl):
            return ({k: rows(v, sl) for k, v in tree.items()}
                    if isinstance(tree, dict) else tree[sl])

        for i in range(0, len(self.labels), self.batch_size):
            sl = slice(i, i + self.batch_size)
            yield rows(self.data, sl), self.labels[sl], self.missing[sl]


def sweep_phase(dev, rng, card, profile):
    """The flagship model with the concat head and a bf16 encoder through
    run_missing_sweep(concat_mean): the statistics pass over 2 x 64 train
    rows, then missing types x ratios, each a batch of 64 and a partial
    batch of 37 with codes from simulate_missing_modality. Checks the
    launches per batch, 9 finite report blocks, and that the statistics
    the sweep's pass computes are non-zero and the ones it evaluated with."""
    from missm_tpu_torch.data.missing import simulate_missing_modality
    from missm_tpu_torch.eval.sweep import (evaluate_loader,
                                            run_missing_sweep,
                                            statistics_pass)
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.metrics import compute_metrics
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.models.fusion import set_statistics
    from missm_tpu_torch.train.step import make_eval_step

    cfg = flagship_config("bfloat16", fusion_type="concat")
    params = finetune.init_model_params(cfg, seed=0, device=dev)
    params = {"encoder": finetune.cast_tree(params["encoder"], torch.bfloat16),
              "fusion": params["fusion"]}
    size = cfg.towers[0][1].vision.image_size

    def arrays(n):
        ids, mask = text_batch(rng, n, vary_length=True)
        return ({"language": {"input_ids": torch.as_tensor(ids, device=dev),
                              "attention_mask": torch.as_tensor(mask,
                                                                device=dev)},
                 "image": torch.as_tensor(rng.standard_normal(
                     (n, 3, *size)).astype(np.float32), device=dev)
                 .to(torch.bfloat16)}, rng.integers(0, 10, n))

    train_data, train_labels = arrays(SWEEP_TRAIN_ROWS)
    train = ArrayLoader(train_data, train_labels,
                        np.zeros(SWEEP_TRAIN_ROWS, np.int64), B)
    data, labels = arrays(SWEEP_ROWS)
    modal = ["language", "image", "mixed"]
    test = {mt: {r: ArrayLoader(data, labels, np.asarray(
        simulate_missing_modality(SWEEP_ROWS, mt, r, modal)), B)
        for r in SWEEP_RATIOS} for mt in SWEEP_TYPES}
    eval_step = make_eval_step(cfg, device=dev)
    eval_step(params, *next(iter(test["mixed"][0.9])))  # warm-up
    torch.cuda.synchronize()

    n_vision, n_text = layers(cfg)
    with tempfile.TemporaryDirectory() as out:
        K.reset_launches()
        t0 = time.perf_counter()
        results = run_missing_sweep(params, cfg, eval_step, test, out,
                                    "flagship", "concat_mean",
                                    train_loader=train, verbose=False,
                                    device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        blocks = []
        for mt in SWEEP_TYPES:
            with open(os.path.join(out, f"flagship_concat_mean_{mt}.txt"),
                      encoding="utf-8") as f:
                blocks += [b for b in f.read().split("\n\n") if b]
    batches = COVERS["sweep"]
    want = dict(dict.fromkeys(launches, 0), attention=n_vision * batches,
                causal_attention=n_text * batches)
    numbers = [float(line.rsplit(": ", 1)[1]) for b in blocks
               for line in b.splitlines()[2:]]
    rows = len(SWEEP_TYPES) * len(SWEEP_RATIOS) * SWEEP_ROWS
    print(f"sweep concat_mean: {len(blocks)} report blocks, "
          f"{rows} test rows + {SWEEP_TRAIN_ROWS} train rows in {dt:.4f} s "
          f"= {(rows + SWEEP_TRAIN_ROWS) / dt:.2f} samples/s ({batches} "
          f"batches, {dt / batches * 1e3:.3f} ms a batch); launches "
          f"{launches}; metrics "
          + "; ".join(f"{mt} {r}: acc {m['accuracy']:.4f} auc "
                      f"{m['auc']:.4f} loss {m['loss']:.4f}"
                      for mt, per in results.items()
                      for r, m in per.items()) + f" [{card}]", flush=True)
    if (launches != want or len(blocks) != len(SWEEP_TYPES)
            * len(SWEEP_RATIOS) or len(numbers) != 4 * len(blocks)
            or not all(math.isfinite(x) for x in numbers)):
        raise AssertionError(f"sweep: launches {launches} (expected {want}), "
                             f"{len(blocks)} blocks, numbers {numbers}")

    # the statistics the sweep's pass computes, recomputed: non-zero, and
    # the sweep's (mixed, 0.9) metrics are the ones they give
    stats = statistics_pass(params, cfg, train, "mean", device=dev)
    filled = dict(params, fusion=set_statistics(params["fusion"], stats))
    _, lab, preds, probs = evaluate_loader(filled, eval_step,
                                           test["mixed"][0.9])
    again = compute_metrics(lab, preds, probs)
    norms = {m: float(np.linalg.norm(v)) for m, v in stats.items()}
    same = all(again[k] == results["mixed"][0.9][k]
               for k in ("accuracy", "f1", "auc"))
    print(f"sweep statistics: norms {norms}; the (mixed, 0.9) metrics "
          f"{'equal' if same else 'differ from'} a pass with them", flush=True)
    if not (all(n > 0 and math.isfinite(n) for n in norms.values())
            and same):
        raise AssertionError("sweep statistics empty or not the sweep's")
    return {"sweep": launches}


def write_mvsa_tree(root, rng, classes=10):
    """root/label.csv with DATA_SPLITS rows, root/missing_index.pkl (the
    port's generate_missing_index) and one seeded JPEG a row under
    root/data: a smooth colour field (a coarse random grid, bilinearly
    upsampled) at a size drawn from DATA_SIZES. Every class occurs.
    Returns the csv path."""
    from PIL import Image

    from missm_tpu_torch.data.missing import (generate_missing_index,
                                              save_missing_index)

    n = sum(DATA_SPLITS.values())
    modes = [m for m, k in DATA_SPLITS.items() for _ in range(k)]
    labels = rng.permutation(np.arange(n) % classes)
    words = [f"w{i}" for i in range(500)]
    os.makedirs(os.path.join(root, "data"))
    with open(os.path.join(root, "label.csv"), "w") as f:
        f.write("ID,language,annotation,mode\n")
        for i in range(n):
            text = " ".join(rng.choice(words, rng.integers(3, 60)))
            f.write(f"{i},{text},class{labels[i]},{modes[i]}\n")
            h, w = DATA_SIZES[rng.integers(len(DATA_SIZES))]
            coarse = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3),
                                  dtype=np.uint8)
            Image.fromarray(coarse).resize(
                (w, h), Image.Resampling.BILINEAR).save(
                os.path.join(root, "data", f"{i}.jpg"), quality=90)
    save_missing_index(os.path.join(root, "missing_index.pkl"),
                       generate_missing_index(DATA_SPLITS,
                                              ["language", "image"]))
    return os.path.join(root, "label.csv")


def data_args(**kw):
    """The test/train entry points' args for the mvsa tree."""
    return argparse.Namespace(**dict(dict(
        datasetName="mvsa", fusion_type="concat", train_missing=False,
        batch_size=B, num_workers=DATA_WORKERS,
        test_missing_type=list(SWEEP_TYPES)), **kw))


def data_tokenizer(cfg):
    """HashTokenizer with the text tower's vocab and context, as
    missm_tpu/cli/common.py:120-133 sets it up."""
    from missm_tpu_torch.data.tokenizer import HashTokenizer

    text = cfg.towers[0][1].text
    return HashTokenizer(text.vocab_size, text.max_position_embeddings)


def same_batches(name, dev, card, cpu):
    """Two lists of loader batches, the first with its images on `dev`, the
    second on the CPU: ids, masks, labels and codes exactly equal, the
    images within DATA_TOL. Returns the largest image difference."""
    worst = 0.0
    if len(card) != len(cpu):
        raise AssertionError(f"{name}: {len(card)} batches vs {len(cpu)}")
    for (cd, cl, cm), (wd, wl, wm) in zip(card, cpu):
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(cd["language"][k], wd["language"][k])
        np.testing.assert_array_equal(cl, wl)
        np.testing.assert_array_equal(cm, wm)
        got, want = cd["image"].cpu(), wd["image"]
        if cd["image"].device.type != dev.type or want.device.type != "cpu":
            raise AssertionError(f"{name}: images on {cd['image'].device} "
                                 f"and {want.device}")
        torch.testing.assert_close(got, want, **DATA_TOL)
        worst = max(worst, (got - want).abs().max().item())
    return worst


def transform_checks(dev, rng, card):
    """Each device transform on the card against the same call on the CPU
    (image at each photo size, video [8, 360, 640, 3] with the flip off and
    on, depth with max_depth 10 and 0), and the audio model input of a 10 s
    (tile) and a 15 s (chunks) WAV on the card against the numpy host path,
    at languagebind_large audio's 112 bins x 1036 frames; then
    loader_checks and transform_memory. Prints the largest difference and
    the card's ms a sample of each (a smoke reading: CUDA events around 10
    calls, the host-to-card copies of the source and of the resize
    matrices included)."""
    import wave

    from missm_tpu_torch.core.config import languagebind_large
    from missm_tpu_torch.data import ingest_io
    from missm_tpu_torch.ops.image_transforms import (depth_transform,
                                                      image_transform,
                                                      video_transform)
    from missm_tpu_torch.ops.melfbank import (FbankConfig, audio_model_input,
                                              audio_model_input_host,
                                              chunk_ranges, num_frames)

    cases = [(f"image {h}x{w}", image_transform,
              (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 224), {})
             for h, w in DATA_SIZES]
    frames = rng.integers(0, 256, (8, 360, 640, 3), dtype=np.uint8)
    raw = rng.integers(0, 12000, (480, 640)).astype(np.float32)
    cases += [(f"video 8x360x640 flip {f}", video_transform, (frames, 224),
               dict(flip=f)) for f in (False, True)]
    cases += [(f"depth 480x640 max_depth {m}", depth_transform, (raw, 224),
               dict(max_depth=m)) for m in (10.0, 0.0)]
    lines = []
    for name, fn, args, kw in cases:
        got = fn(*args, **kw, device=dev)
        want = fn(*args, **kw, device="cpu")
        torch.testing.assert_close(got.cpu(), want, **DATA_TOL)
        ms = median_ms(lambda: fn(*args, **kw, device=dev), reps=5, iters=10)
        lines.append(f"{name} {ms:.4f} ms (max |card - cpu| "
                     f"{(got.cpu() - want).abs().max().item():.2e})")

    tower = languagebind_large("audio")
    fb = FbankConfig(sample_rate=tower.audio_sample_rate,
                     num_mel_bins=tower.num_mel_bins)
    with tempfile.TemporaryDirectory() as tmp:
        for seconds in (10, 15):
            path = os.path.join(tmp, f"{seconds}.wav")
            pcm = (rng.standard_normal(16000 * seconds) * 4000).astype("<i2")
            with wave.open(path, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(pcm.tobytes())
            wav, _ = ingest_io.read_audio(path)
            wav = wav - wav.mean()
            frames_n = num_frames(len(wav), fb)
            idx = ((0, 0, 0) if frames_n <= tower.target_length else
                   tuple(int(r[0]) for r in chunk_ranges(
                       frames_n, tower.target_length)))
            args = (wav, fb, tower.target_length, idx, tower.audio_mean,
                    tower.audio_std)
            got = audio_model_input(*args, device=dev)
            want = torch.from_numpy(audio_model_input_host(*args))
            if got.shape != (3, 112, 1036):
                raise AssertionError(f"audio {seconds} s: {got.shape}")
            torch.testing.assert_close(got.cpu(), want, **AUDIO_TOL)
            ms = median_ms(lambda: audio_model_input(*args, device=dev),
                           reps=5, iters=10)
            lines.append(f"audio {seconds} s ({frames_n} frames) {ms:.4f} ms "
                         f"(max |card - host| "
                         f"{(got.cpu() - want).abs().max().item():.2e})")
        lines.append(loader_checks(dev, rng, tmp, tower))
    lines.append(transform_memory(dev, rng))
    print("data transforms, card ms a sample (smoke readings) and agreement "
          "with the CPU: " + "; ".join(lines) + f" [{card}]", flush=True)


def loader_checks(dev, rng, tmp, audio_tower):
    """The production media loaders of image (a JPEG), depth (a 16-bit PNG)
    and audio (tmp's 15 s WAV), built for the card and for the CPU: each
    sample a tensor on its loader's device, the card's within DATA_TOL
    (AUDIO_TOL for audio) of the CPU's."""
    from PIL import Image

    from missm_tpu_torch.core.config import languagebind_large
    from missm_tpu_torch.data.preprocess import make_media_loaders

    paths = {"image": os.path.join(tmp, "i.jpg"),
             "depth": os.path.join(tmp, "d.png"),
             "audio": os.path.join(tmp, "15.wav")}
    Image.fromarray(rng.integers(0, 256, (375, 500, 3), dtype=np.uint8)
                    ).save(paths["image"], quality=90)
    Image.fromarray(rng.integers(0, 12000, (480, 640), dtype=np.uint16)
                    ).save(paths["depth"])
    towers = {"image": languagebind_large("image"),
              "depth": languagebind_large("depth"), "audio": audio_tower}
    card = make_media_loaders(towers, device=dev)
    cpu = make_media_loaders(towers, device="cpu")
    worst = {}
    for m, path in paths.items():
        got, want = card[m](path), cpu[m](path)
        if not (torch.is_tensor(got) and got.device.type == dev.type
                and torch.is_tensor(want) and want.device.type == "cpu"):
            raise AssertionError(f"loader {m}: samples {type(got)} on "
                                 f"{getattr(got, 'device', None)}, "
                                 f"{type(want)} on "
                                 f"{getattr(want, 'device', None)}")
        torch.testing.assert_close(got.cpu(), want, **(
            AUDIO_TOL if m == "audio" else DATA_TOL))
        worst[m] = (got.cpu() - want).abs().max().item()
    return ("loaders on the card, samples there: "
            + ", ".join(f"{m} within {e:.2e} of the CPU's"
                        for m, e in worst.items()))


def transform_memory(dev, rng, sizes=64):
    """image_transform over `sizes` distinct source sizes: the card memory
    allocated above the start at the peak, and after (none may stay)."""
    from missm_tpu_torch.ops.image_transforms import image_transform

    shapes = set()
    while len(shapes) < sizes:
        shapes.add((int(rng.integers(300, 800)), int(rng.integers(300, 1300))))
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for h, w in sorted(shapes):
        image_transform(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 224,
                        device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - start
    held = torch.cuda.memory_allocated(dev) - start
    if held:
        raise AssertionError(f"image_transform holds {held} B of card "
                             f"memory after {sizes} source sizes")
    return (f"image_transform over {sizes} distinct source sizes: peak "
            f"{peak / 2**20:.2f} MiB of card memory above the start, "
            f"{held} B held after")


def data_phase(dev, rng, card, profile):
    """The data layer on the card: a mvsa-style tree on disk (DATA_SPLITS
    rows of JPEGs at DATA_SIZES) through the port's testing_loader and
    production media loaders (PIL decode, image_transform on the card) into
    run_missing_sweep(concat_mean) of the flagship concat model (bf16
    encoder), 3 missing types x 10 loaders and the statistics pass; then two
    train steps of the flagship `sum` model (4 x 16) on training_loader's
    batches with train-time missing codes. Checks the launches per batch
    and per step, 30 finite report blocks, finite losses with the watched
    leaves moved and the frozen ones not, the disk batches against the
    same loaders built on the CPU, and each transform on the card against
    the CPU."""
    import random

    from missm_tpu_torch.data.ingest_io import decode_image
    from missm_tpu_torch.data.loaders import (_decode_pool, testing_loader,
                                              training_loader)
    from missm_tpu_torch.data.preprocess import make_media_loaders
    from missm_tpu_torch.eval.sweep import run_missing_sweep
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import (init_train_state, make_eval_step,
                                            make_train_step)
    from missm_tpu_torch.train.trainability import (FROZEN, leaves,
                                                    param_labels)

    transform_checks(dev, rng, card)
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        csv = write_mvsa_tree(root, rng)
        print(f"data: wrote {sum(DATA_SPLITS.values())} rows {DATA_SPLITS} "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        # --- the sweep from disk
        cfg = flagship_config("bfloat16", fusion_type="concat")
        params = finetune.init_model_params(cfg, seed=0, device=dev)
        params = {"encoder": finetune.cast_tree(params["encoder"],
                                                torch.bfloat16),
                  "fusion": params["fusion"]}
        tok = data_tokenizer(cfg)
        train, test, classes = testing_loader(
            data_args(), csv, tok, make_media_loaders(cfg.tower_dict,
                                                      device=dev))
        if classes != cfg.fusion.output_dims or len(test) != 3:
            raise AssertionError(f"data: {classes} classes, types {list(test)}")
        eval_step = make_eval_step(cfg, device=dev)
        eval_step(params, *next(iter(test["mixed"][0.9])))  # warm-up
        torch.cuda.synchronize()
        n_vision, n_text = layers(cfg)
        with tempfile.TemporaryDirectory() as out:
            K.reset_launches()
            t0 = time.perf_counter()
            results = run_missing_sweep(params, cfg, eval_step, test, out,
                                        "mvsa", "concat_mean",
                                        train_loader=train, verbose=False,
                                        device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            paths["data sweep"] = launches = dict(K.LAUNCHES)
            blocks = []
            for mt in SWEEP_TYPES:
                with open(os.path.join(out, f"mvsa_concat_mean_{mt}.txt"),
                          encoding="utf-8") as f:
                    blocks += [b for b in f.read().split("\n\n") if b]
        batches = COVERS["data sweep"]
        want = dict(dict.fromkeys(launches, 0), attention=n_vision * batches,
                    causal_attention=n_text * batches)
        numbers = [float(line.rsplit(": ", 1)[1]) for b in blocks
                   for line in b.splitlines()[2:]]
        rows = (len(SWEEP_TYPES) * 10 * DATA_SPLITS["test"]
                + DATA_SPLITS["train"])
        print(f"data sweep from disk (smoke reading): {len(blocks)} report "
              f"blocks, {rows} rows ({batches} batches, {DATA_WORKERS} "
              f"decode threads) in {dt:.4f} s = {rows / dt:.2f} rows/s, "
              f"{dt / batches * 1e3:.3f} ms a batch; launches {launches}; "
              "mixed "
              + "; ".join(f"{r}: acc {m['accuracy']:.4f} auc {m['auc']:.4f}"
                          for r, m in results["mixed"].items())
              + f" [{card}]", flush=True)
        if (launches != want or len(blocks) != len(SWEEP_TYPES) * 10
                or len(numbers) != 4 * len(blocks)
                or not all(math.isfinite(x) for x in numbers)):
            raise AssertionError(f"data sweep: launches {launches} (expected "
                                 f"{want}), {len(blocks)} blocks, numbers "
                                 f"{numbers}")

        # --- the loader alone (decode and transforms, no model), then its
        # batches and the train loader's against the same loaders on the CPU
        t0 = time.perf_counter()
        card_mixed = list(test["mixed"][0.5])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        files = test["mixed"][0.5].dataset.data["image"]
        t0 = time.perf_counter()
        list(_decode_pool(DATA_WORKERS).map(decode_image, files))
        dt_decode = time.perf_counter() - t0
        print(f"data loader alone (smoke readings): {len(files)} rows in "
              f"{dt:.4f} s = {len(files) / dt:.2f} rows/s; their PIL decode "
              f"alone on {DATA_WORKERS} threads {dt_decode:.4f} s = "
              f"{len(files) / dt_decode:.2f} rows/s [{card}]", flush=True)
        t0 = time.perf_counter()
        cpu_train, cpu_test, _ = testing_loader(
            data_args(), csv, tok, make_media_loaders(cfg.tower_dict,
                                                      device="cpu"))
        worst = max(same_batches("train", dev, list(train), list(cpu_train)),
                    same_batches("mixed 0.5", dev, card_mixed,
                                 list(cpu_test["mixed"][0.5])))
        print(f"data batches, card vs CPU: {DATA_SPLITS['train']} train + "
              f"{DATA_SPLITS['test']} test rows equal (ids, masks, labels, "
              f"codes), images within {worst:.2e} (limit "
              f"{DATA_TOL['atol']} + {DATA_TOL['rtol']} |ref|), "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del params, eval_step, train, test, cpu_train, cpu_test, card_mixed

        # --- two train steps on training_loader's batches
        cfg = flagship_config("bfloat16")
        params = finetune.init_model_params(cfg, seed=0, device=dev)
        state, tx = init_train_state(params, cfg)
        step = make_train_step(cfg, tx, accum_steps=ACCUM, device=dev)
        random.seed(0)  # the train-time missing codes
        loader, _, _ = training_loader(
            data_args(fusion_type="sum", train_missing=True), csv, tok,
            make_media_loaders(cfg.tower_dict, device=dev))
        blocks_v = params["encoder"]["image"]["vision"]["blocks"]
        moving = {"vision block 0 q lora_b": blocks_v[0]["attn"]["q"]
                  ["lora_b"],
                  "text block 0 q w": params["encoder"]["language"]["text"]
                  ["blocks"][0]["attn"]["q"]["w"],
                  "fusion proj image w": params["fusion"]["proj"]["image"]
                  ["w"]}
        before = {k: t.clone() for k, t in moving.items()}
        frozen = [(t, t.clone()) for t, lab in zip(
            leaves(params), leaves(param_labels(params, cfg)))
            if lab == FROZEN]
        gen = torch.Generator(device=dev).manual_seed(0)
        K.reset_launches()
        losses, codes, times = [], [], []
        t0 = time.perf_counter()
        for data, labels, missing in loader:
            state, m = step(state, data, labels, missing, LR, gen)
            losses.append(m["loss"].item())
            codes += missing.tolist()
            times.append(time.perf_counter() - t0)
        dt = times[-1]
        paths["data train"] = launches = dict(K.LAUNCHES)
        steps = COVERS["data train"]
        want = dict(dict.fromkeys(launches, 0),
                    attention=n_vision * ACCUM * steps,
                    attention_bwd=n_vision * ACCUM * steps,
                    causal_attention=n_text * ACCUM * steps)
        still = [k for k, t in moving.items() if torch.equal(t, before[k])]
        moved = sum(not torch.equal(t, t0_) for t, t0_ in frozen)
        print(f"data train from disk: {len(losses)} steps of B={B} "
              f"({ACCUM} x {B // ACCUM}) in {dt:.4f} s, each with its "
              f"batch's decode (the first warms up): "
              f"{[round(b - a, 4) for a, b in zip([0.0] + times, times)]} "
              f"s, losses {[round(x, 4) for x in losses]}, codes "
              f"{sorted(set(codes))}, launches {launches} [{card}]",
              flush=True)
        if (launches != want or len(losses) != steps
                or not all(math.isfinite(x) for x in losses) or still
                or moved or not set(codes) <= {0, 1, 4}):
            raise AssertionError(f"data train: launches {launches} (expected "
                                 f"{want}), losses {losses}, unmoved {still}, "
                                 f"{moved} frozen leaves moved, codes "
                                 f"{set(codes)}")
    return paths


# ---------------------------------------------------------------------------
# cli: the entry points on a dataset on disk
# ---------------------------------------------------------------------------

class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


@contextlib.contextmanager
def captured():
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee


@contextlib.contextmanager
def checkpoint_writes(log):
    """Every checkpoint write (train/checkpoint.py::_write, on the writer
    thread) timed, appended to `log` as (name, seconds, bytes)."""
    from missm_tpu_torch.train import checkpoint as ck

    real = ck._write

    def timed(path, host_tree, metadata):
        t0 = time.perf_counter()
        real(path, host_tree, metadata)
        log.append((os.path.basename(path), time.perf_counter() - t0,
                    os.path.getsize(os.path.join(path, ck.TREE_FILE))))
    ck._write = timed
    try:
        yield log
    finally:
        ck._write = real


@contextlib.contextmanager
def lse_launches(counts):
    """Counts the attention forward launches that write the log-sum-exp
    (kernels/attention.py::_launch with want_lse) in counts["lse"]."""
    from missm_tpu_torch.kernels import attention as K

    real = K._launch

    def launch(*a, **kw):
        if kw.get("want_lse"):
            counts["lse"] += 1
        return real(*a, **kw)
    K._launch = launch
    try:
        yield counts
    finally:
        K._launch = real


@contextlib.contextmanager
def first_losses(log):
    """The loss of each train loop's first step (train/loop.py's step_fn),
    appended to `log` as a tensor: read later, so nothing waits on the
    card."""
    from missm_tpu_torch.train import loop

    real = loop.make_train_step

    def make(*a, **kw):
        step, first = real(*a, **kw), []

        def step_fn(*sa, **skw):
            out = step(*sa, **skw)
            if not first:
                first.append(True)
                log.append(out[1]["loss"])
            return out
        return step_fn
    loop.make_train_step = make
    try:
        yield log
    finally:
        loop.make_train_step = real


@contextlib.contextmanager
def dequantized(counts):
    """Counts the uint8 media batches the model dequantizes
    (models/finetune.py::_dequantize) in counts["u8"]."""
    from missm_tpu_torch.models import finetune

    real = finetune._dequantize

    def deq(x, dtype):
        counts["u8"] += 1
        return real(x, dtype)
    finetune._dequantize = deq
    try:
        yield counts
    finally:
        finetune._dequantize = real


def cli_argv(csv, dev, *extra):
    return ["--datasetName", "mvsa", "--csv_path", csv, "--model_scale",
            CLI_SCALE, "--hash_tokenizer", "--fusion_type", "sum",
            "--modality_types", "language", "image", "--device", dev.type,
            *extra]


def cli_train_expect(n_vision, n_text, steps, val_batches):
    """The launches of `steps` train steps under the CLI's default remat
    (each block's forward runs twice: once, recorded, in the forward, and
    again in the backward's recompute, whose log-sum-exp the backward
    kernel reads) and of `val_batches` eval batches."""
    return {"attention": n_vision * (2 * steps + val_batches),
            "attention_bwd": n_vision * steps,
            "causal_attention": n_text * (2 * steps + val_batches)}


def check_launches(name, launches, want, lse=None, lse_want=None):
    want = dict(dict.fromkeys(launches, 0), **want)
    if launches != want or lse != lse_want:
        raise AssertionError(f"{name}: launches {launches} (expected {want}),"
                             f" log-sum-exp writes {lse} (expected "
                             f"{lse_want})")


def train_report(name, hist, writes, card):
    for h in hist:
        rate = h["n_batches"] * CLI_BATCH / (h["input_s"] + h["step_s"])
        print(f"{name} epoch {h['epoch'] + 1} (smoke reading): {h['n_batches']}"
              f" steps of B={CLI_BATCH} in {h['input_s'] + h['step_s']:.4f} s"
              f" = {rate:.2f} samples/s, duty {h['duty']:.3f}, a step alone "
              f"{h['step_ms']:.3f} ms, train loss {h['train_loss']:.4f}, val "
              f"loss {h['val_loss']:.4f} acc {h['val_accuracy']:.4f} "
              f"[{card}]", flush=True)
    print(f"{name} checkpoint writes (smoke readings): "
          + "; ".join(f"{p} {s:.3f} s {b / 2**30:.3f} GiB "
                      f"({b / 2**30 / s:.3f} GiB/s)" for p, s, b in writes)
          + f" [{card}]", flush=True)


def cli_preemption(dev, root, csv, card):
    """cli.train in a subprocess (--frozen_bf16, its own directory and
    --save_path, --profile_dir), SIGTERM after its first "Epoch 1/" line:
    exit 75, a `last` whose metadata holds `preempted` and a Chrome trace
    holding device kernels; then --resume auto: exit 0."""
    import signal
    import threading

    from missm_tpu_torch.train.checkpoint import read_metadata

    run = os.path.join(root, "preempt")
    os.makedirs(run)
    trace = os.path.join(run, "trace", "train_trace.json")
    argv = cli_argv(csv, dev, "--init", "random", "--batch_size",
                    str(CLI_BATCH), "--num_epochs", "2", "--seed", "0",
                    "--frozen_bf16", "--save_path", "preempt_ckpt")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    codes, outs = [], []
    # the first run also traces epoch-0 batches 4-6 (--profile_dir)
    for extra in (["--profile_dir", os.path.dirname(trace)],
                  ["--resume", "auto"]):
        first = extra[0] == "--profile_dir"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "missm_tpu_torch.cli.train", *argv,
             *extra], cwd=run, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        watchdog = threading.Timer(CLI_CHILD_TIMEOUT, proc.kill)
        watchdog.start()
        lines, signalled = [], None
        try:
            for line in proc.stdout:
                lines.append(line)
                if first and signalled is None and line.startswith(
                        "Epoch 1/"):
                    proc.send_signal(signal.SIGTERM)
                    signalled = time.perf_counter() - t0
            proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        codes.append(proc.returncode)
        outs.append("".join(lines))
        print(f"cli preemption {'run' if first else 'resume'}: exit "
              f"{proc.returncode} after {time.perf_counter() - t0:.1f} s"
              + (f", SIGTERM at {signalled:.1f} s" if signalled else ""),
              flush=True)
        if first:
            meta = read_metadata(os.path.join(
                run, "experiments", "mvsa_sum", "preempt_ckpt", "last"))
            print(f"cli preemption: last holds loop epoch "
                  f"{(meta or {}).get('loop', {}).get('epoch')}, preempted "
                  f"{(meta or {}).get('preempted')}", flush=True)
    events, kernels = [], 0
    if os.path.exists(trace):
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(e.get("cat") == "kernel" for e in events)
        print(f"cli --profile_dir: a Chrome trace of {len(events)} events, "
              f"{kernels} of them device kernels, "
              f"{os.path.getsize(trace) / 2**20:.1f} MiB", flush=True)
    traced = kernels if dev.type == "cuda" else len(events)
    if codes != [75, 0] or not (meta and "preempted" in meta) or \
            "continuing at epoch 2" not in outs[1] or not traced:
        raise AssertionError(f"cli preemption: exit codes {codes} (expected "
                             f"[75, 0]), metadata {meta}, {kernels} kernels "
                             "traced; output:\n"
                             + "\n---\n".join(o[-3000:] for o in outs))


def cli_converter(dev, card):
    """cli.common.init_params --init checkpoint on the committed fixture
    checkpoints (tests/fixtures/lb_ckpt, five tiny towers) on the card, f32
    with TF32 off: each tower's vision features and the language alias's
    text features against the reference towers' (expected.npz) at
    tests/test_checkpoint_fixture.py's tolerances."""
    from missm_tpu_torch.cli.common import build_model_config, init_params
    from missm_tpu_torch.models.tower import text_features, vision_features

    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "lb_ckpt")
    mods = ["image", "video", "audio", "depth", "thermal"]
    args = argparse.Namespace(
        modality_types=["language", *mods], model_scale="tiny",
        init="checkpoint", checkpoint_dir=fix, fusion_type="sum",
        feature_dims=24, fusion_dim=8, dropout_prob=0.1, bf16=False,
        remat=False, device=dev.type)
    exp = dict(np.load(os.path.join(fix, "expected.npz")))
    cfg = build_model_config(args, 3)
    errs = {}
    with no_tf32(), torch.no_grad():
        params = init_params(args, cfg, 0)
        for m in mods:
            tp = params["encoder"][m]
            got = vision_features(tp["vision"], cfg.tower_dict[m].vision,
                                  torch.as_tensor(exp[m], device=dev),
                                  projection=tp["proj"]).cpu().numpy()
            np.testing.assert_allclose(got, exp[f"{m}_features"],
                                       **CONVERT_TOL)
            errs[m] = float(np.abs(got - exp[f"{m}_features"]).max())
        lp = params["encoder"]["language"]
        _, got = text_features(lp["text"], cfg.tower_dict["thermal"].text,
                               torch.as_tensor(exp["ids"], device=dev),
                               projection=lp["proj"])
        got = got.cpu().numpy()
        np.testing.assert_allclose(got, exp["thermal_text_features"],
                                   **CONVERT_TOL)
        errs["text (thermal's)"] = float(
            np.abs(got - exp["thermal_text_features"]).max())
    print(f"cli converter: {len(mods)} fixture towers converted on the card, "
          "features against the reference's within "
          + ", ".join(f"{m} {e:.2e}" for m, e in errs.items())
          + f" (limit {CONVERT_TOL}) [{card}]", flush=True)


@contextlib.contextmanager
def kept_probs():
    """Yields a list that receives the probs of each Predictor.predict
    call."""
    from missm_tpu_torch.eval.predictor import Predictor

    real, kept = Predictor.predict, []

    def predict(self, *a, **kw):
        preds, probs = real(self, *a, **kw)
        kept.append(probs)
        return preds, probs
    Predictor.predict = predict
    try:
        yield kept
    finally:
        Predictor.predict = real


def predict_rank(spec: dict, rank: int) -> dict:
    """One rank of the cli phase's cli.predict world (cli_predict_ranks):
    joins the gloo group on the card, then runs `python -m
    missm_tpu_torch.cli.predict --distributed true ...` of each layout in
    turn; returns each run's launches, seconds and peak memory."""
    import datetime

    import torch.distributed as dist
    from missm_tpu_torch.cli import predict as cli_predict
    from missm_tpu_torch.kernels import attention as K

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            rank=rank, world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT))
    os.chdir(spec["cwd"])
    out = {}
    try:
        for name, argv in spec["runs"]:
            K.reset_launches()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cli_predict.main(argv)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = {
                "rank": rank, "seconds": time.perf_counter() - t0,
                "launches": dict(K.LAUNCHES),
                "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                             if dev.type == "cuda" else 0.0)}
    finally:
        dist.destroy_process_group()
    return out


def cli_predict_ranks(dev, run, pargv, one, one_probs, n_vision, n_text,
                      card):
    """cli.predict --distributed from the phase's final model on two ranks
    sharing the card over gloo (NCCL refuses two ranks on one device),
    under each layout of PREDICT_LAYOUTS in turn in one world: each rank
    predicts its data shard, K1 and K2(a) exact a rank, and rank 0's
    predictions.csv against the one-process run's `one` (index and label
    equal, confidences within PREDICT_CONF_ATOL, preds equal wherever the
    one-process top-2 margin exceeds it). Returns the launches."""
    import pandas as pd

    rows = len(one)
    runs = [[name, pargv[:pargv.index("--output")] + flags + [
        "--output", f"pred_{name.replace(' ', '_')}.csv",
        "--distributed", "true"]] for name, flags in PREDICT_LAYOUTS.items()]
    res = par_world("cli predict", dict(
        world=2, backend="gloo", device=dev.type, cwd=run, runs=runs), run,
        card, mode="--predict-rank")
    top2 = np.sort(one_probs, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    launches = {}
    for name, argv in runs:
        per = [r[name] for r in res]
        # round_eval_batch: the global batch over the data axis
        n_data = 2 if name.startswith("DP") else 1
        rank_batch = int(argv[argv.index("--batch_size") + 1]) // n_data
        shard = -(-rows // n_data)
        batches = -(-shard // rank_batch)
        want = {"attention": n_vision * batches,
                "causal_attention": n_text * batches}
        got = pd.read_csv(argv[argv.index("--output") + 1])
        conf = np.abs(got["confidence"].to_numpy()
                      - one["confidence"].to_numpy())
        differ = got["pred"].to_numpy() != one["pred"].to_numpy()
        near = margin <= PREDICT_CONF_ATOL
        rate = rows / max(r["seconds"] for r in per)
        RATES[f"cli predict {name}"] = rate
        print(f"cli predict {name} (smoke reading): {rows} rows on 2 ranks "
              f"in {max(r['seconds'] for r in per):.2f} s = {rate:.2f} "
              f"rows/s (the process's restore and loaders included), peaks "
              f"{[round(r['peak_gib'], 3) for r in per]} GiB, launches a "
              f"rank {[r['launches'] for r in per]} (expected {want}); "
              f"against one process: confidence max |diff| "
              f"{conf.max():.2e} (limit {PREDICT_CONF_ATOL}), "
              f"{int(differ.sum())} preds differ, all among the "
              f"{int(near.sum())} rows whose top-2 margin is within "
              f"{PREDICT_CONF_ATOL} [{card}]", flush=True)
        if not (len(got) == rows
                and np.array_equal(got["index"], one["index"])
                and np.array_equal(got["label"], one["label"])
                and conf.max() <= PREDICT_CONF_ATOL
                and not (differ & ~near).any()):
            raise AssertionError(f"cli predict {name}: the two ranks' rows "
                                 "disagree with one process's")
        for r in per:
            check_launches(f"cli predict {name} rank {r['rank']}",
                           r["launches"], want)
        launches[f"cli predict {name}"] = {
            k: sum(r["launches"].get(k, 0) for r in per)
            for k in per[0]["launches"]}
    return launches


def cli_uint8(dev, root, csv, card, n_vision, n_text, f32_hist, loss0_f32,
              targv, f32_sweep_rate):
    """--uint8_upload true through the entry points: one cli.train epoch
    (its own working directory, the phase's argv at 1 epoch) against the
    phase's first run (`f32_hist`, with `loss0` its first step's loss):
    the same launches, every batch dequantized by the model, the first
    step's loss within U8_LOSS_RTOL; the cli.test sweep of `targv`'s mixed
    type on the phase's final model, with the flag and then without; and
    the loaders' uint8 batch of 16 images on the card, dequantized, within
    0.5/255/min(std) + 1e-4 of the f32 batch (tests/test_uint8_upload.py's
    bound), the two loaders timed in turns. Returns the launches."""
    from missm_tpu_torch.cli import test as cli_test
    from missm_tpu_torch.cli import train as cli_train
    from missm_tpu_torch.cli.common import build_model_config
    from missm_tpu_torch.compat.args import train_args
    from missm_tpu_torch.data.preprocess import make_media_loaders
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.ops.image_transforms import OPENAI_STD

    paths = {}
    here = os.getcwd()
    u8run = os.path.join(root, "u8run")
    os.makedirs(u8run)
    os.chdir(u8run)
    try:
        argv = cli_argv(csv, dev, "--init", "random", "--batch_size",
                        str(CLI_BATCH), "--num_epochs", "1", "--seed", "0",
                        "--uint8_upload", "true")
        steps = DATA_SPLITS["train"] // CLI_BATCH
        val = DATA_SPLITS["valid"] // CLI_BATCH
        writes, lse, loss0, deq = [], {"lse": 0}, [], {"u8": 0}
        K.reset_launches()
        with checkpoint_writes(writes), lse_launches(lse), \
                first_losses(loss0), dequantized(deq):
            _, hist = cli_train.main(argv)
        paths["cli train --uint8_upload"] = launches = dict(K.LAUNCHES)
        check_launches("cli train --uint8_upload", launches,
                       cli_train_expect(n_vision, n_text, steps, val),
                       lse["lse"], n_vision * 2 * steps)
        train_report("cli train --uint8_upload", hist, writes, card)
    finally:
        os.chdir(here)
    u8_loss0, f32_loss0 = float(loss0[0]), loss0_f32

    def rate(h):
        return h["n_batches"] * CLI_BATCH / (h["input_s"] + h["step_s"])
    print(f"cli --uint8_upload train (smoke reading): first step's loss "
          f"{u8_loss0:.6f} against the f32 upload's {f32_loss0:.6f} "
          f"(|diff| {abs(u8_loss0 - f32_loss0):.2e}, limit "
          f"{U8_LOSS_RTOL} relative); its epoch {rate(hist[0]):.2f} "
          f"samples/s against the f32 run's epochs "
          f"{', '.join(f'{rate(h):.2f}' for h in f32_hist)} (its first the "
          f"process's first, cold); {deq['u8']} uint8 batches dequantized "
          f"by the model (expected {steps + val}) [{card}]", flush=True)
    if not (math.isfinite(u8_loss0) and len(hist) == 1
            and math.isfinite(hist[0]["train_loss"])
            and abs(u8_loss0 - f32_loss0) <= U8_LOSS_RTOL * abs(f32_loss0)
            and deq["u8"] == steps + val):
        raise AssertionError(f"cli train --uint8_upload: loss {u8_loss0} "
                             f"against {f32_loss0}, history {hist}, "
                             f"{deq['u8']} batches dequantized")

    # --- the sweep on the phase's final model, the mixed missing type's
    # 10 loaders with the flag and then without it, in turn
    mixed = targv[:targv.index("--test_missing_type") + 1] + ["mixed"] + \
        targv[targv.index("--batch_size"):]
    batches = 10 * -(-DATA_SPLITS["test"] // 64)
    rows, sweep = 10 * DATA_SPLITS["test"], {}
    for q in (True, False):
        deq = {"u8": 0}
        K.reset_launches()
        t0 = time.perf_counter()
        with dequantized(deq):
            results = cli_test.main(mixed + ["--uint8_upload", str(q).lower()])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        if q:
            paths["cli test --uint8_upload"] = launches
        check_launches(f"cli test --uint8_upload {str(q).lower()}", launches,
                       {"attention": n_vision * batches,
                        "causal_attention": n_text * batches})
        numbers = [m[k] for m in results["sum"]["mixed"].values()
                   for k in ("loss", "accuracy")]
        sweep[q] = (rows / dt, results["sum"]["mixed"])
        if deq["u8"] != (batches if q else 0) or not all(
                math.isfinite(x) for x in numbers):
            raise AssertionError(f"cli test --uint8_upload {q}: "
                                 f"{deq['u8']} batches dequantized of "
                                 f"{batches}, {numbers}")
    print(f"cli --uint8_upload test (smoke reading): the mixed type's "
          f"{rows} rows ({batches} batches, each dequantized) "
          f"{sweep[True][0]:.2f} rows/s, then without the flag "
          f"{sweep[False][0]:.2f} (the process's setup and the checkpoint "
          f"load included; the full f32 sweep before them "
          f"{f32_sweep_rate:.2f}); accuracy by ratio with / without "
          + "; ".join(f"{r}: {m['accuracy']:.4f} / "
                      f"{sweep[False][1][r]['accuracy']:.4f}"
                      for r, m in sweep[True][1].items())
          + f" [{card}]", flush=True)

    # --- the loaders' batch on the card, dequantized; timed in turns
    tower = build_model_config(train_args(argv), 10).tower_dict
    imgs = [os.path.join(os.path.dirname(csv), "data", f"{i}.jpg")
            for i in range(16)]
    load = {q: make_media_loaders(tower, quantized=q, device=dev)["image"]
            for q in (True, False)}
    batch = {q: torch.stack([load[q](p) for p in imgs]) for q in load}
    ms = {True: [], False: []}
    for q in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.stack([load[q](p) for p in imgs])
        torch.cuda.synchronize()
        ms[q].append((time.perf_counter() - t0) * 1000 / len(imgs))
    u8, f32 = batch[True], batch[False]
    err = float((finetune._dequantize(u8, torch.float32) - f32).abs().max())
    limit = 0.5 / 255 / min(OPENAI_STD) + 1e-4
    print(f"cli --uint8_upload loaders: a batch of {len(imgs)} images "
          f"{u8.dtype} {tuple(u8.shape)} on {u8.device} "
          f"({u8.numel() * u8.element_size() / 2**20:.2f} MiB against "
          f"{f32.numel() * f32.element_size() / 2**20:.2f} MiB of f32), "
          f"dequantized within {err:.2e} of the f32 batch (limit "
          f"{limit:.2e}); decode + transform ms a sample in turns "
          f"{ms[True][0]:.3f}, {ms[False][0]:.3f}, {ms[False][1]:.3f}, "
          f"{ms[True][1]:.3f} (uint8, f32, f32, uint8) [{card}]", flush=True)
    if not (u8.dtype == torch.uint8 and u8.device.type == dev.type
            and u8.shape == f32.shape and err <= limit):
        raise AssertionError(f"cli --uint8_upload loaders: {u8.dtype} "
                             f"{tuple(u8.shape)}, error {err}")
    return paths


def cli_phase(dev, rng, card, profile):
    """The entry points on the card (missm_tpu_torch.cli), from the data
    phase's mvsa tree written anew to a temporary directory that is the
    working directory meanwhile: cli.train (flagship at full width, seeded
    random init, bf16 encoder, default remat, B=16, 2 epochs, a resume
    checkpoint every epoch), the same command resumed to 3 epochs, a
    SIGTERM'd subprocess and its --resume auto, cli.test (sum, 3 missing
    types x 10 loaders), cli.predict, and the converter on the fixtures.
    Returns the launch counts of the train, resume, test and predict
    runs."""
    from missm_tpu_torch.cli import predict as cli_predict
    from missm_tpu_torch.cli import test as cli_test
    from missm_tpu_torch.cli import train as cli_train
    from missm_tpu_torch.cli.common import build_model_config, init_params
    from missm_tpu_torch.compat.args import train_args
    from missm_tpu_torch.eval.predictor import Predictor
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.checkpoint import (read_metadata,
                                                  restore_checkpoint)
    from missm_tpu_torch.train.trainability import (FROZEN, leaves,
                                                    param_labels)

    paths = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        csv = write_mvsa_tree(os.path.join(root, "mvsa"), rng)
        run = os.path.join(root, "run")
        os.makedirs(run)
        os.chdir(run)
        try:
            # --- train, 2 epochs
            argv = cli_argv(csv, dev, "--init", "random", "--batch_size",
                            str(CLI_BATCH), "--num_epochs", "2",
                            "--checkpoint_every", "1", "--seed", "0")
            args = train_args(argv)
            cfg = build_model_config(args, 10)
            n_vision, n_text = layers(cfg)
            steps = DATA_SPLITS["train"] // CLI_BATCH
            val = DATA_SPLITS["valid"] // CLI_BATCH
            writes, lse, loss0 = [], {"lse": 0}, []
            K.reset_launches()
            t0 = time.perf_counter()
            with checkpoint_writes(writes), lse_launches(lse), \
                    first_losses(loss0):
                best, hist = cli_train.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            paths["cli train"] = launches = dict(K.LAUNCHES)
            check_launches("cli train", launches, cli_train_expect(
                n_vision, n_text, 2 * steps, 2 * val), lse["lse"],
                n_vision * 2 * 2 * steps)
            print(f"cli train: {len(hist)} epochs in {dt:.1f} s; launches "
                  f"{launches} = {2 * steps} steps x (K1 {2 * n_vision}, K3 "
                  f"{n_vision}, K2(a) {2 * n_text}) + {2 * val} val batches "
                  f"x (K1 {n_vision}, K2(a) {n_text}); {lse['lse']} K1 "
                  f"launches wrote the log-sum-exp (every train-step K1, "
                  f"recompute included)", flush=True)
            train_report("cli train", hist, writes, card)
            ckpt = os.path.join("experiments", "mvsa_sum", "checkpoints")
            final = os.path.join("final_model", "mvsa_sum")
            metrics = [h[k] for h in hist for k in (
                "train_loss", "val_loss", "val_accuracy", "val_f1",
                "val_auc")]
            last = read_metadata(os.path.join(ckpt, "last"))
            if not (len(hist) == 2 and all(math.isfinite(x) for x in metrics)
                    and os.path.isdir(os.path.join(ckpt, "best_model"))
                    and last and last["loop"]["epoch"] == 1
                    and os.path.isdir(final)):
                raise AssertionError(f"cli train: history {hist}, "
                                     f"{os.listdir(ckpt)}, last {last}")
            # the final model: frozen leaves those of a fresh init at the
            # seed, bit for bit; the watched trainable leaves moved
            tree, meta = restore_checkpoint(final)
            fresh = init_params(args, cfg, 0)
            labels = leaves(param_labels(fresh, cfg))
            got, want = leaves(tree["params"]), leaves(fresh)
            frozen_moved = sum(
                not torch.equal(g, w.cpu()) for g, w, lab in
                zip(got, want, labels) if lab == FROZEN)
            n_frozen = sum(lab == FROZEN for lab in labels)
            watched = {
                "vision block 0 q lora_b": lambda p: p["encoder"]["image"]
                ["vision"]["blocks"][0]["attn"]["q"]["lora_b"],
                "vision last block v lora_a": lambda p: p["encoder"]["image"]
                ["vision"]["blocks"][-1]["attn"]["v"]["lora_a"],
                "fusion proj image w": lambda p: p["fusion"]["proj"]["image"]
                ["w"]}
            still = [k for k, f in watched.items()
                     if torch.equal(f(tree["params"]), f(fresh).cpu())]
            print(f"cli final model (best epoch {meta['best_epoch']}): "
                  f"{n_frozen} frozen leaves equal a fresh init's, "
                  f"{frozen_moved} differ; watched trainable leaves moved: "
                  f"{[k for k in watched if k not in still]}", flush=True)
            if frozen_moved or still or len(got) != len(want):
                raise AssertionError(f"cli final model: {frozen_moved} frozen "
                                     f"leaves differ, unmoved {still}")
            del fresh, tree, best

            # --- the same command resumed to 3 epochs
            argv3 = [a if a != "2" or argv[i - 1] != "--num_epochs" else "3"
                     for i, a in enumerate(argv)] + ["--resume", "auto"]
            K.reset_launches()
            writes, lse = [], {"lse": 0}
            with captured() as out, checkpoint_writes(writes), \
                    lse_launches(lse):
                _, hist3 = cli_train.main(argv3)
            paths["cli resume"] = launches = dict(K.LAUNCHES)
            check_launches("cli resume", launches, cli_train_expect(
                n_vision, n_text, steps, val), lse["lse"],
                n_vision * 2 * steps)
            train_report("cli resume", hist3[2:], writes, card)
            if not ("continuing at epoch 3" in out.text()
                    and len(hist3) == 3 and hist3[:2] == hist
                    and math.isfinite(hist3[2]["train_loss"])):
                raise AssertionError(f"cli resume: history {hist3} against "
                                     f"{hist}")
            print(f"cli resume: continued at epoch 3, history[:2] equal to "
                  f"the first run's; launches {launches}", flush=True)

            # --- SIGTERM in a subprocess, then --resume auto
            torch.cuda.empty_cache()
            cli_preemption(dev, root, csv, card)

            # --- the sweep
            targv = cli_argv(csv, dev, "--test_types", "sum",
                             "--test_missing_type", "language", "image",
                             "mixed", "--batch_size", "64")
            K.reset_launches()
            t0 = time.perf_counter()
            results = cli_test.main(targv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            paths["cli test"] = launches = dict(K.LAUNCHES)
            batches = 30 * -(-DATA_SPLITS["test"] // 64)
            check_launches("cli test", launches, {
                "attention": n_vision * batches,
                "causal_attention": n_text * batches})
            pat = re.compile(
                r"Testing with missing ratio: [\d.]+\nTest Results:\n"
                r"Test Loss: -?\d+\.\d{4}\nTest Accuracy: \d+\.\d{4}\n"
                r"Test F1 Score: \d+\.\d{4}\nTest AUC: \d+\.\d{4}")
            blocks = []
            for mt in SWEEP_TYPES:
                with open(os.path.join("new_txt_experiment",
                                       f"mvsa_sum_{mt}.txt")) as f:
                    blocks += [b for b in f.read().split("\n\n") if b]
            numbers = [float(line.rsplit(": ", 1)[1]) for b in blocks
                       for line in b.splitlines()[2:]]
            rows = 30 * DATA_SPLITS["test"]
            sweep_rate = rows / dt
            print(f"cli test (smoke reading): {len(blocks)} report blocks, "
                  f"{rows} rows ({batches} batches) in {dt:.4f} s = "
                  f"{rows / dt:.2f} rows/s, the process's setup and the "
                  f"checkpoint load included; launches {launches}; mixed "
                  + "; ".join(f"{r}: acc {m['accuracy']:.4f}"
                              for r, m in results["sum"]["mixed"].items())
                  + f" [{card}]", flush=True)
            if (len(blocks) != 30 or not all(pat.fullmatch(b.strip())
                                             for b in blocks)
                    or not all(math.isfinite(x) for x in numbers)):
                raise AssertionError(f"cli test: {len(blocks)} blocks: "
                                     f"{blocks}")

            # --- predictions
            pargv = cli_argv(csv, dev, "--batch_size", "64", "--split",
                             "test", "--output", "predictions.csv")
            K.reset_launches()
            t0 = time.perf_counter()
            with kept_probs() as one_probs:
                out = cli_predict.main(pargv)
            dt = time.perf_counter() - t0
            paths["cli predict"] = launches = dict(K.LAUNCHES)
            pbatches = -(-DATA_SPLITS["test"] // 64)
            check_launches("cli predict", launches, {
                "attention": n_vision * pbatches,
                "causal_attention": n_text * pbatches})
            pcfg = build_model_config(train_args(argv), 10)
            pred = Predictor.from_checkpoint(final, pcfg, batch_size=8,
                                             device=dev)
            tree, _ = restore_checkpoint(final)
            ids, mask = text_batch(rng, 8, vary_length=True)
            data = {"language": {"input_ids": ids, "attention_mask": mask},
                    "image": rng.standard_normal(
                        (8, 3, *pcfg.towers[0][1].vision.image_size)
                    ).astype(np.float32)}
            codes = np.array([0, 1, 4, 0, 1, 4, 0, 0])
            preds, probs = pred.predict_arrays(data, codes)
            with torch.inference_mode():
                logits, _ = finetune.model_forward(
                    {k: finetune.tree_map(lambda t: t.to(dev), v)
                     for k, v in tree["params"].items()}, pcfg, data, codes,
                    device=dev)
            same = (np.array_equal(preds, logits.argmax(-1).cpu().numpy())
                    and np.array_equal(probs, torch.softmax(
                        logits, -1).float().cpu().numpy()))
            print(f"cli predict: {len(out)} rows in {dt:.2f} s, labels "
                  f"{sorted(set(out['label']))}, preds in "
                  f"[{out['pred'].min()}, {out['pred'].max()}], launches "
                  f"{launches}; Predictor.from_checkpoint "
                  f"{'equals' if same else 'differs from'} model_forward on "
                  f"the restored params, probs sum to 1 within "
                  f"{np.abs(probs.sum(-1) - 1).max():.1e}", flush=True)
            if not (len(out) == DATA_SPLITS["test"] and same
                    and out["pred"].between(0, 9).all()
                    and out["label"].between(0, 9).all()
                    and np.abs(probs.sum(-1) - 1).max() <= 1e-5):
                raise AssertionError("cli predict: rows, labels or the "
                                     "from_checkpoint forward")
            del pred, tree

            # --- cli.predict over two ranks, then --uint8_upload
            torch.cuda.empty_cache()
            paths.update(cli_predict_ranks(dev, run, pargv, out,
                                           one_probs[0], n_vision, n_text,
                                           card))
            paths.update(cli_uint8(dev, root, csv, card, n_vision, n_text,
                                   hist, float(loss0[0]), targv, sweep_rate))
        finally:
            os.chdir(cwd)
    cli_converter(dev, card)
    return paths


def replays(policy, tag="attn_kernel_out"):
    """1 where the backward's recompute under `policy` runs a block's
    forward attention kernel again (its output, named `tag`, not kept),
    else 0; models/tower.py::REMAT_POLICIES names what each policy keeps."""
    from missm_tpu_torch.models.tower import REMAT_POLICIES

    if policy is False or policy == "save_most":
        return 0
    return int(policy is True or tag not in REMAT_POLICIES[policy])


def flagship_remat_expect(policy, n_vision, n_text, micro):
    """The flagship train step's launches over `micro` microbatches."""
    return {"attention": n_vision * micro * (1 + replays(policy)),
            "attention_bwd": n_vision * micro,
            "causal_attention": n_text * micro * (1 + replays(policy))}


def remat_policies(dev, rng, card):
    """Each named policy once on a 16-row flagship microbatch in f32 (TF32
    off): the gradients of the watched leaves against the no-remat ones on
    the card within REMAT_GRAD_RTOL, the exact launches and the peak memory.
    Returns the launch counts summed over the nine."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.models.tower import REMAT_POLICIES
    from missm_tpu_torch.train.step import compute_loss, partition_trainable
    from missm_tpu_torch.train.trainability import leaves

    b = B // ACCUM
    cfg = flagship_config("float32", dropout_prob=0.0)
    n_vision, n_text = layers(cfg)
    params = finetune.init_model_params(cfg, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for block in params["encoder"]["image"]["vision"]["blocks"]:
        for proj in block["attn"].values():
            proj["lora_b"].normal_(0.0, 0.01, generator=gen)
    partition_trainable(params, cfg)
    ids, mask = text_batch(rng, b, vary_length=True)
    data = {"language": {"input_ids": torch.as_tensor(ids, device=dev),
                         "attention_mask": torch.as_tensor(mask, device=dev)},
            "image": torch.as_tensor(rng.standard_normal(
                (b, 3, *cfg.towers[0][1].vision.image_size))
                .astype(np.float32), device=dev)}
    labels = torch.as_tensor(rng.integers(0, 10, b), device=dev)
    codes = torch.as_tensor(rng.choice([0, 1, 4], b), device=dev)
    watched = dict(flagship_moving(params), **{
        "vision block 0 q lora_a": params["encoder"]["image"]["vision"]
        ["blocks"][0]["attn"]["q"]["lora_a"],
        "vision last block out lora_a": params["encoder"]["image"]["vision"]
        ["blocks"][-1]["attn"]["out"]["lora_a"]})

    def grads(remat):
        for t in leaves(params):
            t.grad = None
        c = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        loss, _ = compute_loss(params, None, c, data, labels, codes, None,
                               device=dev)
        loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = {k: t.grad.clone() for k, t in watched.items()}
        return (out, dict(K.LAUNCHES), torch.cuda.max_memory_allocated(),
                dt)

    total = {}
    with no_tf32():
        grads(False)  # warm-up: cuBLAS plans
        ref, launches, peak, dt = grads(False)
        print(f"remat policies: no remat, {b} rows f32: peak "
              f"{peak / 2**30:.2f} GiB, {dt * 1e3:.1f} ms forward + backward, "
              f"launches {launches} [{card}]", flush=True)
        for policy in REMAT_POLICIES:
            got, launches, peak, dt = grads(policy)
            rel = max(((got[k] - ref[k]).norm() / ref[k].norm()).item()
                      for k in ref)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            print(f"remat policies: {policy}, {b} rows f32: peak "
                  f"{peak / 2**30:.2f} GiB, {dt * 1e3:.1f} ms forward + "
                  f"backward, launches {launches}, gradients vs no remat "
                  f"{rel:.2e} (limit {REMAT_GRAD_RTOL}) [{card}]",
                  flush=True)
            check_launches(f"remat {policy}", launches, flagship_remat_expect(
                policy, n_vision, n_text, 1))
            if not rel <= REMAT_GRAD_RTOL:
                raise AssertionError(f"remat {policy}: gradients {rel:.3e} "
                                     f"from no remat's")
    return total


def remat_cli(dev, rng, card):
    """cli.train --remat save_attn_mlp_qkv_kern on the data phase's tree,
    written anew: one epoch at B=16, K1 24, K3 24 and K2(a) 12 a step (no
    forward kernel again in the backward), every train-step K1 writing the
    log-sum-exp, and K1 24, K2(a) 12 a val batch."""
    from missm_tpu_torch.cli import train as cli_train
    from missm_tpu_torch.cli.common import build_model_config
    from missm_tpu_torch.compat.args import train_args
    from missm_tpu_torch.kernels import attention as K

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        csv = write_mvsa_tree(os.path.join(root, "mvsa"), rng)
        os.makedirs(os.path.join(root, "run"))
        os.chdir(os.path.join(root, "run"))
        try:
            argv = cli_argv(csv, dev, "--init", "random", "--batch_size",
                            str(CLI_BATCH), "--num_epochs", "1", "--seed",
                            "0", "--remat", REMAT_BENCH)
            n_vision, n_text = layers(build_model_config(train_args(argv),
                                                         10))
            steps = DATA_SPLITS["train"] // CLI_BATCH
            val = DATA_SPLITS["valid"] // CLI_BATCH
            writes, lse = [], {"lse": 0}
            K.reset_launches()
            with checkpoint_writes(writes), lse_launches(lse):
                _, hist = cli_train.main(argv)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            check_launches("remat cli", launches, {
                "attention": n_vision * (steps + val),
                "attention_bwd": n_vision * steps,
                "causal_attention": n_text * (steps + val)}, lse["lse"],
                n_vision * steps)
            train_report(f"remat cli --remat {REMAT_BENCH}", hist, writes,
                         card)
            if not (len(hist) == 1 and math.isfinite(hist[0]["train_loss"])):
                raise AssertionError(f"remat cli: history {hist}")
        finally:
            os.chdir(cwd)
    return launches


def remat_phase(dev, rng, card, profile):
    """The named remat policies at full width (models/tower.py::
    REMAT_POLICIES): the flagship train step of 4 x 16 under bench.py's
    save_attn_mlp_qkv_kern (K1 96, every one writing the log-sum-exp, K3
    96, K2(a) 48: no forward kernel again in the backward) and under full
    remat (192 / 96 / 96); each of the nine policies once on a 16-row
    microbatch against no remat; train3 at B=8 under bench.py's per-tower
    spec; cli.train --remat save_attn_mlp_qkv_kern. Returns the launch
    counts by path."""
    from missm_tpu_torch.kernels import attention as K

    paths = {}
    for remat in (REMAT_BENCH, True):
        cfg, params, state, step, batch = flagship_train_inputs(
            dev, rng, remat=remat)
        n_vision, n_text = layers(cfg)
        expect = flagship_remat_expect(remat, n_vision, n_text, ACCUM)
        lse = {"lse": 0}
        with lse_launches(lse):
            state, launches, _ = timed_train(
                f"remat {remat} train ({ACCUM} x {B // ACCUM})", step, state,
                batch, params, cfg, flagship_moving(params), expect, card)
        check_launches(f"remat {remat}", launches,
                       {k: n * STEPS for k, n in expect.items()}, lse["lse"],
                       (2 + STEPS) * expect["attention"])
        paths[f"remat {remat}"] = launches
        del cfg, params, state, step, batch
        torch.cuda.empty_cache()
    paths["remat policies"] = remat_policies(dev, rng, card)
    torch.cuda.empty_cache()
    paths["remat train3"] = train3_phase(dev, rng, card, False,
                                         remat=REMAT_TRAIN3)
    torch.cuda.empty_cache()
    paths["remat cli"] = remat_cli(dev, rng, card)
    K.reset_launches()
    torch.cuda.empty_cache()
    return paths


_ARTIFACT_CHILD = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from missm_tpu_torch.eval.artifact import load_artifact
from missm_tpu_torch.kernels.launches import LAUNCHES, reset_launches
t0 = time.perf_counter()
art = load_artifact(sys.argv[2], device=sys.argv[5])
load_s = time.perf_counter() - t0
inputs = torch.load(sys.argv[3])
reset_launches()
out = [art.predict_arrays(inputs["data"], m) for m in inputs["codes"]]
torch.save(out, sys.argv[4])
print(json.dumps({"load_s": load_s, "launches": dict(LAUNCHES)}))
"""


def export_phase(dev, rng, card, profile):
    """Serving artifacts (eval/artifact.py): the flagship (bf16 encoder)
    exported on the card at B=64 from eval's inputs; model.pt2's bytes; the
    artifact loaded in a fresh subprocess; predict_arrays against the
    Predictor on the same params (preds equal, probs within
    EXPORT_PROBS_ATOL), in process and from the subprocess, for each
    missing-code set and a partial batch of 37; K1 24 and K2(a) 12 a batch
    from the artifact; rows/s of both in turns; then cli.export ->
    cli.predict --artifact on the mvsa tree against cli.predict from the
    checkpoint. Returns the launch counts by path."""
    from missm_tpu_torch.cli import export as cli_export
    from missm_tpu_torch.cli import predict as cli_predict
    from missm_tpu_torch.eval.artifact import (ARTIFACT_FILE, export_artifact,
                                               load_artifact)
    from missm_tpu_torch.eval.predictor import Predictor
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models.finetune import tree_map
    from missm_tpu_torch.train.checkpoint import save_checkpoint

    cfg, params, _, _, (data, _, masks) = flagship_eval_inputs(dev, rng)
    n_vision, n_text = layers(cfg)
    codes = [m.cpu().numpy().astype(np.int32) for m in masks]
    part = tree_map(lambda t: t[:37], data)
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        art_dir = os.path.join(root, "artifact")
        K.reset_launches()
        t0 = time.perf_counter()
        export_artifact(params, cfg, data, art_dir, device=dev)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(art_dir, ARTIFACT_FILE))
        if any(K.LAUNCHES.values()):
            raise AssertionError(f"export launched {dict(K.LAUNCHES)}")
        print(f"export: the flagship at B={B} exported on the card in "
              f"{export_s:.1f} s, model.pt2 {size} bytes "
              f"({size / 2**30:.3f} GiB) [{card}]", flush=True)

        pred = Predictor(params, cfg, batch_size=B, device=dev)
        want = [pred.predict_arrays(data, c) for c in codes]
        want_part = pred.predict_arrays(part, codes[0][:37])

        def same(name, got, ref):
            err = float(np.abs(got[1] - ref[1]).max())
            ok = np.array_equal(got[0], ref[0]) and err <= EXPORT_PROBS_ATOL
            print(f"export {name}: preds {'equal' if ok else 'DIFFER'}, "
                  f"probs max abs err {err:.2e} (limit "
                  f"{EXPORT_PROBS_ATOL})", flush=True)
            if not ok:
                raise AssertionError(f"export {name}: the artifact disagrees "
                                     f"with the Predictor")

        # a fresh process: the artifact and the op registrations only
        inputs = os.path.join(root, "inputs.pt")
        torch.save({"data": tree_map(lambda t: t.cpu(), data),
                    "codes": [torch.from_numpy(c) for c in codes]}, inputs)
        out = os.path.join(root, "out.pt")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _ARTIFACT_CHILD,
             os.path.dirname(os.path.abspath(__file__)), art_dir, inputs,
             out, dev.type], capture_output=True, text=True, env=env,
            timeout=CLI_CHILD_TIMEOUT)
        if proc.returncode != 0:
            raise AssertionError(f"artifact subprocess: {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"export subprocess: {time.perf_counter() - t0:.1f} s, the "
              f"load {child['load_s']:.1f} s, launches {child['launches']}",
              flush=True)
        for i, got in enumerate(torch.load(out, weights_only=False)):
            same(f"subprocess codes {i}", got, want[i])
        check_launches("export subprocess", child["launches"], {
            "attention": n_vision * len(codes),
            "causal_attention": n_text * len(codes)})

        art = load_artifact(art_dir, device=dev)
        K.reset_launches()
        got = [art.predict_arrays(data, c) for c in codes]
        torch.cuda.synchronize()
        paths["export artifact"] = launches = dict(K.LAUNCHES)
        check_launches("export artifact", launches, {
            "attention": n_vision * len(codes),
            "causal_attention": n_text * len(codes)})
        for i, g in enumerate(got):
            same(f"codes {i}", g, want[i])
        same("partial batch of 37", art.predict_arrays(part, codes[0][:37]),
             want_part)

        rates = {"predictor": [], "artifact": []}
        for arm in ("predictor", "artifact", "artifact", "predictor"):
            serve = pred if arm == "predictor" else art
            serve.predict_arrays(data, codes[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(EXPORT_BATCHES):
                serve.predict_arrays(data, codes[i % len(codes)])
            torch.cuda.synchronize()
            rates[arm].append(B * EXPORT_BATCHES / (time.perf_counter() - t0))
        print(f"export rows/s (smoke readings, predict_arrays of B={B} with the "
              "host copy of the results): "
              + "; ".join(f"{arm} {', '.join(f'{r:.2f}' for r in v)}"
                          for arm, v in rates.items()) + f" [{card}]",
              flush=True)
        del art, pred, got, want
        torch.cuda.empty_cache()

        # --- cli.export -> cli.predict --artifact on the mvsa tree
        cwd = os.getcwd()
        csv = write_mvsa_tree(os.path.join(root, "mvsa"), rng)
        os.makedirs(os.path.join(root, "run"))
        os.chdir(os.path.join(root, "run"))
        try:
            save_checkpoint(os.path.join("final_model", "mvsa_sum"),
                            {"params": params})
            argv = cli_argv(csv, dev, "--batch_size", str(B), "--split",
                            "test")
            K.reset_launches()
            t0 = time.perf_counter()
            cli_export.main(argv + ["--output", "artifact"])
            cli_s = time.perf_counter() - t0
            K.reset_launches()
            served = cli_predict.main(argv + ["--output", "art.csv",
                                              "--artifact", "artifact"])
            paths["export cli"] = launches = dict(K.LAUNCHES)
            batches = -(-DATA_SPLITS["test"] // B)
            check_launches("export cli", launches, {
                "attention": n_vision * batches,
                "causal_attention": n_text * batches})
            ref = cli_predict.main(argv + ["--output", "ckpt.csv"])
            err = float((served["confidence"] - ref["confidence"]).abs()
                        .max())
            print(f"export cli: cli.export in {cli_s:.1f} s; cli.predict "
                  f"--artifact {len(served)} rows, preds "
                  f"{'equal' if served['pred'].equals(ref['pred']) else 'DIFFER'}"
                  f" to the checkpoint's, confidence max abs err {err:.2e}; "
                  f"launches {launches}", flush=True)
            if not (served["pred"].equals(ref["pred"])
                    and err <= EXPORT_PROBS_ATOL
                    and len(served) == DATA_SPLITS["test"]):
                raise AssertionError("export cli: the artifact's predictions "
                                     "differ from the checkpoint's")
        finally:
            os.chdir(cwd)
    K.reset_launches()
    return paths


def towers_phase(dev, rng, card, profile):
    """What is left of the towers, at languagebind_large("video") widths
    (24 blocks of 1024, 16 heads, 8 frames of 224 x 224), f32 with TF32
    off, card (the kernels) against the CPU (the plain versions), seeded
    random weights with LoRA B non-zero: the tube-3D embedding (tube 2: 4
    tubes, a CLS each) in train mode with patch dropout 0.5 and the same
    injected keep indices (129 tokens), TOWERS_B videos, pooled features and
    the gradients of temporal LoRA leaves, K1 24, K3 24, K2(c) 24, K4
    block-diagonal 24; then 7-D retrieval-pair input [1, 2, 8, 1, 3, 224,
    224] (2 videos of 8 frames), pooled features, K1 24 and K2(c) 24.
    Returns the launch counts by path."""
    from missm_tpu_torch.core.config import languagebind_large
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.models import tower

    base = languagebind_large("video")
    tube = dataclasses.replace(base, vision=dataclasses.replace(
        base.vision, use_tube3d=True, tube_size=2, force_patch_dropout=0.5))
    frames, size = base.vision.num_frames, base.vision.image_size
    gen = torch.Generator().manual_seed(3)
    cases = (
        ("tube3d", tube, rng.standard_normal(
            (TOWERS_B, 3, frames, *size)).astype(np.float32),
         tower.patch_keep_indices(gen, TOWERS_B, base.vision.num_patches,
                                  0.5)),
        ("7-D", base, rng.standard_normal(
            (1, 2, frames, 1, 3, *size)).astype(np.float32), None))
    paths = {}
    for name, cfg, x, keep in cases:
        vc = cfg.vision
        params = tower.init_vision_params(
            torch.Generator().manual_seed(4), vc)
        for block in params["blocks"]:
            for proj in block["tattn"].values():
                proj["lora_b"].normal_(0.0, 0.01, generator=gen)
        train = keep is not None
        w = torch.as_tensor(rng.standard_normal(vc.hidden_size)
                            .astype(np.float32))

        def run(p, device):
            watched = {"block 0 tattn q lora_a": p["blocks"][0]["tattn"]["q"]
                       ["lora_a"],
                       "last block tattn out lora_b": p["blocks"][-1]
                       ["tattn"]["out"]["lora_b"]}
            for t in watched.values():
                t.requires_grad_(train)
            pooled = tower.vision_features(
                p, vc, torch.as_tensor(x, device=device), train=train,
                keep_indices=keep)
            if not train:
                return pooled.detach().cpu(), {}
            g = torch.autograd.grad((pooled * w.to(device)).sum(),
                                    list(watched.values()))
            return pooled.detach().cpu(), {k: t.cpu() for k, t in
                                           zip(watched, g)}

        card_p = finetune.tree_map(lambda t: t.to(dev), params)
        K.reset_launches()
        with no_tf32():
            got, g_card = run(card_p, dev)
            torch.cuda.synchronize()
        paths[f"towers {name}"] = launches = dict(K.LAUNCHES)
        expect = {"attention": vc.num_layers, "short_attention": vc.num_layers}
        if train:
            expect.update(attention_bwd=vc.num_layers,
                          short_attention_bwd=vc.num_layers)
        check_launches(f"towers {name}", launches, expect)
        del card_p
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref, g_cpu = run(params, "cpu")
        cpu_s = time.perf_counter() - t0
        err = float((got - ref).abs().max())
        rel = {k: ((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm()).item()
               for k in g_cpu}
        print(f"towers {name} ({tuple(x.shape)}, train={train}): pooled "
              f"{tuple(got.shape)}, card f32 vs CPU plain max abs err "
              f"{err:.2e} (limit {LOGITS_F32_ATOL}); gradients "
              + (", ".join(f"{k} {v:.2e}" for k, v in rel.items()) or "-")
              + f" (limit {GRADS_F32_RTOL}); launches {launches}; CPU "
              f"{cpu_s:.1f} s [{card}]", flush=True)
        if not (err <= LOGITS_F32_ATOL and torch.isfinite(got).all()
                and all(v <= GRADS_F32_RTOL for v in rel.values())):
            raise AssertionError(f"towers {name}: the card disagrees with "
                                 f"the CPU")
    K.reset_launches()
    return paths


def probes_phase(dev):
    """Every probe once, every count from 0 (missm_tpu_torch.probes): the
    ln_linear probe (the 24-layer image stack at B=64, forward and forward
    + backward, switch off and on), the mlp_bwd probe (24 chained layers at
    [16448, 1024, 4096], the library chain and K6), the attention probe (P1
    at [1024, 257, 64] at each of its tiles beside the einsums and SDPA)
    and the ablation probe (the image stack with each attention arm).
    Checks the launches: K5 once per block of each fused stack, K6 once per
    layer of each kernel stack, P1 once per parity and timed call, each
    ablation arm 24 of its own route per stack and nothing else, and none
    of P1-P4 from the first two probes; the P1 parity within TOL; every
    ablation output finite, and the arms that compute softmax attention
    within ABLATION_RTOL of the production arm. Returns (the launch counts,
    the ablation result)."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.kernels import probe_attention as pa
    from missm_tpu_torch.probes import (ablation_probe, attn_probe,
                                        ln_linear_probe, mlp_bwd_probe)

    runs = 5
    K.reset_launches()
    ln = ln_linear_probe.run(dev, runs=runs)
    data = mlp_bwd_probe.make_data(dev)
    ab = mlp_bwd_probe.ab(data, runs=runs)
    del data
    torch.cuda.empty_cache()
    new = ("attn_probe_fused", "tower_bhne", "tower_scratch",
           "tower_packed_debug")
    # fused stacks: 2 arms x (1 checked + 7 timed forwards, 7 timed
    # forward + backward); kernel stacks: 7 timed
    want = {"ln_linear": 2 * 15 * ln_linear_probe.config().num_layers,
            "mlp_bwd_dx": 7 * mlp_bwd_probe.L, **dict.fromkeys(new, 0)}
    if any(K.LAUNCHES[k] != n for k, n in want.items()):
        raise AssertionError(f"probe launches {dict(K.LAUNCHES)}, expected "
                             f"{want}")

    q, k, v = attn_probe.make_inputs(dev)
    with torch.inference_mode():
        par = attn_probe.parity(q, k, v)
    attn = attn_probe.run(q, k, v, runs=runs)
    del q, k, v
    atol, rtol = TOL[torch.bfloat16]
    if not all(e <= atol + rtol * par["scale"]
               for e in par["max_abs_err"].values()):
        raise AssertionError(f"attn_probe parity {par}")
    want_p1 = len(pa.ROWS) * (1 + 2 + runs)
    if K.LAUNCHES["attn_probe_fused"] != want_p1:
        raise AssertionError(f"attn_probe launched P1 "
                             f"{K.LAUNCHES['attn_probe_fused']} times, "
                             f"expected {want_p1}")

    abl = ablation_probe.run(dev, runs=runs)
    depth = ablation_probe.config().num_layers
    routes = {"production": "attention", "scratch": "tower_scratch",
              "bhne": "tower_bhne"}
    for arm, launched in abl["launches"].items():
        route = routes.get(arm, "tower_packed_debug"
                           if arm.startswith("packed") else None)
        expect = {} if route is None else {route: depth * (1 + 2 + runs)}
        if launched != expect:
            raise AssertionError(f"ablation arm {arm} launched {launched}, "
                                 f"expected {expect}")
    bad = [arm for arm in ABLATION_SAME
           if not abl["rel_err"][arm] <= ABLATION_RTOL]
    if bad or not all(abl["finite"].values()):
        raise AssertionError(f"ablation outputs: rel_err {abl['rel_err']}, "
                             f"finite {abl['finite']}")
    launches = dict(K.LAUNCHES)
    torch.cuda.empty_cache()

    for key in ("fwd", "fwdbwd"):
        print(f"probes: ln_linear_probe {key}: unfused "
              f"{ln['unfused_' + key]:.3f} ms/stack, fused "
              f"{ln['fused_' + key]:.3f} ms/stack", flush=True)
    for key, val in ab.items():
        print(f"probes: mlp_bwd_probe ab {key}: {val:.3f} ms/stack "
              f"({mlp_bwd_probe.tflops(val):.1f} TFLOP/s)", flush=True)
    print(f"probes: attn_probe parity max abs err "
          f"{par['max_abs_err']} (scale {par['scale']:.3f})", flush=True)
    for key, val in attn.items():
        print(f"probes: attn_probe {key}: {val:.4f} ms", flush=True)
    for arm, val in abl["ms"].items():
        print(f"probes: ablation_probe {arm}: {val:.3f} ms/stack "
              f"({abl['img_per_s'][arm]:.1f} img/s), output vs production "
              f"{abl['rel_err'][arm]:.3e}", flush=True)
    # what the staging layout buys: P4 full (swizzled tiles for wgmma)
    # against nostage (the tiles as the input lays them out)
    full, nostage = abl["ms"]["packed full"], abl["ms"]["packed nostage"]
    print(f"probes: staging: packed full {full:.3f} ms/stack, packed "
          f"nostage {nostage:.3f} ms/stack; nostage - full "
          f"{nostage - full:.3f} ms a stack, {(nostage - full) / depth:.4f} "
          f"ms a call ({depth} calls a stack)", flush=True)
    print(json.dumps({"probes": {"ln_linear_probe": ln, "mlp_bwd_probe": ab,
                                 "attn_probe": attn, "attn_probe_parity": par,
                                 "ablation_probe": abl}}))
    return launches, abl


def probes_only(dev, rng, card, profile):
    """`--only probes`: the P1-P4 rows of the kernels phase (each against
    its plain version in f32 and bf16, timed beside SDPA through
    `yardstick` with `plan`'s tiles), then the probes phase; prints the
    rows. Returns the probes phase's non-zero launch counts."""
    rows = probe_rows(dev, torch.Generator(device=dev).manual_seed(0))
    for row in rows:
        summarise_checks(row)
    launches, _ = probes_phase(dev)
    print(json.dumps({"probe_rows": rows}), flush=True)
    return {name: n for name, n in launches.items() if n}


def profile_step(name, run):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device kernels only: a record_function range (the optimizer's step)
    # also shows a device span, which would count its kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    # first match wins: the backward kernels' symbols (attention_bwd_*,
    # short_attention_bwd) before the forward ones'
    groups = {"ln_linear (K5)": ("ln_linear",),
              "mlp_bwd_dx (K6)": ("mlp_bwd_dx",),
              "attention backward kernels": ("attention_bwd",),
              "attention kernels": ("attention_bf16", "attention_f32",
                                    "short_attention"),
              "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
              "layer_norm": ("layer_norm",), "conv": ("conv",)}
    by_group = dict.fromkeys([*groups, "other elementwise/copies"], 0.0)
    for e in kernels:
        group = next((g for g, keys in groups.items()
                      if any(k in e.key.lower() for k in keys)),
                     "other elementwise/copies")
        by_group[group] += e.self_device_time_total / 1e3
    busy = sum(by_group.values())
    print(f"profile: one traced {name} step, wall {wall:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernel launches, device "
          f"kernel time {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
          + ", ".join(f"{g} {t:.3f} ms" for g, t in by_group.items()),
          flush=True)
    # the 12 largest, then the port's own kernels that are not among them
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    ours = ("attention", "ln_linear", "mlp_bwd_dx")
    for e in ranked[:12] + [e for e in ranked[12:]
                            if any(k in e.key for k in ours)]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# parallel: the layouts on the card (one rank over NCCL; two to four ranks
# sharing the card over gloo)
# ---------------------------------------------------------------------------

PAR_STEPS = 2                   # timed bf16 steps a layout (one warm-up)
PAR_MICRO = 16                  # rows a microbatch, as the train phase's
PAR_GRAD_RTOL = 1e-5            # f32 gradient, as one vector, against the
PAR_LEAF_RTOL = 1e-4            # one-rank step's; and each leaf's
PAR_TIMEOUT = 600               # s, each world
PAR_SCALE = "large"             # "tiny" rehearses the phase on the CPU
PAR_DEVICE = "cuda"             # the CPU rehearsal: "cpu", and gloo for
PAR_ONE_BACKEND = "nccl"        # the one-rank world (kernels count 0)
# name: (n_data, n_model, n_pipe, fsdp, schedule)
PAR_LAYOUTS = {"DP 2": (2, 1, 1, False, "gpipe"),
               "FSDP 2": (2, 1, 1, True, "gpipe"),
               "TP 2": (1, 2, 1, False, "gpipe"),
               "GPipe 2": (1, 1, 2, False, "gpipe"),
               "1F1B 2": (1, 1, 2, False, "1f1b")}


def par_expect(n_data, n_pipe, schedule, n_vision, n_text):
    """A rank's K1 / K3 / K2(a) launches a flagship step at the global
    batch B in microbatches of PAR_MICRO rows: every block once a
    microbatch (TP ranks too: each runs its heads in one launch); a pipe
    stage its blocks for each of the M pipeline microbatches; 1F1B one
    forward more of them in the backward."""
    accum = B // n_data // PAR_MICRO
    m = n_pipe if n_pipe > 1 else 1
    sv, st = n_vision // n_pipe, n_text // n_pipe
    again = 2 if schedule == "1f1b" and n_pipe > 1 else 1
    return dict(attention=sv * m * accum * again,
                attention_bwd=sv * m * accum,
                causal_attention=st * m * accum * again)


def par_config(scale, train3=False):
    """The flagship (or train3) f32 config, head dropout off; at "tiny"
    scale the CPU rehearsal's stand-in (tiny towers)."""
    if scale == "large":
        return (train3_config if train3 else flagship_config)(
            "float32", dropout_prob=0.0)
    from missm_tpu_torch.core.config import tiny_tower
    from missm_tpu_torch.models.finetune import ModelConfig
    from missm_tpu_torch.models.fusion import FusionConfig

    mods = ("video", "audio") if train3 else ("image",)
    return ModelConfig(
        towers=tuple((m, tiny_tower(m, num_layers=4)) for m in mods),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language",) + mods,
                            output_dims=10, feature_dims=24, fusion_dim=16,
                            dropout_prob=0.0))


def par_ids(rng, rows, cfg, vary_length):
    if cfg.towers[0][1].text.vocab_size > 1000:
        return text_batch(rng, rows, vary_length)
    ids = rng.integers(1, 90, (rows, 16))
    ids[:, -1] = 98
    return ids, np.ones_like(ids)


def par_batch(cfg, rows, seed=5):
    """The flagship's f32 train batch: ids with a padding mask, images,
    labels, codes over {0, 1, 4}."""
    rng = np.random.default_rng(seed)
    ids, mask = par_ids(rng, rows, cfg, vary_length=True)
    image = rng.standard_normal(
        (rows, 3, *cfg.towers[0][1].vision.image_size)).astype(np.float32)
    return ({"language": {"input_ids": ids, "attention_mask": mask},
             "image": image},
            rng.integers(0, 10, rows), rng.choice([0, 1, 4], rows))


def par_params(cfg, dev):
    """Seeded flagship params with every LoRA B non-zero (so every LoRA A
    gradient is too)."""
    from missm_tpu_torch.models import finetune

    params = finetune.init_model_params(cfg, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for block in params["encoder"]["image"]["vision"]["blocks"]:
        for proj in block["attn"].values():
            proj["lora_b"].normal_(0.0, 0.01, generator=gen)
    return params


def par_grads(params, prefix=""):
    """{path: grad} of every leaf that has one."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(par_grads(v, f"{prefix}/{k}"))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            out.update(par_grads(v, f"{prefix}/{i}"))
    elif params is not None:
        out[prefix] = params
    return out


def par_rank(spec: dict, rank: int) -> dict:
    """One rank of a world of the parallel phase (see parallel_phase): each
    layout of spec["layouts"] in turn, each on its own mesh of the one
    process group, from the same seeded params. Returns {layout name: its
    results}."""
    import datetime
    import gc

    import torch.distributed as dist
    from missm_tpu_torch.models import finetune

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            rank=rank, world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT))
    out = {}
    try:
        cfg = par_config(spec["scale"], spec.get("train3", False))
        params = par_params(cfg, dev) if not spec.get("train3") else \
            finetune.init_model_params(cfg, seed=1, device=dev)
        # the seed params and the reference gradients wait on the host, so
        # that a layout's peak is its own
        params = finetune.tree_map(lambda t: t.cpu(), params)
        ref = (torch.load(spec["ref"], map_location="cpu")
               if spec.get("ref") and rank == 0 else None)
        for name, layout in spec["layouts"]:
            out[name] = par_layout(spec, rank, dev, cfg, params, layout, ref)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def par_layout(spec, rank, dev, cfg, params, layout, ref) -> dict:
    """One layout on this rank: the f32 gradient checks the spec asks for,
    then the timed bf16 steps."""
    import torch.distributed as dist
    from missm_tpu_torch.core.mesh import make_mesh
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.parallel import PipeConfig, make_layout, shard_batch
    from missm_tpu_torch.train.step import init_train_state, make_train_step

    n_data, n_model, n_pipe, fsdp, schedule = layout
    out = {"rank": rank}
    mesh = make_mesh(n_data, n_model, n_pipe, device_type=dev.type)
    lay = make_layout(params, mesh, tp=n_model > 1, fsdp=fsdp,
                      pipe=n_pipe > 1, towers=cfg.tower_dict)
    pipe = PipeConfig(mesh, n_pipe, schedule=schedule) if n_pipe > 1 else None
    rows = spec["rows"]
    accum = rows // n_data // spec["micro"]

    def fresh():
        # the steps update their params in place: each starts from a copy
        return finetune.tree_map(lambda t: t.detach().to(dev, copy=True),
                                 params)

    def step_of(c):
        c = dataclasses.replace(c, parallel=lay, pipe=pipe)
        state, tx = init_train_state(lay.partition(fresh()), c)
        return state, make_train_step(c, tx, accum_steps=accum, device=dev)

    if spec.get("train3"):
        rng = np.random.default_rng(7)
        ids, _ = par_ids(rng, rows, cfg, vary_length=False)
        batch = ({"language": ids, **media(rng, cfg, rows)},
                 rng.integers(0, 10, rows), rng.choice([0, 1, 2, 3], rows))
    else:
        batch = par_batch(cfg, rows)
    local = shard_batch(batch, mesh, microbatches=accum)
    gen = torch.Generator(device=dev).manual_seed(lay.data_index)

    def f32_grads(c, data=None):
        """The f32 step's loss and full gradients (TF32 off, lr 0: the step
        leaves them in .grad); with `data`, the phase-free step's on it."""
        with no_tf32():
            if data is None:
                state, step = step_of(c)
                data = local
            else:
                state, tx = init_train_state(fresh(), c)
                step = make_train_step(c, tx, accum_steps=accum, device=dev)
            state, met = step(state, *data, 0.0, gen)
            grads = finetune.tree_map(
                lambda t: t.grad if t.requires_grad else None, state.params)
            if data is local:
                grads = lay.gather(grads)
        return float(met["loss"]), par_grads(grads)

    def rel(got, want):
        """(relative error of the whole gradient, of each leaf whose
        gradient is not float noise)."""
        got = {p: g.cpu() for p, g in got.items()}
        want = {p: g.cpu() for p, g in want.items()}
        top = max(float(g.norm()) for g in want.values())
        errs = {p: float((got[p] - g).norm() / g.norm())
                for p, g in want.items() if float(g.norm()) > 1e-6 * top}
        whole = math.sqrt(sum(float((got[p] - g).norm()) ** 2
                              for p, g in want.items())
                          / sum(float(g.norm()) ** 2 for g in want.values()))
        return whole, errs

    def worst(errs, k=3):
        return {p: f"{errs[p]:.2e}" for p in
                sorted(errs, key=errs.get, reverse=True)[:k]}

    if spec.get("save_ref"):
        # the one-rank step through the mesh against the phase-free one
        out["f32_loss"], full = f32_grads(cfg)
        out["free_loss"], free = f32_grads(cfg, batch)
        _, errs = rel(full, free)
        out["grad_leaves"] = len(errs)
        out["free_rel_max"] = max(errs.values())
        # the step's own noise floor: the same rows in another order (other
        # microbatches, another summation), its gradients against the
        # reference
        perm = np.random.default_rng(11).permutation(rows)
        _, moved = f32_grads(cfg, finetune.tree_map(lambda a: a[perm],
                                                    batch))
        whole, errs = rel(moved, free)
        out["floor"] = {"whole": whole, "worst": worst(errs)}
        torch.save({p: g.cpu() for p, g in free.items()}, spec["save_ref"])
        del full, free, moved
    if spec.get("ref"):
        out["f32_loss"], full = f32_grads(cfg)
        if rank == 0:
            whole, errs = rel(full, ref)
            out["grad_leaves"] = len(errs)
            out["grad_rel"] = whole
            out["grad_rel_max"] = max(errs.values())
            out["grad_rel_worst"] = worst(errs)
        del full
    # bf16: the rate, the launches and this rank's peak, after a warm-up
    bcfg = dataclasses.replace(
        cfg, compute_dtype="bfloat16",
        fusion=dataclasses.replace(cfg.fusion, dropout_prob=0.1))
    state, step = step_of(bcfg)
    state, met = step(state, *local, LR, gen)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: 0)
    sync()
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(spec["steps"]):
        state, met = step(state, *local, LR, gen)
        losses.append(float(met["loss"]))
    sync()
    dist.barrier()
    dt = time.perf_counter() - t0
    out.update(losses=losses, seconds=dt,
               launches={k: v // spec["steps"] for k, v in
                         K.LAUNCHES.items() if v},
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else 0.0))
    return out


def par_world(name, spec, tmp, card, mode="--parallel-rank"):
    """`spec["world"]` ranks of par_rank (predict_rank with `mode`
    --predict-rank), each a `python3 chip_smoke.py <mode>` process on the
    card; returns their results. A rank that fails or hangs fails the
    phase."""
    here = os.path.abspath(__file__)
    spec = dict(spec, init="file://" + os.path.join(
        tmp, f"rdv_{name.replace(' ', '_')}"))
    path = os.path.join(tmp, f"spec_{name.replace(' ', '_')}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    logs = [open(os.path.join(tmp, f"{name.replace(' ', '_')}_{r}.log"),
                 "w+") for r in range(spec["world"])]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, here, mode, path,
                               str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(spec["world"])]
    try:
        for p in procs:
            p.wait(timeout=PAR_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        text = []
        for log in logs:
            log.seek(0)
            text.append(log.read())
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"parallel {name}: ranks {bad} failed:\n"
                             + "\n".join(text[r][-4000:] for r in bad))
    res = [json.loads(t.strip().splitlines()[-1]) for t in text]
    print(f"{'parallel ' * (mode == '--parallel-rank')}{name}: "
          f"{spec['world']} rank(s) over "
          f"{spec['backend']} in {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return res


def parallel_phase(dev, rng, card, profile):
    """The parallel layouts (missm_tpu_torch/parallel) on the flagship at
    full width and depth. One rank over NCCL: the train step through
    init_process_group("nccl") and make_mesh, its f32 gradients (TF32 off,
    B = 64 as 4 x 16, lr 0 so they stay in .grad) against the phase-free
    step's in the same process; they are the reference. Two ranks sharing
    the card over gloo (NCCL refuses two ranks on one device), one world
    running each layout of PAR_LAYOUTS in turn at the same global batch: loss and every
    trainable leaf's gradient within PAR_LEAF_RTOL (the gradient as one
    vector within PAR_GRAD_RTOL) relative of the
    reference, then bf16 samples/s, each rank's peak and its exact K1 / K3 /
    K2(a) launches a step (par_expect). train3 (B = 8) under DP x GPipe on
    four ranks: K1, K3, K2(b), K4, K2(c), K4 block-diagonal and K2(a) on
    every stage's blocks. Then the dryrun at N = 4 and 8 on the card, every
    rank's hand kernels counted. The ranks on one card are not a multi-GPU
    rate."""
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.parallel.dryrun import dryrun

    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the earlier phases' cached blocks
    launches = dict.fromkeys(K.LAUNCHES, 0)
    n_vision, n_text = layers(par_config(PAR_SCALE))
    counted = PAR_DEVICE == "cuda"  # the plain versions count nothing
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref_grads.pt")
        base = dict(rows=B, micro=PAR_MICRO, steps=PAR_STEPS,
                    device=PAR_DEVICE, scale=PAR_SCALE)
        one = par_world("NCCL 1", dict(
            base, world=1, backend=PAR_ONE_BACKEND,
            layouts=[["NCCL 1", (1, 1, 1, False, "gpipe")]], ref=None,
            save_ref=ref_path), tmp, card)[0]["NCCL 1"]
        print(f"parallel NCCL 1: f32 loss {one['f32_loss']:.6f}, phase-free "
              f"{one['free_loss']:.6f}; gradients against the phase-free "
              f"step: max relative {one['free_rel_max']:.2e} over "
              f"{one['grad_leaves']} leaves; the step's own noise floor "
              f"(the rows in another order): whole {one['floor']['whole']:.2e}"
              f", worst leaves {one['floor']['worst']}; bf16 "
              f"{B * PAR_STEPS / one['seconds']:.2f} samples/s, peak "
              f"{one['peak_gib']:.2f} GiB, launches a step "
              f"{one['launches']} [{card}]", flush=True)
        if one["free_rel_max"] > PAR_GRAD_RTOL:
            raise AssertionError("the one-rank NCCL step's gradients differ "
                                 "from the phase-free step's")
        RATES["parallel NCCL 1"] = B * PAR_STEPS / one["seconds"]
        want = par_expect(1, 1, "gpipe", n_vision, n_text)
        if counted and one["launches"] != want:
            raise AssertionError(f"NCCL 1 launches {one['launches']}, "
                                 f"expected {want}")
        # every two-rank layout in one world of two processes
        ranks = par_world("2 ranks", dict(
            base, world=2, backend="gloo", ref=ref_path,
            layouts=[[name, layout] for name, layout in PAR_LAYOUTS.items()]),
            tmp, card)
        for name, layout in PAR_LAYOUTS.items():
            n_data, n_model, n_pipe, fsdp, schedule = layout
            res = [r[name] for r in ranks]
            lead = res[0]
            rate = B * PAR_STEPS / max(r["seconds"] for r in res)
            RATES[f"parallel {name}"] = rate
            want = par_expect(n_data, n_pipe, schedule, n_vision, n_text)
            print(f"parallel {name}: f32 loss {lead['f32_loss']:.6f} (one "
                  f"rank {one['f32_loss']:.6f}), the gradient relative "
                  f"{lead['grad_rel']:.2e} (limit {PAR_GRAD_RTOL}), worst "
                  f"leaves {lead['grad_rel_worst']} of "
                  f"{lead['grad_leaves']} (limit {PAR_LEAF_RTOL}); bf16 "
                  f"{rate:.2f} samples/s, peaks "
                  f"{[round(r['peak_gib'], 2) for r in res]} GiB, launches "
                  f"a step a rank {[r['launches'] for r in res]} (expected "
                  f"{want}) [{card}]", flush=True)
            if (abs(lead["f32_loss"] - one["f32_loss"])
                    > PAR_GRAD_RTOL * abs(one["f32_loss"])
                    or lead["grad_rel"] > PAR_GRAD_RTOL
                    or lead["grad_rel_max"] > PAR_LEAF_RTOL):
                raise AssertionError(f"parallel {name}: f32 loss or "
                                     f"gradients disagree with one rank's")
            for r in res:
                if counted and r["launches"] != want:
                    raise AssertionError(
                        f"parallel {name} rank {r['rank']}: launches "
                        f"{r['launches']}, expected {want}")
                for k, v in r["launches"].items():
                    launches[k] += v
        # train3 under DP x GPipe, 4 ranks
        t3 = par_config(PAR_SCALE, train3=True)
        video, audio = (t.vision for _, t in t3.towers)
        n3 = t3.towers[-1][1].text.num_layers
        name = "train3 DP 2 x GPipe 2"
        res = [r[name] for r in par_world(name, dict(
            base, rows=B3T, micro=B3T // 2, world=4, backend="gloo",
            layouts=[[name, (2, 1, 2, False, "gpipe")]], ref=None,
            train3=True), tmp, card)]
        # a rank: its stage's half of the blocks, for each of M = 2
        # pipeline microbatches of its B / 2 rows
        want = dict(attention=video.num_layers, attention_bwd=video.num_layers,
                    short_attention=video.num_layers,
                    short_attention_bwd=video.num_layers,
                    attention_unsplit=audio.num_layers,
                    attention_unsplit_bwd=audio.num_layers,
                    causal_attention=n3)
        print(f"parallel {name}: bf16 "
              f"{B3T * PAR_STEPS / max(r['seconds'] for r in res):.2f} "
              f"samples/s, peaks {[round(r['peak_gib'], 2) for r in res]} "
              f"GiB, launches a step a rank {[r['launches'] for r in res]} "
              f"(expected {want}) [{card}]", flush=True)
        for r in res:
            if counted and r["launches"] != want:
                raise AssertionError(f"train3 DP x GPipe rank {r['rank']}: "
                                     f"launches {r['launches']}, expected "
                                     f"{want}")
            for k, v in r["launches"].items():
                launches[k] += v
    for n in (4, 8):
        t0 = time.perf_counter()
        for spec, results in dryrun(n, device=PAR_DEVICE):
            for r, res in enumerate(results):
                got = {k: v for k, v in res["launches"].items() if v}
                # every rank runs hand kernels: the text tower's causal
                # attention and the tiny vision towers' (N <= 7, unsplit)
                if counted and not (got.get("causal_attention")
                        and got.get("attention_unsplit")
                        and got.get("short_attention")
                        and got.get("attention_unsplit_bwd")):
                    raise AssertionError(f"dryrun({n}) {spec} rank {r}: "
                                         f"launches {got}")
        print(f"parallel dryrun({n}) on the card: {time.perf_counter() - t0:.1f}"
              f" s [{card}]", flush=True)
    return {"parallel": launches}


def main() -> int:
    ranks = {"--parallel-rank": par_rank, "--predict-rank": predict_rank}
    if len(sys.argv) == 4 and sys.argv[1] in ranks:
        # one rank of a world of the parallel or the cli phase (par_world)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        with open(sys.argv[2]) as f:
            spec = json.load(f)
        print(json.dumps(ranks[sys.argv[1]](spec, int(sys.argv[3]))),
              flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one eval, train, eval3, train3, ln2fc1 "
                         "eval and ln2fc1 train step with torch.profiler")
    ap.add_argument("--only", choices=["parallel", "cli", "probes"],
                    help="build, then run only this phase (no result "
                         "line: the contract needs every phase)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    built = build.build_all()
    for src, (seconds, log) in built.items():
        # ptxas: "Compiling entry function '<name>'" then "Used N registers"
        entries = [ln for ln in log.splitlines()
                   if "Compiling entry" in ln or "registers" in ln]
        main = [entries[i + 1].split(": ")[-1]
                for i in range(len(entries) - 1)
                if any(k in entries[i] for k in (
                    "bf16ILi64E", "bfloat16Li64ELi8E", "ln_linear_bf16",
                    "mlp_bwd_dx_bf16ILi128E",
                    "rows_bf16ILi1ELi0ELb0E", "scratch_bf16ILi2E",
                    "nostage_bf16"))]
        print(f"build csrc/{src}.cu: {seconds:.1f} s; the main path's bf16 "
              f"kernels: {main}", flush=True)
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"ptxas_{src}.log"), "w") as f:
            f.write(log)
    K.reset_launches()

    rng = np.random.default_rng(0)
    if args.only:
        t0 = time.perf_counter()
        phase = {"parallel": parallel_phase, "cli": cli_phase,
                 "probes": probes_only}[args.only]
        got = phase(dev, rng, card, False)
        print(f"phase {args.only}: {time.perf_counter() - t0:.1f} s; "
              f"launches {got}", flush=True)
        return 0
    t0 = time.perf_counter()
    rows = kernel_phase(dev, rng)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    paths = {}
    for path, phase in (("eval", slice_phase), ("train", train_phase),
                        ("eval3", eval3_phase), ("train3", train3_phase),
                        ("ln2fc1", ln2fc1_phase)):
        t0 = time.perf_counter()
        launches = phase(dev, rng, card, args.profile)
        paths.update(launches if path == "ln2fc1" else {path: launches})
        print(f"phase {path}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    paths["probes"], ablation = probes_phase(dev)
    print(f"phase probes: {time.perf_counter() - t0:.1f} s", flush=True)
    # each returns its launch counts by path
    for path, phase in (("heads", heads_phase), ("distill", distill_phase),
                        ("sweep", sweep_phase), ("data", data_phase),
                        ("cli", cli_phase), ("remat", remat_phase),
                        ("export", export_phase), ("towers", towers_phase),
                        ("parallel", parallel_phase)):
        t0 = time.perf_counter()
        paths.update(phase(dev, rng, card, args.profile))
        print(f"phase {path}: {time.perf_counter() - t0:.1f} s", flush=True)
    for row in rows:
        # launches: over the counted steps of every path that runs it, and
        # the probes' stacks (a P4 row: its own mode's ablation arm)
        kernel = row.get("counter", row["name"])
        row["launches"] = sum(p[kernel] for p in paths.values())
        row["launches_per_step"] = {path: p[kernel] // COVERS.get(path, STEPS)
                                    for path, p in paths.items()
                                    if p[kernel] and path != "probes"}
        if "arm" in row:
            row["launches"] = ablation["launches"][row["arm"]].get(kernel, 0)
        if paths["probes"][kernel]:
            row["probe_launches"] = (row["launches"] if "arm" in row
                                     else paths["probes"][kernel])
        if not row["launches"]:
            raise AssertionError(f"{kernel} was launched no time on its "
                                 f"paths")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
