"""Smoke run of the PyTorch/CUDA port (missm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run (non-zero exit, no result line):
  1. device   - needs a CUDA GPU; prints its name and power limit.
  2. build    - compiles every csrc/*.cu with nvcc (one process per source).
  3. kernels  - each kernel at the shapes of the flagship eval step, against
                its plain PyTorch version in f32 and bf16; times the kernel,
                the plain version and one PyTorch library call doing the same
                work (CUDA events, median of 7 runs of 20 launches, inputs
                rotated through enough copies to miss the 50 MB L2), and
                works out the least time the card could take.
  4. slice    - the flagship eval step (LanguageBind ViT-L/14 image tower +
                CLIP text tower + `sum` head, seeded random weights, bf16
                encoder, B=64, missing codes rotating over {0, 1, 4}) through
                make_eval_step; checks that every step launched K1 24 times
                and K2 12 times, that the outputs are finite and the probs sum
                to 1, and times samples/s. Then holds the card's f32 logits
                for 4 rows against the CPU's plain path.
  5. summary  - a `{"kernels": [...]}` line, the card's name and power limit,
                and as the last line {"ok": true, "device": {...}}.
--profile adds one torch.profiler-traced eval step and prints device time by
kernel.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (at the 700 W limit): device memory and dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50e6
B = 64                      # the flagship eval batch (bench.py eval workload)
STEPS = 5
TOL = {torch.float32: (1e-4, 0.0),      # summation order only
       torch.bfloat16: (2e-2, 2 ** -7)}  # P rounded at other places; out ulp
LOGITS_F32_ATOL = 1e-3                  # card f32 vs CPU f32, 24 + 12 layers


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, reps=7, iters=20) -> float:
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
    return statistics.median(times)


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


def kernel_phase(dev, rng):
    from missm_tpu_torch.kernels import attention as K

    neg = torch.finfo(torch.float32).min
    _, mask = text_batch(rng, B, vary_length=True)
    kbias = torch.where(torch.as_tensor(mask, device=dev)[:, None, :] == 0,
                        neg, 0.0).float().contiguous()
    specs = [
        dict(name="attention", n=257, heads=16, kbias=None,
             replaces="missm_tpu/kernels/flash_attention.py:352 "
                      "(fused_attention_cls)",
             run=lambda q, k, v: K.attention(q, k, v, 16),
             plain=lambda q, k, v: K.attention_plain(q, k, v, 16)),
        dict(name="causal_attention", n=77, heads=12, kbias=kbias,
             replaces="missm_tpu/kernels/flash_attention.py:277 "
                      "(fused_attention, causal=True, kbias)",
             run=lambda q, k, v: K.causal_attention(q, k, v, kbias, 12),
             plain=lambda q, k, v: K.attention_plain(
                 q, k, v, 12, causal=True, kbias=kbias)),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for s in specs:
        n, heads, hd = s["n"], s["heads"], 64
        d = heads * hd
        row = {"name": s["name"], "route": "cuda",
               "source": "missm_tpu_torch/csrc/attention.cu",
               "replaces": s["replaces"],
               "shape": f"B={B} N={n} H={heads} hd={hd}"}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v = (torch.randn(B, n, d, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            got, ref = s["run"](q, k, v), s["plain"](q, k, v)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            atol, rtol = TOL[dtype]
            bad = err > atol + rtol * ref.float().abs()
            if bad.any() or not torch.isfinite(got).all():
                raise AssertionError(f"{s['name']} {tag}: kernel disagrees "
                                     f"with the plain version, max abs err "
                                     f"{err.max().item():.3e}")
            row[f"max_abs_err_{tag}"] = err.max().item()
        row["max_abs_err"] = row["max_abs_err_bf16"]

        # timing, bf16 (the main path's type)
        io_bytes = 4 * B * n * d * 2 + (0 if s["kbias"] is None else B * n * 4)
        copies = max(1, math.ceil(2 * L2_BYTES / io_bytes))
        sets = [[torch.randn(B, n, d, generator=gen, device=dev)
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
                return t.view(B, n, heads, hd).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                heads_first(q), heads_first(k), heads_first(v),
                attn_mask=mask4)
        row["library_ms"] = median_ms(lambda: library(*next(cyc)))

        # the least time: each input read once and the output written once,
        # against the score and P.V products this run's data needs (causal:
        # the keys at or before each query that are not padded)
        if s["kbias"] is None:
            pairs = B * heads * n * n
        else:
            valid = (s["kbias"][:, 0, :] == 0).double()          # [B, N]
            pairs = heads * valid.cumsum(-1).sum().item()
        flops = 4 * pairs * hd
        t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"kernel {s['name']} [{row['shape']}]: err f32 "
              f"{row['max_abs_err_f32']:.2e} bf16 {row['max_abs_err_bf16']:.2e}"
              f" | bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, sdpa {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        rows.append(row)
    return rows


def flagship_config(compute_dtype):
    from missm_tpu_torch.core.config import languagebind_large
    from missm_tpu_torch.models.finetune import ModelConfig
    from missm_tpu_torch.models.fusion import FusionConfig

    return ModelConfig(
        towers=(("image", languagebind_large("image")),),
        fusion=FusionConfig(fusion_type="sum",
                            modality_types=("language", "image"),
                            output_dims=10, feature_dims=768, fusion_dim=256),
        compute_dtype=compute_dtype)


def slice_phase(dev, rng, card, profile):
    from missm_tpu_torch.kernels import attention as K
    from missm_tpu_torch.models import finetune
    from missm_tpu_torch.train.step import make_eval_step

    cfg = flagship_config("bfloat16")
    t0 = time.perf_counter()
    params = finetune.init_model_params(cfg, seed=0, device=dev)
    # encoder in bf16 once, up front; the fusion head stays f32
    params_bf16 = {"encoder": finetune.cast_tree(params["encoder"],
                                                 torch.bfloat16),
                   "fusion": params["fusion"]}
    ids, mask = text_batch(rng, B, vary_length=False)
    image = rng.standard_normal((B, 3, 224, 224)).astype(np.float32)
    data = {"language": {"input_ids": torch.as_tensor(ids, device=dev),
                         "attention_mask": torch.as_tensor(mask, device=dev)},
            "image": torch.as_tensor(image, device=dev).to(torch.bfloat16)}
    labels = torch.as_tensor(rng.integers(0, 10, B), device=dev)
    masks = [torch.as_tensor(rng.choice([0, 1, 4], B), device=dev)
             for _ in range(4)]
    eval_step = make_eval_step(cfg, device=dev)
    for i in range(2):  # warm-up: cuBLAS/cuDNN plans
        eval_step(params_bf16, data, labels, masks[i])
    torch.cuda.synchronize()
    print(f"slice set-up {time.perf_counter() - t0:.1f} s", flush=True)

    K.reset_launches()
    t0 = time.perf_counter()
    for i in range(STEPS):
        out = eval_step(params_bf16, data, labels, masks[i % 4])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    expect = {"attention": 24 * STEPS, "causal_attention": 12 * STEPS}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches}, expected {expect}")
    probs = out["probs"]
    if not (torch.isfinite(probs).all() and torch.isfinite(out["loss"])):
        raise AssertionError("non-finite eval outputs")
    if not torch.allclose(probs.sum(-1), torch.ones(B, device=dev),
                          atol=1e-5):
        raise AssertionError("probs do not sum to 1")
    if probs.shape != (B, 10) or out["preds"].shape != (B,):
        raise AssertionError(f"output shapes {tuple(probs.shape)}, "
                             f"{tuple(out['preds'].shape)}")
    rate = B * STEPS / dt
    print(f"slice eval: {STEPS} steps of B={B} in {dt:.4f} s = {rate:.2f} "
          f"samples/s, {dt / STEPS * 1e3:.3f} ms/step, loss "
          f"{out['loss'].item():.4f} [{card}]", flush=True)

    if profile:
        profile_step(eval_step, params_bf16, data, labels, masks[0])

    # f32 on the card (no TF32) vs f32 on the CPU (plain attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config("float32")
    rows = {"language": {"input_ids": ids[:4], "attention_mask": mask[:4]},
            "image": image[:4]}
    miss = np.array([0, 1, 4, 0])
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


def profile_step(eval_step, params, data, labels, missing):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_step(params, data, labels, missing)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    groups = {"attention kernels": ("attention_bf16", "attention_f32"),
              "GEMM": ("gemm", "nvjet", "cutlass", "xmma"),
              "layer_norm": ("layer_norm",), "conv": ("conv",)}
    by_group = dict.fromkeys([*groups, "other elementwise/copies"], 0.0)
    for e in kernels:
        group = next((g for g, keys in groups.items()
                      if any(k in e.key.lower() for k in keys)),
                     "other elementwise/copies")
        by_group[group] += e.self_device_time_total / 1e3
    busy = sum(by_group.values())
    print(f"profile: one traced eval step, wall {wall:.3f} ms, device "
          f"kernel time {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
          + ", ".join(f"{g} {t:.3f} ms" for g, t in by_group.items()),
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one eval step with torch.profiler")
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
                if "bf16ILi64E" in entries[i]]
        print(f"build csrc/{src}.cu: {seconds:.1f} s; bf16 hd=64 kernels: "
              f"{main}", flush=True)
    K.reset_launches()

    rng = np.random.default_rng(0)
    rows = kernel_phase(dev, rng)
    launches = slice_phase(dev, rng, card, args.profile)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_per_step"] = launches[row["name"]] // STEPS
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
