"""Attention formulations at ViT-L shapes on the card: the port's
counterpart of scripts/attn_probe.py.

q, k, v are [B*H = 1024, N = 257, hd = 64] bf16 head-major slices, made
from numpy.random.default_rng(seed) as the script makes them. Timed, each
the median of `runs` calls between CUDA events after two warm-up calls
(probes/timing.py::event_ms):
  - `einsum_attn`: q scaled in its own type, the scores in f32 (a bf16
    product with an f32 output), softmax in f32, P cast to bf16, P.V in f32;
  - `einsum_attn_bf16sm`: the scores, the softmax and P.V in bf16;
  - SDPA (torch.nn.functional.scaled_dot_product_attention) on the same
    slices, the library yardstick;
  - the P1 kernel (kernels/probe_attention.py::attn_probe_fused) at each of
    its tiles.
The script sweeps group in {1, 4, 8, 16}, the slices per TPU grid step,
which has no meaning on this card: blocks run in parallel over 132 SMs.
The sweep here is the kernel's own tile choice, the query rows per block
(kernels.probe_attention.ROWS: one warpgroup of 64 rows, or two sharing
the block's ring of K and V tiles), which sets how many blocks stream each
slice's K and V.
Before timing, each tile's output is held against the plain version
(`parity`, max abs err).

    python -m missm_tpu_torch.probes.attn_probe [--runs N]

Needs a CUDA GPU (it raises without one).
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..kernels import probe_attention as pa
from ..ops.basic import bmm_f32
from .timing import event_ms

BH, N, HD = 64 * 16, 257, 64


def make_inputs(device="cuda", seed=0, bh=BH):
    """q, k, v [bh, N, HD] bf16 from numpy's f64 standard normals, as the
    script makes them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, N, HD)))
            .to(torch.bfloat16).to(dev) for _ in range(3)]


def einsum_attn(q, k, v):
    """The script's einsum_attn: q scaled in its own type, f32 scores and
    softmax, P cast to the input type, P.V accumulated in f32."""
    s = bmm_f32(q * HD ** -0.5, k.transpose(1, 2))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return bmm_f32(p, v).to(q.dtype)


def einsum_attn_bf16sm(q, k, v):
    """The script's einsum_attn_bf16sm: scores, softmax and P.V all in the
    input type."""
    s = torch.bmm(q * HD ** -0.5, k.transpose(1, 2))
    return torch.bmm(torch.softmax(s, dim=-1), v)


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(q[None], k[None], v[None])[0]


def parity(q, k, v) -> dict:
    """{"max_abs_err": {rows: max |kernel - plain|} at each tile (one launch
    each), "scale": max |plain|}."""
    ref = pa.rows_attention_plain(q, k, v).float()
    return {"max_abs_err": {
                rows: (pa.attn_probe_fused(q, k, v, rows=rows).float() - ref)
                .abs().max().item() for rows in pa.ROWS},
            "scale": ref.abs().max().item()}


def run(q, k, v, runs=5) -> dict:
    """{name: median ms of one call}. Each tile's kernel launches 2 + runs
    times."""
    arms = {"einsum f32 softmax": einsum_attn,
            "einsum bf16 logits": einsum_attn_bf16sm,
            "sdpa": sdpa,
            **{f"kernel rows={rows}": lambda q, k, v, rows=rows:
               pa.attn_probe_fused(q, k, v, rows=rows) for rows in pa.ROWS}}
    with torch.inference_mode():
        return {name: statistics.median(event_ms(lambda: fn(q, k, v), runs))
                for name, fn in arms.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    q, k, v = make_inputs()
    with torch.inference_mode():
        par = parity(q, k, v)
    for rows, err in par["max_abs_err"].items():
        print(f"attn_probe parity rows={rows}: max |kernel - plain| {err:.4g} "
              f"(scale {par['scale']:.4g})", flush=True)
    ms = run(q, k, v, args.runs)
    for name, t in ms.items():
        print(f"attn_probe {name}: {t:.4f} ms", flush=True)
    print(json.dumps({"attn_probe_ms": ms, "parity": par,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
