"""A/B the fused MLP-backward dx kernel (kernels/mlp_bwd.py, K6) against the
library chain it replaces, the port's counterpart of scripts/mlp_bwd_probe.py
at its shapes: M = 64 * 257 = 16448 tokens (the b64 image train backward),
D = 1024, FF = 4096, bf16, 24 chained layers per stack (each layer's dh is
the next layer's dy, one stack being the whole tower's MLP-dx work).

  parity  the kernel against its plain version at those shapes, one layer
  ab      ms per stack: the library chain (mlp_bwd_dx_plain: two cuBLAS
          products around one elementwise pass, dwide through device
          memory), then the kernel at its default tile
  sweep   ms per stack for each of the kernel's tiles (kernels.mlp_bwd.TILES:
          (rows, cluster), clusters of blocks that split D between them)

CUDA events around one stack, the median of `runs` stacks after two warm-up
stacks.

    python -m missm_tpu_torch.probes.mlp_bwd_probe [parity|ab|sweep|all]

Needs a CUDA GPU (it raises without one).
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..core.device import resolve_device
from ..kernels import mlp_bwd
from .timing import event_ms

M, D, FF, L = 64 * 257, 1024, 4096, 24


def make_data(device="cuda", layers=None, seed=0):
    """dy [M, D] and per layer (L of them by default) wide [M, FF], w1 [D,
    FF], w2 [FF, D], bf16, scaled as the JAX probe's."""
    dev = resolve_device(device)
    layers = L if layers is None else layers
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    dy = randn(M, D)
    layers_ = [(randn(M, FF, scale=0.5), randn(D, FF, scale=0.02),
                randn(FF, D, scale=0.02)) for _ in range(layers)]
    return dy, layers_


def stack_ms(fn, data, runs=5) -> float:
    """Median ms of one chained stack of fn(dy, wide, w1, w2)."""
    dy, layers = data

    def stack():
        h = dy
        for wide, w1, w2 in layers:
            h = fn(h, wide, w1, w2)
        return h

    return statistics.median(event_ms(stack, runs))


def tflops(ms: float) -> float:
    """The rate of one L-layer stack in ms, counting 4 M D FF per layer."""
    return 4 * M * D * FF * L / (ms * 1e-3) / 1e12


def parity(data) -> dict:
    dy, layers = data
    wide, w1, w2 = layers[0]
    got = mlp_bwd.mlp_bwd_dx(dy, wide, w1, w2).float()
    ref = mlp_bwd.mlp_bwd_dx_plain(dy, wide, w1, w2).float()
    return {"max_abs_err": (got - ref).abs().max().item(),
            "scale": ref.abs().max().item()}


def ab(data, runs=5) -> dict:
    return {"library_chain": stack_ms(mlp_bwd.mlp_bwd_dx_plain, data, runs),
            "kernel": stack_ms(mlp_bwd.mlp_bwd_dx, data, runs)}


def sweep(data, runs=5) -> dict:
    return {f"rows={rows} cluster={cluster}": stack_ms(
                lambda *a, t=(rows, cluster): mlp_bwd.mlp_bwd_dx(*a, tile=t),
                data, runs)
            for rows, cluster in mlp_bwd.TILES}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=["parity", "ab", "sweep", "all"])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    data = make_data()
    result = {"device": torch.cuda.get_device_name(0)}
    if args.mode in ("parity", "all"):
        result["parity"] = p = parity(data)
        print(f"mlp_bwd_probe parity: max |kernel - plain| "
              f"{p['max_abs_err']:.4g} (scale {p['scale']:.4g})", flush=True)
    for mode, fn in (("ab", ab), ("sweep", sweep)):
        if args.mode in (mode, "all"):
            result[mode] = ms = fn(data, args.runs)
            for k, v in ms.items():
                print(f"mlp_bwd_probe {mode} {k}: {v:.3f} ms/stack "
                      f"({tflops(v):.1f} TFLOP/s)", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
