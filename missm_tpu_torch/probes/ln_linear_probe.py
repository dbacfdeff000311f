"""A/B the fused ln2 -> fc1 kernel (kernels/ln_linear.py, K5) on the
24-layer ViT-L/14 image block stack at B=64 in bf16: the port's counterpart
of scripts/ln_linear_probe.py.

Two arms, the switch `FUSE_LN2_FC1` off and on, each timing the stack's
forward (inference mode) and its forward and backward (the gradient with
respect to the stack's input, as the JAX probe's loss sum(h)): CUDA events
around one stack, the median of `runs` stacks after two warm-up stacks, the
arms in turns (off, on, on, off). Each fused stack must launch K5 once per
block. The backward arm runs under the JAX probe's named remat policy
save_attn_mlp_qkv (models/tower.py::REMAT_POLICIES): each block keeps its
input, attn_out, mlp_wide (K5's output in the fused arm) and q/k/v, and
recomputes the rest in the backward.

    python -m missm_tpu_torch.probes.ln_linear_probe [--runs N]

Needs a CUDA GPU (it raises without one).
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..core.config import languagebind_large
from ..core.device import resolve_device
from ..kernels import ln_linear as lnl
from ..kernels.launches import LAUNCHES
from ..models.finetune import cast_tree
from ..models.tower import _encoder, init_vision_params
from ..ops.basic import get_activation
from .timing import event_ms

B = 64
REMAT = "save_attn_mlp_qkv"  # the JAX probe's train arm


def config():
    """The stack's tower: LanguageBind_Image's ViT-L/14."""
    return languagebind_large("image").vision


def run(device="cuda", runs=5, seed=0) -> dict:
    """{"<arm>_fwd" / "<arm>_fwdbwd": median ms per stack} for the arms
    "unfused" and "fused"; the switch is off again afterwards."""
    dev = resolve_device(device)
    cfg = config()
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = cast_tree(init_vision_params(gen, cfg)["blocks"], torch.bfloat16)
    x0 = torch.randn(B, cfg.seq_len, cfg.hidden_size, generator=gen,
                     device=dev).to(torch.bfloat16)
    kw = dict(num_heads=cfg.num_heads, act=get_activation(cfg.hidden_act),
              eps=cfg.layer_norm_eps, lora_scaling=cfg.lora_alpha / cfg.lora_r)

    def fwd():
        with torch.inference_mode():
            return _encoder(blocks, x0, **kw)

    def fwdbwd():
        x = x0.detach().requires_grad_()
        h = _encoder(blocks, x, remat=REMAT, **kw)
        return torch.autograd.grad(h.float().sum(), x)[0]

    times = {f"{arm}_{k}": [] for arm in ("unfused", "fused")
             for k in ("fwd", "fwdbwd")}
    try:
        for arm in ("unfused", "fused", "fused", "unfused"):
            lnl.FUSE_LN2_FC1 = arm == "fused"
            before = LAUNCHES["ln_linear"]
            fwd()
            launched = LAUNCHES["ln_linear"] - before
            want = cfg.num_layers if arm == "fused" else 0
            if launched != want:
                raise AssertionError(f"{arm} stack launched K5 {launched} "
                                     f"times, expected {want}")
            times[f"{arm}_fwd"] += event_ms(fwd, runs)
            times[f"{arm}_fwdbwd"] += event_ms(fwdbwd, runs)
    finally:
        lnl.FUSE_LN2_FC1 = False
    return {k: statistics.median(v) for k, v in times.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    ms = run(runs=args.runs)
    for k in ("fwd", "fwdbwd"):
        print(f"ln_linear_probe {k}: unfused {ms['unfused_' + k]:.3f} ms/stack,"
              f" fused {ms['fused_' + k]:.3f} ms/stack, fused saves "
              f"{ms['unfused_' + k] - ms['fused_' + k]:+.3f} ms/stack")
    print(json.dumps({"ln_linear_probe_ms_per_stack": ms,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
