"""Ablation probe: where does the ViT-L image stack's forward time go? The
port's counterpart of scripts/ablation_probe.py.

The 24-block ViT-L/14 image stack (languagebind_large("image").vision) at
B = 64 in bf16, seeded random weights, no LoRA (the script's linear(p, h)
calls carry none), run forward in inference mode with its attention
swapped per arm (ARMS):

  identity         attention = v: the stack without attention
  production       the port's own `kernels.attention` (K1's kernel,
                   csrc/attention.cu, online softmax)
  packed dotsonly  P4 with the softmax knocked out: e = s, den = 1
  packed noexp     P4 with exp knocked out: e = s - m, den = sum(s - m)
  packed nostage   P4 with each head's operands read in shared memory as
                   the input lays them out: no swizzled per-head tiles
  packed full      P4 as production computes it, with a whole-row softmax
  scratch          P3: one block per (batch, head), the head's whole K
                   and V staged once for all its query tiles
  bhne             P2: q, k, v projected head-major [B, H, N, hd] (bias
                   added in f32 before the one rounding), attention per
                   (batch, head), the out-projection reading the
                   head-major output

The script's main() runs identity, production, dotsonly, noexp, nostage and
scratch; it defines bhne and packed full without running them. Each arm:
one stack whose output is held against the production arm's (relative
norm), then CUDA events around one stack, the median of `runs` stacks after
two warm-up stacks, and the launches of each count over those 3 + runs
stacks.

    python -m missm_tpu_torch.probes.ablation_probe [--runs N]

Needs a CUDA GPU (it raises without one).
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics

import numpy as np
import torch

from ..core.config import languagebind_large
from ..core.device import resolve_device
from ..kernels import attention as K
from ..kernels import probe_attention as pa
from ..kernels.launches import LAUNCHES
from ..models.finetune import cast_tree
from ..models.tower import init_vision_params
from ..ops.basic import get_activation, layer_norm, linear, matmul_f32
from .timing import event_ms

B = 64


def config():
    """The stack's tower: LanguageBind_Image's ViT-L/14."""
    return languagebind_large("image").vision


def setup(device="cuda", cfg=None, batch=B, seed=0):
    """(blocks, x): the tower's seeded blocks in bf16 and x [batch, N, D]
    bf16 from numpy's f64 standard normals, as the script makes it."""
    dev = resolve_device(device)
    cfg = config() if cfg is None else cfg
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = cast_tree(init_vision_params(gen, cfg)["blocks"], torch.bfloat16)
    x = np.random.default_rng(seed).standard_normal(
        (batch, cfg.seq_len, cfg.hidden_size))
    return blocks, torch.from_numpy(x).to(torch.bfloat16).to(dev)


def _stack(blocks, x, cfg, attention):
    """The script's pre-LN block over every block of the stack, with
    attention(p["attn"], ln1(x)) giving the projected attention output."""
    act = get_activation(cfg.hidden_act)
    eps = cfg.layer_norm_eps
    for p in blocks:
        x = x + attention(p["attn"], layer_norm(p["ln1"], x, eps))
        h = layer_norm(p["ln2"], x, eps)
        x = x + linear(p["mlp"]["fc2"], act(linear(p["mlp"]["fc1"], h)))
    return x


def _token_attention(attend):
    """q, k, v projected [B, N, D], attend(q, k, v), projected out."""
    def attention(p, h):
        q, k, v = (linear(p[name], h) for name in "qkv")
        return linear(p["out"], attend(q, k, v))
    return attention


def tower(blocks, x, cfg, attn_mode):
    """The stack with attention `attn_mode`: "identity" (attention = v) or
    "production" (the port's attention wrapper)."""
    if attn_mode == "identity":
        attend = lambda q, k, v: v  # noqa: E731
    elif attn_mode == "production":
        attend = functools.partial(K.attention, num_heads=cfg.num_heads)
    else:
        raise ValueError(f"attn_mode must be 'identity' or 'production'; "
                         f"got {attn_mode!r}")
    return _stack(blocks, x, cfg, _token_attention(attend))


def tower_packed_debug(blocks, x, cfg, mode):
    """The stack with P4 in `mode` (kernels.probe_attention.MODES)."""
    return _stack(blocks, x, cfg, _token_attention(functools.partial(
        pa.tower_packed_debug, num_heads=cfg.num_heads, mode=mode)))


def tower_scratch(blocks, x, cfg):
    """The stack with P3."""
    return _stack(blocks, x, cfg, _token_attention(functools.partial(
        pa.tower_scratch, num_heads=cfg.num_heads)))


def tower_bhne(blocks, x, cfg):
    """The stack with head-major projections and P2: q, k, v as
    einsum("bnd,dhe->bhne") with the bias added in f32 before the cast, the
    out-projection as einsum("bhne,hed->bnd") plus its bias in f32. The
    products are bf16 GEMMs with an f32 output (ops.basic.matmul_f32); the
    head-major relayout is a copy, where XLA fuses it into the product."""
    H = cfg.num_heads

    def attention(p, h):
        Bt, N, D = h.shape

        def proj(name):
            y = matmul_f32(h.reshape(Bt * N, D), p[name]["w"]) + p[name]["b"]
            return (y.to(h.dtype).reshape(Bt, N, H, D // H).transpose(1, 2)
                    .contiguous())

        a = pa.tower_bhne(proj("q"), proj("k"), proj("v"))
        a = a.transpose(1, 2).reshape(Bt * N, D)
        o = matmul_f32(a, p["out"]["w"]) + p["out"]["b"]
        return o.to(h.dtype).reshape(Bt, N, D)

    return _stack(blocks, x, cfg, attention)


ARMS = {
    "identity": functools.partial(tower, attn_mode="identity"),
    "production": functools.partial(tower, attn_mode="production"),
    **{f"packed {mode}": functools.partial(tower_packed_debug, mode=mode)
       for mode in ("dotsonly", "noexp", "nostage", "full")},
    "scratch": tower_scratch,
    "bhne": tower_bhne,
}


def run(device="cuda", runs=5, seed=0, *, cfg=None, batch=B) -> dict:
    """Every arm of ARMS in turn: {"ms": median ms per stack, "img_per_s",
    "rel_err": ||arm - production|| / ||production|| of one stack's output,
    "finite": whether that output is finite, "launches": {count: launches}
    over the arm's 3 + runs stacks}, each keyed by arm."""
    cfg = config() if cfg is None else cfg
    blocks, x = setup(device, cfg, batch, seed)
    result = {k: {} for k in ("ms", "img_per_s", "rel_err", "finite",
                              "launches")}
    with torch.inference_mode():
        ref = ARMS["production"](blocks, x, cfg).float()
        for name, fn in ARMS.items():
            before = dict(LAUNCHES)
            out = fn(blocks, x, cfg).float()
            result["rel_err"][name] = ((out - ref).norm() / ref.norm()).item()
            result["finite"][name] = bool(torch.isfinite(out).all())
            del out
            ms = statistics.median(event_ms(lambda: fn(blocks, x, cfg), runs))
            result["ms"][name] = ms
            result["img_per_s"][name] = batch / ms * 1e3
            result["launches"][name] = {
                k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    res = run(runs=args.runs)
    for name, ms in res["ms"].items():
        print(f"ablation_probe {name}: {ms:.3f} ms/stack "
              f"({res['img_per_s'][name]:.0f} img/s), output vs production "
              f"{res['rel_err'][name]:.3e}", flush=True)
    print(json.dumps({"ablation_probe": res,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
