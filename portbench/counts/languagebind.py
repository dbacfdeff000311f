"""The LanguageBind family's counts: the matrix products of one row or
sample (counts.flops.Product, by the rules in flops.py's docstring) and the
port's attention kernel calls of a batch (counts.flops.AttnCall), from a
configs/*.json dict. Nothing here reads the port.

Products: each vision tower's patch embedding, q/k/v/out, MLP, attention
and projection, a temporal tower's temporal q/k/v/out and attention, the
LoRA factors; the CLIP text tower (causal attention, trained whole); the
`sum` head.
"""
from __future__ import annotations

from portbench.counts.flops import AttnCall, Product


def _vision_products(mod, v, proj):
    d, f, L = v["hidden_size"], v["intermediate_size"], v["num_layers"]
    ps, c = v["patch_size"], v["num_channels"]
    gh, gw = v["image_size"][0] // ps, v["image_size"][1] // ps
    n = gh * gw + 1
    time = bool(v.get("add_time_attn"))
    T = v.get("num_frames", 1) if time else 1
    r = v["lora_r"]
    rows = T * n                      # tokens a sample
    out = [Product(f"{mod}.patch", T * (n - 1), c * ps * ps, d, 1,
                   False, True),
           Product(f"{mod}.qkvo", rows, d, d, 4 * L, True, False),
           Product(f"{mod}.fc1", rows, d, f, L, True, False),
           Product(f"{mod}.fc2", rows, f, d, L, True, False),
           # scores and values: per frame, N x N pairs of head dims summing
           # to d (2 x 2 N^2 d a layer and frame)
           Product(f"{mod}.attn", T * n, d, n, 2 * L, True, False, inputs=2),
           Product(f"{mod}.proj", 1, d, proj, 1, True, True)]
    if time:
        out += [Product(f"{mod}.tqkvo", rows, d, d, 4 * L, True, False),
                Product(f"{mod}.tattn", n * T, d, T, 2 * L, True, False,
                        inputs=2)]
    if r:
        # peft's branch (x A) B on the LoRA'd projections
        out += [Product(f"{mod}.lora_a", rows, d, r, 4 * L, True, True),
                Product(f"{mod}.lora_b", rows, r, d, 4 * L, True, True)]
    return out


def _text_products(t, proj):
    d, f, L = t["hidden_size"], t["intermediate_size"], t["num_layers"]
    n = t["max_position_embeddings"]
    pairs = n * (n + 1) // 2          # causal: keys at or before the query
    return [Product("text.qkvo", n, d, d, 4 * L, True, True),
            Product("text.fc1", n, d, f, L, True, True),
            Product("text.fc2", n, f, d, L, True, True),
            # 2 x 2 x pairs x d a layer: m k n = pairs d
            Product("text.attn", pairs, d, 1, 2 * L, True, False, inputs=2),
            Product("text.proj", 1, d, proj, 1, True, True)]


def _head_products(fu, modalities):
    fd = fu["fusion_dim"]
    return [Product("head.proj", 1, fu["feature_dims"], fd, len(modalities),
                    True, True),
            Product("head.fc1", 1, fd, fd, 1, True, True),
            Product("head.fc2", 1, fd, fu["output_dims"], 1, True, True)]


def products(cfg):
    """Every matrix product of one row or sample of config `cfg`."""
    proj = cfg["projection_dim"]
    out = []
    for mod, v in cfg["towers"]:
        out += _vision_products(mod, v, proj)
    out += _text_products(cfg["text"], proj)
    out += _head_products(cfg["fusion"], cfg["modality_types"])
    return out


def attention_calls(cfg, batch: int, train: bool):
    """The port's attention kernel calls of one batch of `batch` rows: the
    vision towers' spatial attention, the temporal attention and the text
    tower's causal attention forward; in training also the backward
    kernels (the causal attention's backward is plain PyTorch in the port,
    so it has none)."""
    calls = []
    for _, v in cfg["towers"]:
        ps = v["patch_size"]
        n = (v["image_size"][0] // ps) * (v["image_size"][1] // ps) + 1
        h, hd = v["num_heads"], v["hidden_size"] // v["num_heads"]
        L = v["num_layers"]
        T = v.get("num_frames", 1) if v.get("add_time_attn") else 1
        calls += [AttnCall("forward", batch * T, n, h, hd, lse=train)] * L
        if train:
            calls += [AttnCall("backward", batch * T, n, h, hd)] * L
        if v.get("add_time_attn"):
            calls += [AttnCall("short", batch * n, T, h, hd)] * L
            if train:
                calls += [AttnCall("short_backward", batch * n, T, h, hd)] * L
    t = cfg["text"]
    calls += [AttnCall("forward", batch, t["max_position_embeddings"],
                       t["num_heads"], t["hidden_size"] // t["num_heads"],
                       causal=True, kbias=bool(cfg.get("text_attention_mask")))
              ] * t["num_layers"]
    return calls
