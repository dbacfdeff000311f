"""The benchmark's seeded weights, in the parameter layout the port takes.

Plain PyTorch: this module imports nothing of the port. It lays the tree out
as `missm_tpu_torch.models.finetune.init_model_params` does (linear weights
(in, out), per-layer block lists, the language branch being the last tower's
text tower) and draws CLIP's init distributions, but from its own generator
and in a few large calls: one normal and one uniform draw for the whole tree,
on the device given, then carved into leaves. The same tree goes to the port
and, regenerated from the same seed, to the plain reference.
"""
from __future__ import annotations

import math

import torch

NORMAL, UNIFORM, ZEROS, ONES, CONST = "n", "u", "z", "o", "c"


def _lin(d_in, d_out, std, bias=True):
    p = {"w": (NORMAL, (d_in, d_out), std)}
    if bias:
        p["b"] = (ZEROS, (d_out,), None)
    return p


def _lora(p, d_in, d_out, r):
    p["lora_a"] = (UNIFORM, (d_in, r), 1.0 / math.sqrt(d_in))
    p["lora_b"] = (ZEROS, (r, d_out), None)
    return p


def _ln(d):
    return {"scale": (ONES, (d,), None), "bias": (ZEROS, (d,), None)}


def _attn(d, layers, lora_r):
    in_std = d ** -0.5 * (2 * layers) ** -0.5
    p = {n: _lin(d, d, in_std) for n in ("q", "k", "v")}
    p["out"] = _lin(d, d, d ** -0.5)
    if lora_r:
        for n in ("q", "k", "v", "out"):
            _lora(p[n], d, d, lora_r)
    return p


def _mlp(d, f, layers):
    return {"fc1": _lin(d, f, (2 * d) ** -0.5),
            "fc2": _lin(f, d, d ** -0.5 * (2 * layers) ** -0.5)}


def _block(d, f, layers, *, time_attn=False, frames=1, lora_r=0):
    """A pre-LN block; a video block also has the temporal embedding, tln1
    and the temporal attention, which then carries the LoRA."""
    p = {"ln1": _ln(d), "attn": _attn(d, layers, 0 if time_attn else lora_r),
         "ln2": _ln(d), "mlp": _mlp(d, f, layers)}
    if time_attn:
        p["temporal_embedding"] = (NORMAL, (frames, d), d ** -0.5)
        p["tln1"] = _ln(d)
        p["tattn"] = _attn(d, layers, lora_r)
    return p


def _vision(v, proj):
    d, f, L = v["hidden_size"], v["intermediate_size"], v["num_layers"]
    gh = v["image_size"][0] // v["patch_size"]
    gw = v["image_size"][1] // v["patch_size"]
    if v.get("add_time_attn") and v.get("temporal_mlp"):
        raise ValueError("the temporal MLP is not laid out here")
    return {
        "class_embedding": (NORMAL, (d,), d ** -0.5),
        "patch_embedding": {"w": (NORMAL, (v["num_channels"]
                                           * v["patch_size"] ** 2, d), 0.02)},
        "position_embedding": (NORMAL, (gh * gw + 1, d), 0.02),
        "pre_ln": _ln(d),
        "blocks": [_block(d, f, L, time_attn=v.get("add_time_attn", False),
                          frames=v.get("num_frames", 1), lora_r=v["lora_r"])
                   for _ in range(L)],
        "post_ln": _ln(d),
    }, {"w": (NORMAL, (d, proj), d ** -0.5)}


def _text(t):
    d, L = t["hidden_size"], t["num_layers"]
    return {
        "token_embedding": (NORMAL, (t["vocab_size"], d), 0.02),
        "position_embedding": (NORMAL, (t["max_position_embeddings"], d), 0.02),
        "blocks": [_block(d, t["intermediate_size"], L) for _ in range(L)],
        "final_ln": _ln(d),
    }


def _torch_linear(d_in, d_out):
    b = 1.0 / math.sqrt(d_in)
    return {"w": (UNIFORM, (d_in, d_out), b), "b": (UNIFORM, (d_out,), b)}


def layout(cfg):
    """The tree of leaf specs (kind, shape, scale) for config `cfg` (a
    configs/*.json dict)."""
    proj = cfg["projection_dim"]
    enc = {}
    for mod, v in cfg["towers"]:
        vision, vproj = _vision(v, proj)
        enc[mod] = {"vision": vision, "proj": vproj,
                    "logit_scale": (CONST, (), cfg["logit_scale_init"])}
    t = cfg["text"]
    enc["language"] = {"text": _text(t),
                       "proj": {"w": (NORMAL, (t["hidden_size"], proj),
                                      t["hidden_size"] ** -0.5)}}
    fu = cfg["fusion"]
    if fu["fusion_type"] != "sum":
        raise ValueError(f"fusion head {fu['fusion_type']!r} is not laid out")
    fd = fu["fusion_dim"]
    fusion = {"proj": {m: _torch_linear(fu["feature_dims"], fd)
                       for m in cfg["modality_types"]},
              "norm": _ln(fd),
              "head": {"fc1": _torch_linear(fd, fd),
                       "fc2": _torch_linear(fd, fu["output_dims"])}}
    return {"encoder": enc, "fusion": fusion}


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    return fn(tree)


def leaves_of(tree):
    """The leaves of a tree of dicts and lists, in key order of insertion."""
    out = []
    _walk(tree, out.append)
    return out


def paths_of(tree, prefix=()):
    """(path, leaf) for every leaf, in the order leaves_of gives them."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in paths_of(v, prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in paths_of(v, prefix + (i,))]
    return [(prefix, tree)]


def make_params(cfg, seed: int, device) -> dict:
    """The f32 parameter tree of `cfg`, drawn from `seed` on `device`."""
    specs = layout(cfg)
    flat = leaves_of(specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(s[1]) for s in flat if s[0] == NORMAL)
    n_uniform = sum(math.prod(s[1]) for s in flat if s[0] == UNIFORM)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    at = {NORMAL: 0, UNIFORM: 0}

    def make(spec):
        kind, shape, scale = spec
        if kind == ZEROS:
            return torch.zeros(shape, device=device)
        if kind == ONES:
            return torch.ones(shape, device=device)
        if kind == CONST:
            return torch.tensor(float(scale), device=device)
        n = math.prod(shape)
        buf = normal if kind == NORMAL else uniform
        part = buf[at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == NORMAL:
            return part * scale
        return part * (2 * scale) - scale

    tree = _walk(specs, make)
    del normal, uniform
    return tree


def trainable(path) -> bool:
    """The reference's peft rule: inside a LoRA'd vision tower's blocks only
    the LoRA factors train; every other leaf trains (every tower here has
    LoRA)."""
    if len(path) > 3 and path[0] == "encoder" and path[2] == "vision" \
            and path[3] == "blocks":
        return path[-1] in ("lora_a", "lora_b")
    return True
