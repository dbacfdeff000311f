"""Trainable-vs-frozen parameter labels, after
missm_tpu/train/trainability.py.

The reference's peft semantics: inside each LoRA'd vision tower's `blocks`
only the LoRA A/B matrices train; everything else (patch, class and position
embeddings, pre/post LN, the text tower, projections, logit scale and the
fusion head) trains too. With lora_r == 0 nothing is frozen. Labels are a
tree of the params' structure (dicts, and lists for the per-layer blocks)
holding TRAIN or FROZEN at every leaf.
"""
from __future__ import annotations

import torch

from ..models.finetune import ModelConfig, tree_map

TRAIN = "train"
FROZEN = "frozen"


def param_labels(params, cfg: ModelConfig):
    """TRAIN/FROZEN for every leaf of `params`."""
    labels = tree_map(lambda _: TRAIN, params)

    def lora_only(tree):
        if isinstance(tree, dict):
            return {k: TRAIN if k in ("lora_a", "lora_b") else lora_only(v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [lora_only(v) for v in tree]
        return FROZEN

    for mod, tcfg in cfg.tower_dict.items():
        if tcfg.vision.lora_r:
            vision = labels["encoder"][mod]["vision"]
            vision["blocks"] = lora_only(params["encoder"][mod]["vision"]
                                         ["blocks"])
    return labels


def leaves(tree):
    """The tensors of a param tree, in the order tree_map visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def cast_frozen_params(params, cfg: ModelConfig, dtype="bfloat16"):
    """The FROZEN leaves stored in `dtype` (the JAX package's --frozen_bf16).

    Bit-identical under a compute_dtype of the same type, since the forward
    casts the encoder to it anyway; in any other compute type the frozen
    weights would be read at reduced precision, so this raises."""
    if cfg.compute_dtype != dtype:
        raise ValueError(
            f"cast_frozen_params({dtype}) requires compute_dtype={dtype}; "
            f"got {cfg.compute_dtype}")
    dt = getattr(torch, dtype)
    flat = iter(leaves(param_labels(params, cfg)))
    return tree_map(lambda t: t.to(dt) if next(flat) == FROZEN
                    and t.is_floating_point() else t, params)


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def count_trainable(params, labels) -> int:
    return sum(t.numel() for t, label in zip(leaves(params), leaves(labels))
               if label == TRAIN)
