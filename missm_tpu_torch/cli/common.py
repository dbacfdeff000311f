"""Shared CLI plumbing, after missm_tpu/cli/common.py: model construction
from args, tokenizer and media-loader wiring, checkpoint-based
initialization. One device: the JAX package's mesh setup, batch placement,
eval-batch rounding and pipeline checks have no counterpart (the batch is
the per-device batch).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from ..core.config import TowerConfig, languagebind_large, tiny_tower
from ..core.device import resolve_device
from ..data.preprocess import make_media_loaders
from ..data.tokenizer import HashTokenizer, load_tokenizer
from ..models.encoder import build_encoder_params
from ..models.finetune import ModelConfig, init_model_params, tree_map
from ..models.fusion import FusionConfig, init_fusion

# fusion types that force train-time missing simulation
# (reference train_ddp.py:163-164)
FORCE_TRAIN_MISSING = ("regression", "unified_graph", "dedicated_dnn",
                       "MTD_stu", "KL_stu", "self_distill")

# the reference's `LanguageBind/<name>` hub layout, cached locally
CHECKPOINT_NAMES = {"image": "LanguageBind_Image",
                    "video": "LanguageBind_Video",
                    "audio": "LanguageBind_Audio",
                    "depth": "LanguageBind_Depth",
                    "thermal": "LanguageBind_Thermal"}


def clip_modalities(modality_types):
    return [m for m in modality_types if m != "language"]


def build_tower_cfgs(args) -> Dict[str, TowerConfig]:
    mods = clip_modalities(args.modality_types)
    if not mods:
        raise ValueError("need at least one non-language modality (the "
                         "language tower aliases the last vision tower's "
                         "text encoder, as in the reference)")
    build = languagebind_large if args.model_scale == "large" else tiny_tower
    cfgs = {m: build(m) for m in mods}
    backend = getattr(args, "video_decode_backend", None)
    if backend and "video" in cfgs:
        cfgs["video"] = dataclasses.replace(cfgs["video"],
                                            video_decode_backend=backend)
    return cfgs


def build_model_config(args, num_classes: int) -> ModelConfig:
    towers = build_tower_cfgs(args)
    feature_dims = args.feature_dims
    if args.model_scale == "tiny":
        feature_dims = next(iter(towers.values())).projection_dim
    fusion = FusionConfig(
        fusion_type=args.fusion_type,
        modality_types=tuple(args.modality_types),
        output_dims=num_classes,
        feature_dims=feature_dims,
        fusion_dim=args.fusion_dim,
        dropout_prob=args.dropout_prob,
    )
    return ModelConfig(towers=tuple(towers.items()), fusion=fusion,
                       remat=getattr(args, "remat", False),
                       compute_dtype=("bfloat16"
                                      if getattr(args, "bf16", False)
                                      else "float32"))


def _load_torch_state_dict(ckpt_dir: str):
    for name in ("pytorch_model.bin", "model.safetensors"):
        p = os.path.join(ckpt_dir, name)
        if os.path.exists(p):
            if name.endswith(".bin"):
                return torch.load(p, map_location="cpu", weights_only=True)
            try:
                from safetensors.torch import load_file
            except ImportError as e:
                raise ImportError(
                    f"{p} needs the `safetensors` package, which is not "
                    "installed") from e
            return load_file(p)
    raise FileNotFoundError(
        f"no checkpoint (pytorch_model.bin / model.safetensors) in "
        f"{ckpt_dir}")


def init_params(args, cfg: ModelConfig, seed: int):
    """The model's params on `args.device`. --init random: the seeded init
    (models/finetune.py::init_model_params). --init checkpoint: convert the
    LanguageBind checkpoints found under `checkpoint_dir/LanguageBind_<M>`,
    then inject fresh LoRA into each vision tower and init the fusion head,
    both drawn from one generator seeded with `seed` (the JAX package
    splits a key; the numbers differ, the distributions do not)."""
    dev = resolve_device(getattr(args, "device", "cuda"))
    if args.init == "random":
        return init_model_params(cfg, seed=seed, device=dev)

    from ..compat.convert import convert_tower_state_dict
    from ..models.tower import inject_lora

    gen = torch.Generator(device=dev).manual_seed(seed)
    towers = {}
    for m, tcfg in cfg.tower_dict.items():
        sd = _load_torch_state_dict(os.path.join(args.checkpoint_dir,
                                                 CHECKPOINT_NAMES[m]))
        tp = convert_tower_state_dict(sd, tcfg, device=dev)
        # the reference applies LoRA after loading (modeling_image.py:772)
        tp["vision"] = inject_lora(gen, tp["vision"], tcfg.vision)
        towers[m] = tp
    encoder = build_encoder_params(towers, list(cfg.tower_dict))
    return {"encoder": encoder, "fusion": init_fusion(gen, cfg.fusion)}


def make_tokenizer(args):
    any_tower = next(iter(build_tower_cfgs(args).values()))
    context = any_tower.text.max_position_embeddings
    text_vocab = any_tower.text.vocab_size
    tok = load_tokenizer(args.vocab_file, args.merges_file,
                         context_length=context,
                         allow_hash_fallback=getattr(args, "hash_tokenizer",
                                                     False))
    if isinstance(tok, HashTokenizer):
        tok.vocab_size = text_vocab
        tok.bos_id = text_vocab - 2
        tok.eos_id = text_vocab - 1
    return tok


def make_loader_fns(args):
    """The media loaders of the run's towers, their transforms on
    `args.device`."""
    return make_media_loaders(
        build_tower_cfgs(args),
        reference_randomness=getattr(args, "reference_randomness", False),
        seed=args.seed, device=getattr(args, "device", "cuda"))


def to_device(tree, device):
    """A restored param tree (CPU tensors) moved to `device`."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)
