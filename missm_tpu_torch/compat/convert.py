"""PyTorch (HF / LanguageBind) checkpoint -> the port's tower params, after
missm_tpu/compat/convert.py.

Maps an HF-CLIP-style `state_dict` (torch tensors or numpy arrays) onto the
port's tower params (models/tower.py), in its layout: linear weights
(in, out) and the transformer blocks as a list of per-layer dicts.
Handles:
- plain HF CLIP naming (CLIPModel / the reference's LanguageBind towers,
  which reuse HF module names — see image/modeling_image.py:11-12),
- LanguageBind temporal extras (`temporal_attn`, `temporal_layer_norm1/2`,
  `temporal_mlp`, `temporal_embedding` — image/modeling_image.py:74-84),
- peft-LoRA wrapped names (`base_model.model.` prefix, `lora_A/lora_B` —
  what `convert_to_lora` produces at image/modeling_image.py:775-793),
- positional-embedding grid resize for rectangular (audio) towers
  (`resize_pos`, image/modeling_image.py:795-841).

Linear weights transpose from torch's (out, in) to (in, out); the conv
patch embedding flattens to one (C*p*p, D) matmul weight ((C*tube*p*p, D)
for the tube-3D embedding, into which a 2-D checkpoint inflates, its CLS
repeated a tube). Every leaf keeps the checkpoint's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from ..core.config import TextConfig, TowerConfig, VisionConfig
from ..core.device import resolve_device
from ..models.finetune import tree_map
from ..ops.resize import resize_matrix


def _t(x) -> torch.Tensor:
    """A checkpoint value as a CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _normalize_names(sd: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    out = {}
    for name, v in sd.items():
        n = name
        n = n.replace("base_model.model.", "")  # peft wrapper prefix
        n = n.replace(".base_layer.", ".")      # peft>=0.7 wraps base linear
        n = n.replace(".default.", ".")         # peft adapter name
        out[n] = _t(v)
    return out


def _ln(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _linear(sd, prefix, lora=False):
    p = {"w": sd[prefix + ".weight"].T.contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    if lora and prefix + ".lora_A.weight" in sd:
        p["lora_a"] = sd[prefix + ".lora_A.weight"].T.contiguous()
        p["lora_b"] = sd[prefix + ".lora_B.weight"].T.contiguous()
    return p


def _attn(sd, prefix, lora=False):
    return {
        "q": _linear(sd, prefix + ".q_proj", lora),
        "k": _linear(sd, prefix + ".k_proj", lora),
        "v": _linear(sd, prefix + ".v_proj", lora),
        "out": _linear(sd, prefix + ".out_proj", lora),
    }


def _mlp(sd, prefix, lora=False):
    return {"fc1": _linear(sd, prefix + ".fc1", lora),
            "fc2": _linear(sd, prefix + ".fc2", lora)}


def _text_params(sd, cfg: TextConfig, prefix="text_model."):
    blocks = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}encoder.layers.{i}."
        blocks.append({
            "ln1": _ln(sd, lp + "layer_norm1"),
            "attn": _attn(sd, lp + "self_attn"),
            "ln2": _ln(sd, lp + "layer_norm2"),
            "mlp": _mlp(sd, lp + "mlp"),
        })
    return {
        "token_embedding": sd[prefix + "embeddings.token_embedding.weight"],
        "position_embedding":
            sd[prefix + "embeddings.position_embedding.weight"],
        "blocks": blocks,
        "final_ln": _ln(sd, prefix + "final_layer_norm"),
    }


def resize_position_embedding(pos_embed, new_grid,
                              extra_tokens: int = 1) -> np.ndarray:
    """Bicubic-antialias resize of a square pos-embed grid to `new_grid`
    (gh, gw), in numpy f32 on the host. Matches reference `resize_pos`
    (image/modeling_image.py:795-841): torch F.interpolate(mode='bicubic',
    antialias=True, align_corners=False)."""
    pos_embed = _t(pos_embed).numpy()
    tok, grid_part = pos_embed[:extra_tokens], pos_embed[extra_tokens:]
    old = int(math.isqrt(grid_part.shape[0]))
    gh, gw = new_grid
    if (old, old) == (gh, gw):
        return pos_embed
    d = grid_part.shape[-1]
    img = grid_part.reshape(old, old, d)
    mh = resize_matrix(old, gh, "bicubic", True)
    mw = resize_matrix(old, gw, "bicubic", True)
    img = np.einsum("oh,hwd->owd", mh, img)
    img = np.einsum("pw,owd->opd", mw, img)
    return np.concatenate([tok, img.reshape(gh * gw, d)], axis=0)


def _vision_params(sd, cfg: VisionConfig, prefix="vision_model."):
    blocks = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}encoder.layers.{i}."
        b = {
            "ln1": _ln(sd, lp + "layer_norm1"),
            "attn": _attn(sd, lp + "self_attn",
                          lora=not cfg.add_time_attn),
            "ln2": _ln(sd, lp + "layer_norm2"),
            "mlp": _mlp(sd, lp + "mlp"),
        }
        if cfg.add_time_attn:
            te = sd[lp + "temporal_embedding"]
            b["temporal_embedding"] = te.reshape(-1, te.shape[-1])
            b["tln1"] = _ln(sd, lp + "temporal_layer_norm1")
            b["tattn"] = _attn(sd, lp + "temporal_attn", lora=True)
            if cfg.temporal_mlp and lp + "temporal_mlp.fc1.weight" in sd:
                b["tln2"] = _ln(sd, lp + "temporal_layer_norm2")
                b["tmlp"] = _mlp(sd, lp + "temporal_mlp", lora=True)
        blocks.append(b)

    patch_w = sd[prefix + "embeddings.patch_embedding.weight"]
    if cfg.use_tube3d and patch_w.dim() == 4:
        # expand3d inflation of a Conv2d checkpoint into the tube-3D Conv3d
        # (video/modeling_video.py:80-104): the 2-D weights in tube slot 0,
        # the later slots zero
        zeros = torch.zeros_like(patch_w[:, :, None])
        patch_w = torch.cat([patch_w[:, :, None]]
                            + [zeros] * (cfg.tube_size - 1), dim=2)
    # Conv3d (D, C, tube, p, p) or Conv2d (D, C, p, p) -> one matmul weight
    patch_w = patch_w.reshape(patch_w.shape[0], -1).T.contiguous()

    cls = sd[prefix + "embeddings.class_embedding"]
    if cfg.use_tube3d and cls.dim() == 1:
        # per-tube CLS tokens: repeat(num_frames // tube_size, 1)
        # (video/modeling_video.py:103)
        cls = cls[None].repeat(cfg.num_frames // cfg.tube_size, 1)

    pos = sd[prefix + "embeddings.position_embedding.weight"]
    if pos.shape[0] != cfg.num_patches + 1:
        pos = torch.from_numpy(resize_position_embedding(pos, cfg.grid))

    # HF CLIP spells it 'pre_layrnorm' (sic)
    pre_key = (prefix + "pre_layrnorm" if prefix + "pre_layrnorm.weight" in sd
               else prefix + "pre_layernorm")
    return {
        "class_embedding": cls,
        "patch_embedding": {"w": patch_w},
        "position_embedding": pos,
        "pre_ln": _ln(sd, pre_key),
        "blocks": blocks,
        "post_ln": _ln(sd, prefix + "post_layernorm"),
    }


def convert_tower_state_dict(state_dict: Mapping[str, object],
                             cfg: TowerConfig, *, device="cuda"):
    """Full dual-tower state dict -> the port's tower params on `device`."""
    sd = _normalize_names(state_dict)
    params = {
        "text": _text_params(sd, cfg.text),
        "vision": _vision_params(sd, cfg.vision),
        "text_projection": _linear(sd, "text_projection"),
        "visual_projection": _linear(sd, "visual_projection"),
        "logit_scale": sd["logit_scale"].reshape(()),
    }
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)
