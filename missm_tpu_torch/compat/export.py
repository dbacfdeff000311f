"""The port's tower params -> an HF/LanguageBind-style torch state dict,
the inverse of compat/convert.py, after missm_tpu/compat/export.py: trained
towers load back into HF/PyTorch tooling or diff against reference
checkpoints. The port keeps its blocks as a list, so the walk needs no
layer slicing.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core.config import TowerConfig


def _t(x):
    return x.detach().cpu().contiguous()


def _put_linear(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["w"].T)
    if "b" in p:
        sd[prefix + ".bias"] = _t(p["b"])
    if "lora_a" in p:
        sd[prefix + ".lora_A.weight"] = _t(p["lora_a"].T)
        sd[prefix + ".lora_B.weight"] = _t(p["lora_b"].T)


def _put_ln(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _put_attn(sd, prefix, p):
    for name, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                       ("out", "out_proj")):
        _put_linear(sd, f"{prefix}.{proj}", p[name])


def _put_block(sd, lp, b):
    _put_ln(sd, lp + "layer_norm1", b["ln1"])
    _put_ln(sd, lp + "layer_norm2", b["ln2"])
    _put_attn(sd, lp + "self_attn", b["attn"])
    _put_linear(sd, lp + "mlp.fc1", b["mlp"]["fc1"])
    _put_linear(sd, lp + "mlp.fc2", b["mlp"]["fc2"])


def export_tower_state_dict(params,
                            cfg: TowerConfig) -> Dict[str, torch.Tensor]:
    """Full dual-tower params (init_tower_params' or the converter's tree)
    -> {HF name: CPU tensor}, each leaf in its own type."""
    sd: Dict[str, torch.Tensor] = {}
    t = params["text"]
    sd["text_model.embeddings.token_embedding.weight"] = _t(
        t["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = _t(
        t["position_embedding"])
    for i, b in enumerate(t["blocks"]):
        _put_block(sd, f"text_model.encoder.layers.{i}.", b)
    _put_ln(sd, "text_model.final_layer_norm", t["final_ln"])

    v, vc = params["vision"], cfg.vision
    sd["vision_model.embeddings.class_embedding"] = _t(v["class_embedding"])
    pw = v["patch_embedding"]["w"].T
    if vc.use_tube3d:  # the Conv3d weight (D, C, tube, p, p)
        pw = pw.reshape(-1, vc.num_channels, vc.tube_size, vc.patch_size,
                        vc.patch_size)
    else:
        pw = pw.reshape(-1, vc.num_channels, vc.patch_size, vc.patch_size)
    sd["vision_model.embeddings.patch_embedding.weight"] = _t(pw)
    sd["vision_model.embeddings.position_embedding.weight"] = _t(
        v["position_embedding"])
    _put_ln(sd, "vision_model.pre_layrnorm", v["pre_ln"])
    _put_ln(sd, "vision_model.post_layernorm", v["post_ln"])
    for i, b in enumerate(v["blocks"]):
        lp = f"vision_model.encoder.layers.{i}."
        _put_block(sd, lp, b)
        if "tattn" in b:
            sd[lp + "temporal_embedding"] = _t(b["temporal_embedding"][None])
            _put_ln(sd, lp + "temporal_layer_norm1", b["tln1"])
            _put_attn(sd, lp + "temporal_attn", b["tattn"])
            if "tmlp" in b:
                _put_ln(sd, lp + "temporal_layer_norm2", b["tln2"])
                _put_linear(sd, lp + "temporal_mlp.fc1", b["tmlp"]["fc1"])
                _put_linear(sd, lp + "temporal_mlp.fc2", b["tmlp"]["fc2"])

    _put_linear(sd, "visual_projection", params["visual_projection"])
    _put_linear(sd, "text_projection", params["text_projection"])
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd
