"""The CLIP dual tower (text + vision), after missm_tpu/models/tower.py.

Plain functions over parameter dicts, laid out as in the JAX package (linear
weights (in, out)), except that the transformer blocks are a list of
per-layer dicts walked by a Python loop where JAX stacks them [L, ...] for
`lax.scan`. This slice ports the text tower and the vision tower on 4-D
image input, forward and backward, with full per-block remat; temporal
attention, tube-3D embedding, 5-D/7-D video input, patch dropout and the
named remat policies raise NotImplementedError.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import TextConfig, TowerConfig, VisionConfig
from ..ops.attention import multi_head_attention
from ..ops.basic import get_activation, layer_norm, linear

# ---------------------------------------------------------------------------
# Initialization (the JAX package's distributions, drawn from a Generator)
# ---------------------------------------------------------------------------


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _init_linear(gen, d_in, d_out, std, bias=True):
    p = {"w": _normal(gen, (d_in, d_out), std)}
    if bias:
        p["b"] = torch.zeros(d_out, device=gen.device)
    return p


def _init_lora(gen, d_in, d_out, r):
    """peft defaults: A ~ U(+-1/sqrt(fan_in)), B = 0."""
    bound = 1.0 / math.sqrt(d_in)
    return {
        "lora_a": torch.empty(d_in, r, device=gen.device).uniform_(
            -bound, bound, generator=gen),
        "lora_b": torch.zeros(r, d_out, device=gen.device),
    }


def _init_attn(gen, d, num_layers, lora_r=0):
    in_std = (d ** -0.5) * ((2 * num_layers) ** -0.5)
    out_std = d ** -0.5
    p = {
        "q": _init_linear(gen, d, d, in_std),
        "k": _init_linear(gen, d, d, in_std),
        "v": _init_linear(gen, d, d, in_std),
        "out": _init_linear(gen, d, d, out_std),
    }
    if lora_r:
        for name in ("q", "k", "v", "out"):
            p[name].update(_init_lora(gen, d, d, lora_r))
    return p


def _init_mlp(gen, d, d_ff, num_layers):
    return {
        "fc1": _init_linear(gen, d, d_ff, (2 * d) ** -0.5),
        "fc2": _init_linear(gen, d_ff, d,
                            (d ** -0.5) * ((2 * num_layers) ** -0.5)),
    }


def _init_ln(d, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _init_block(gen, d, d_ff, num_layers, attn_lora=0):
    return {
        "ln1": _init_ln(d, gen.device),
        "attn": _init_attn(gen, d, num_layers, lora_r=attn_lora),
        "ln2": _init_ln(d, gen.device),
        "mlp": _init_mlp(gen, d, d_ff, num_layers),
    }


def init_text_params(gen: torch.Generator, cfg: TextConfig):
    d = cfg.hidden_size
    return {
        "token_embedding": _normal(gen, (cfg.vocab_size, d), 0.02),
        "position_embedding": _normal(gen, (cfg.max_position_embeddings, d),
                                      0.02),
        "blocks": [_init_block(gen, d, cfg.intermediate_size, cfg.num_layers)
                   for _ in range(cfg.num_layers)],
        "final_ln": _init_ln(d, gen.device),
    }


def _check_vision_config(cfg: VisionConfig):
    if cfg.add_time_attn or cfg.use_tube3d:
        raise NotImplementedError(
            "temporal attention and tube-3D embedding are not ported yet")


def init_vision_params(gen: torch.Generator, cfg: VisionConfig):
    _check_vision_config(cfg)
    d = cfg.hidden_size
    patch_in = cfg.num_channels * cfg.patch_size ** 2
    return {
        "class_embedding": _normal(gen, (d,), d ** -0.5),
        "patch_embedding": {"w": _normal(gen, (patch_in, d), 0.02)},
        "position_embedding": _normal(gen, (cfg.num_patches + 1, d), 0.02),
        "pre_ln": _init_ln(d, gen.device),
        "blocks": [_init_block(gen, d, cfg.intermediate_size, cfg.num_layers,
                               attn_lora=cfg.lora_r)
                   for _ in range(cfg.num_layers)],
        "post_ln": _init_ln(d, gen.device),
    }


def init_tower_params(gen: torch.Generator, cfg: TowerConfig):
    return {
        "text": init_text_params(gen, cfg.text),
        "vision": init_vision_params(gen, cfg.vision),
        "text_projection": {"w": _normal(
            gen, (cfg.text.hidden_size, cfg.projection_dim),
            cfg.text.hidden_size ** -0.5)},
        "visual_projection": {"w": _normal(
            gen, (cfg.vision.hidden_size, cfg.projection_dim),
            cfg.vision.hidden_size ** -0.5)},
        "logit_scale": torch.tensor(cfg.logit_scale_init, device=gen.device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block(p, x, *, num_heads, act, eps, causal=False, key_bias=None,
           lora_scaling=None):
    h = x + multi_head_attention(p["attn"], layer_norm(p["ln1"], x, eps),
                                 num_heads=num_heads, causal=causal,
                                 key_bias=key_bias, lora_scaling=lora_scaling)
    wide = act(linear(p["mlp"]["fc1"], layer_norm(p["ln2"], h, eps)))
    return h + linear(p["mlp"]["fc2"], wide)


def _block_forward(p, x, *, remat=False, **kwargs):
    """One pre-LN transformer block (the non-temporal branch).

    remat=True recomputes the block in the backward and keeps only its
    input (missm_tpu/models/tower.py's jax.checkpoint with policy=None).
    The named policies of the JAX package save tensors by name, and the
    attention kernels' outputs are invisible to PyTorch's selective
    checkpointing, so they are not ported yet."""
    if remat is False:
        return _block(p, x, **kwargs)
    if remat is not True:
        raise NotImplementedError(
            f"remat policy {remat!r} is not ported yet (only True/False)")
    return checkpoint(functools.partial(_block, p, **kwargs), x,
                      use_reentrant=False)


def _encoder(blocks, x, **kwargs):
    for p in blocks:
        x = _block_forward(p, x, **kwargs)
    return x


def text_features(params, cfg: TextConfig, input_ids, attention_mask=None, *,
                  remat=False, projection=None):
    """input_ids: [B, L] -> (last_hidden [B, L, D], pooled [B, D]).

    attention_mask: optional [B, L] (1 = attend, 0 = pad), turned into the
    additive key bias (finfo(float32).min at pads) that joins the causal mask.
    `projection` (no bias) maps pooled into the shared embedding space."""
    B, L = input_ids.shape
    input_ids = input_ids.long()
    x = params["token_embedding"][input_ids]
    x = x + params["position_embedding"][:L][None]
    key_bias = None
    if attention_mask is not None:
        neg = torch.finfo(torch.float32).min
        key_bias = torch.where(attention_mask[:, None, :] == 0, neg,
                               0.0).float()
    x = _encoder(params["blocks"], x, num_heads=cfg.num_heads,
                 act=get_activation(cfg.hidden_act), eps=cfg.layer_norm_eps,
                 causal=True, key_bias=key_bias, remat=remat)
    x = layer_norm(params["final_ln"], x, cfg.layer_norm_eps)
    # EOT pooling: the first position of the highest token id
    eot = torch.argmax(input_ids, dim=-1)
    pooled = x[torch.arange(B, device=x.device), eot]
    if projection is not None:
        pooled = linear(projection, pooled)
    return x, pooled


def vision_features(params, cfg: VisionConfig, pixel_values, *, train=False,
                    remat=False, projection=None):
    """pixel_values: [B, C, H, W] -> pooled [B, D] (CLS -> post-LN ->
    projection). `train` changes nothing here but patch dropout, which is
    not ported: a train-mode call with force_patch_dropout > 0 raises."""
    _check_vision_config(cfg)
    if pixel_values.dim() != 4:
        raise NotImplementedError(
            f"only 4-D image input is ported; got {pixel_values.dim()}-D")
    if train and cfg.force_patch_dropout > 0.0:
        raise NotImplementedError("patch dropout is not ported yet")
    B, C, H, W = pixel_values.shape
    d = cfg.hidden_size
    p_sz = cfg.patch_size
    # strided conv; the weight is stored (C*p*p, D) in (c, i, j) order
    w = params["patch_embedding"]["w"].reshape(C, p_sz, p_sz, d)
    emb = F.conv2d(pixel_values, w.permute(3, 0, 1, 2).to(pixel_values.dtype),
                   stride=p_sz)                       # [B, d, gh, gw]
    emb = emb.flatten(2).transpose(1, 2)              # [B, gh*gw, d]
    cls = params["class_embedding"].expand(B, 1, d)
    x = torch.cat([cls, emb], dim=1) + params["position_embedding"][None]
    x = layer_norm(params["pre_ln"], x, cfg.layer_norm_eps)

    lora_scaling = (cfg.lora_alpha / cfg.lora_r) if cfg.lora_r else None
    x = _encoder(params["blocks"], x, num_heads=cfg.num_heads,
                 act=get_activation(cfg.hidden_act), eps=cfg.layer_norm_eps,
                 lora_scaling=lora_scaling, remat=remat)
    # one frame per image, so the JAX package's mean over frames is the
    # identity here
    pooled = layer_norm(params["post_ln"], x[:, 0, :], cfg.layer_norm_eps)
    if projection is not None:
        pooled = linear(projection, pooled)
    return pooled
