"""The CLIP dual tower (text + vision), after missm_tpu/models/tower.py.

Plain functions over parameter dicts, laid out as in the JAX package (linear
weights (in, out)), except that the transformer blocks are a list of
per-layer dicts walked by a Python loop where JAX stacks them [L, ...] for
`lax.scan`. Ported: the text tower, and the vision tower on 4-D image input
and on 5-D video input [B, C, T, H, W] with the temporal blocks (temporal
embedding, temporal attention, optional temporal MLP), forward and backward,
with full per-block remat, and the contrastive dual-tower forward. Tube-3D
embedding, 7-D input, patch dropout and the named remat policies raise
NotImplementedError. `inject_lora` adds fresh LoRA to converted checkpoint
blocks (compat/convert.py). With
kernels.ln_linear.FUSE_LN2_FC1 on (off by default, as in the JAX package),
each block's ln2 -> fc1 goes through the fused kernel wherever its shape
rule admits it.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import TextConfig, TowerConfig, VisionConfig
from ..kernels import ln_linear as _lnl
from ..ops.attention import multi_head_attention, short_attention
from ..ops.basic import get_activation, l2_normalize, layer_norm, linear

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


def _init_mlp(gen, d, d_ff, num_layers, lora_r=0):
    p = {
        "fc1": _init_linear(gen, d, d_ff, (2 * d) ** -0.5),
        "fc2": _init_linear(gen, d_ff, d,
                            (d ** -0.5) * ((2 * num_layers) ** -0.5)),
    }
    if lora_r:
        p["fc1"].update(_init_lora(gen, d, d_ff, lora_r))
        p["fc2"].update(_init_lora(gen, d_ff, d, lora_r))
    return p


def _init_ln(d, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _init_block(gen, d, d_ff, num_layers, *, time_attn=False,
                temporal_mlp=True, num_frames=1, attn_lora=0):
    """With `time_attn` the block gets the temporal modules and LoRA moves
    from the spatial attention to them (tattn, and tmlp's fc1/fc2)."""
    p = {
        "ln1": _init_ln(d, gen.device),
        "attn": _init_attn(gen, d, num_layers,
                           lora_r=0 if time_attn else attn_lora),
        "ln2": _init_ln(d, gen.device),
        "mlp": _init_mlp(gen, d, d_ff, num_layers),
    }
    if time_attn:
        p["temporal_embedding"] = _normal(gen, (num_frames, d), d ** -0.5)
        p["tln1"] = _init_ln(d, gen.device)
        p["tattn"] = _init_attn(gen, d, num_layers, lora_r=attn_lora)
        if temporal_mlp:
            p["tln2"] = _init_ln(d, gen.device)
            p["tmlp"] = _init_mlp(gen, d, d_ff, num_layers, lora_r=attn_lora)
    return p


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
    if cfg.use_tube3d:
        raise NotImplementedError("tube-3D embedding is not ported yet")


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
                               time_attn=cfg.add_time_attn,
                               temporal_mlp=cfg.temporal_mlp,
                               num_frames=cfg.num_frames,
                               attn_lora=cfg.lora_r)
                   for _ in range(cfg.num_layers)],
        "post_ln": _init_ln(d, gen.device),
    }


def inject_lora(gen: torch.Generator, vision_params, cfg: VisionConfig):
    """Fresh LoRA A/B params on converted (checkpoint) vision blocks, drawn
    from `gen` on its device (missm_tpu/models/tower.py::inject_lora): the
    reference applies `convert_to_lora` after loading pretrained weights
    (image/modeling_image.py:772), so published checkpoints carry no LoRA.

    Targets mirror peft's: the temporal attention and the temporal MLP when
    add_time_attn, else the spatial q/k/v/out projections (ref :775-783).
    Each block gets its own A/B pair, drawn target by target and block by
    block within a target; a target that already has LoRA keeps it. B
    starts at zero, so the adapted blocks compute what the converted ones
    did. Returns new dicts down to the changed leaves; the tensors are
    shared with `vision_params`."""
    if cfg.lora_r == 0:
        return vision_params
    d, d_ff = cfg.hidden_size, cfg.intermediate_size
    blocks = [dict(b) for b in vision_params["blocks"]]
    if cfg.add_time_attn:
        targets = [("tattn", n, d, d) for n in ("q", "k", "v", "out")]
        if "tmlp" in blocks[0]:
            targets += [("tmlp", "fc1", d, d_ff), ("tmlp", "fc2", d_ff, d)]
    else:
        targets = [("attn", n, d, d) for n in ("q", "k", "v", "out")]
    for mod, leaf, d_in, d_out in targets:
        for b in blocks:
            b[mod] = dict(b[mod])
            inner = dict(b[mod][leaf])
            if "lora_a" not in inner:
                inner.update(_init_lora(gen, d_in, d_out, cfg.lora_r))
            b[mod][leaf] = inner
    return dict(vision_params, blocks=blocks)


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


def _temporal(p, x, *, time, num_heads, act, eps, lora_scaling):
    """The temporal half of a video block over x [(B*T), N, D], frame-minor:
    the temporal embedding (T > 1), then attention over the T frames of each
    (video, token) and the optional temporal MLP, each pre-LN and residual.
    LoRA sits on these modules."""
    T, N = time
    D = x.shape[-1]
    if T != 1:
        x = (x.reshape(-1, T, N, D)
             + p["temporal_embedding"][:T][None, :, None]).reshape(-1, N, D)
    # tln1 is per token, so it runs before the [B, T, N] -> [B, N, T] relayout
    ht = layer_norm(p["tln1"], x, eps)
    ht = ht.reshape(-1, T, N, D).transpose(1, 2).reshape(-1, T, D)
    ht = short_attention(p["tattn"], ht, num_heads=num_heads,
                         lora_scaling=lora_scaling)
    x = x + ht.reshape(-1, N, T, D).transpose(1, 2).reshape(-1, N, D)
    if "tmlp" in p:
        # per token as well: it runs on the [(B*T), N, D] stream as it is
        wide = act(linear(p["tmlp"]["fc1"], layer_norm(p["tln2"], x, eps),
                          lora_scaling=lora_scaling))
        x = x + linear(p["tmlp"]["fc2"], wide, lora_scaling=lora_scaling)
    return x


def _block(p, x, *, num_heads, act, eps, causal=False, key_bias=None,
           time=None, lora_scaling=None):
    if time is not None:
        x = _temporal(p, x, time=time, num_heads=num_heads, act=act, eps=eps,
                      lora_scaling=lora_scaling)
        lora_scaling = None  # the spatial attention has no LoRA here
    h = x + multi_head_attention(p["attn"], layer_norm(p["ln1"], x, eps),
                                 num_heads=num_heads, causal=causal,
                                 key_bias=key_bias, lora_scaling=lora_scaling)
    # ln2 -> fc1 through the fused kernel only where the switch is on and the
    # JAX package's shape rule admits it (the temporal MLP stays unfused)
    if _lnl.FUSE_LN2_FC1 and _lnl.ln_linear_available(h, p["mlp"]["fc1"]):
        wide = _lnl.ln_linear(h, p["ln2"], p["mlp"]["fc1"], eps)
    else:
        wide = linear(p["mlp"]["fc1"], layer_norm(p["ln2"], h, eps))
    return h + linear(p["mlp"]["fc2"], act(wide))


def _block_forward(p, x, *, remat=False, **kwargs):
    """One pre-LN transformer block; with `time` = (T, N), x is
    [(B*T), N, D] and the temporal half runs first.

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
    """pixel_values: [B, C, H, W] or [B, C, T, H, W] -> pooled [B, D] (CLS ->
    post-LN per frame -> mean over frames -> projection). `train` changes
    nothing here but patch dropout, which is not ported: a train-mode call
    with force_patch_dropout > 0 raises. The JAX package runs large batches
    in chunks of whole videos (`chunk_instances`), which does not change the
    result; the port runs one chunk."""
    _check_vision_config(cfg)
    if pixel_values.dim() == 5:
        B, C, T, H, W = pixel_values.shape
        # frames b-major, t-minor: the [(B*T), N, D] stream of the blocks
        frames = pixel_values.transpose(1, 2).reshape(B * T, C, H, W)
    elif pixel_values.dim() == 4:
        B, C, H, W = pixel_values.shape
        T, frames = 1, pixel_values
    else:
        raise NotImplementedError(
            f"4-D image and 5-D video input are ported; got "
            f"{pixel_values.dim()}-D")
    if train and cfg.force_patch_dropout > 0.0:
        raise NotImplementedError("patch dropout is not ported yet")
    d = cfg.hidden_size
    p_sz = cfg.patch_size
    # strided conv per frame; the weight is stored (C*p*p, D) in (c, i, j)
    # order
    w = params["patch_embedding"]["w"].reshape(C, p_sz, p_sz, d)
    emb = F.conv2d(frames, w.permute(3, 0, 1, 2).to(frames.dtype),
                   stride=p_sz)                       # [B*T, d, gh, gw]
    emb = emb.flatten(2).transpose(1, 2)              # [B*T, gh*gw, d]
    cls = params["class_embedding"].expand(B * T, 1, d)
    x = torch.cat([cls, emb], dim=1) + params["position_embedding"][None]
    x = layer_norm(params["pre_ln"], x, cfg.layer_norm_eps)

    lora_scaling = (cfg.lora_alpha / cfg.lora_r) if cfg.lora_r else None
    time = (T, x.shape[1]) if cfg.add_time_attn else None
    x = _encoder(params["blocks"], x, num_heads=cfg.num_heads,
                 act=get_activation(cfg.hidden_act), eps=cfg.layer_norm_eps,
                 time=time, lora_scaling=lora_scaling, remat=remat)
    pooled = layer_norm(params["post_ln"], x[:, 0, :], cfg.layer_norm_eps)
    pooled = pooled.reshape(B, T, -1).mean(dim=1)
    if projection is not None:
        pooled = linear(projection, pooled)
    return pooled


def tower_forward(params, cfg: TowerConfig, input_ids, pixel_values, *,
                  train=False, remat=False):
    """The contrastive dual-tower forward: (logits_per_image,
    logits_per_text, text_embeds, image_embeds) as in reference
    image/modeling_image.py:941-1030 (missm_tpu/models/tower.py::
    tower_forward). The JAX function's `rng` feeds patch dropout only,
    which is not ported (vision_features raises on it)."""
    _, text_pooled = text_features(params["text"], cfg.text, input_ids,
                                   remat=remat,
                                   projection=params["text_projection"])
    image_pooled = vision_features(params["vision"], cfg.vision, pixel_values,
                                   train=train, remat=remat,
                                   projection=params["visual_projection"])
    te = l2_normalize(text_pooled)
    ie = l2_normalize(image_pooled)
    logits_per_text = te @ ie.T * torch.exp(params["logit_scale"])
    return logits_per_text.T, logits_per_text, te, ie
