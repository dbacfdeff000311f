"""The CLIP dual tower (text + vision), after missm_tpu/models/tower.py.

Plain functions over parameter dicts, laid out as in the JAX package (linear
weights (in, out)), except that the transformer blocks are a list of
per-layer dicts walked by a Python loop where JAX stacks them [L, ...] for
`lax.scan`. Ported: the text tower, and the vision tower on 4-D image input,
5-D video input [B, C, T, H, W] and the 7-D retrieval-pair layout, with the
temporal blocks (temporal embedding, temporal attention, optional temporal
MLP), the tube-3D embedding with per-tube CLS tokens and patch dropout,
forward and backward, with full per-block remat or one of the JAX package's
named remat policies (`REMAT_POLICIES`), and the contrastive dual-tower
forward. `inject_lora` adds fresh LoRA to converted checkpoint blocks
(compat/convert.py). With
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
from ..ops.basic import (get_activation, keep_contexts, l2_normalize,
                         layer_norm, linear)

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


def init_vision_params(gen: torch.Generator, cfg: VisionConfig):
    """With `use_tube3d` the patch embedding spans tube_size frames and
    each tube has its own CLS token (class_embedding [T / tube, d])."""
    d = cfg.hidden_size
    patch_in = cfg.num_channels * cfg.patch_size ** 2
    cls_shape = (d,)
    if cfg.use_tube3d:
        patch_in *= cfg.tube_size
        cls_shape = (cfg.num_frames // cfg.tube_size, d)
    return {
        "class_embedding": _normal(gen, cls_shape, d ** -0.5),
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
        wide = linear(p["tmlp"]["fc1"], layer_norm(p["tln2"], x, eps),
                      lora_scaling=lora_scaling, name="mlp_wide")
        x = x + linear(p["tmlp"]["fc2"], act(wide, name="mlp_wide_act"),
                       lora_scaling=lora_scaling)
    return x


def _block(p, x, *, num_heads, act, eps, causal=False, key_bias=None,
           time=None, lora_scaling=None):
    if time is not None:
        x = _temporal(p, x, time=time, num_heads=num_heads, act=act, eps=eps,
                      lora_scaling=lora_scaling)
        lora_scaling = None  # the spatial attention has no LoRA here
    h = x + multi_head_attention(p["attn"], layer_norm(p["ln1"], x, eps),
                                 num_heads=num_heads, causal=causal,
                                 key_bias=key_bias, lora_scaling=lora_scaling,
                                 out_name="attn_out")
    # ln2 -> fc1 through the fused kernel only where the switch is on and the
    # JAX package's shape rule admits it (the temporal MLP stays unfused)
    if _lnl.FUSE_LN2_FC1 and _lnl.ln_linear_available(h, p["mlp"]["fc1"]):
        wide = _lnl.ln_linear(h, p["ln2"], p["mlp"]["fc1"], eps,
                              name="mlp_wide")
    else:
        wide = linear(p["mlp"]["fc1"], layer_norm(p["ln2"], h, eps),
                      name="mlp_wide")
    return h + linear(p["mlp"]["fc2"], act(wide, name="mlp_wide_act"))


# The values each named policy keeps, after missm_tpu/models/tower.py:318-402
# (the names are set in ops/attention.py, ops/basic.py and _block above);
# save_most keeps everything but its two, the MLP-wide values.
REMAT_POLICIES = {
    "save_attn": ("attn_out",),
    "save_attn_mlp": ("attn_out", "mlp_wide"),
    "save_attn_mlp_kern": ("attn_out", "mlp_wide", "attn_kernel_out",
                           "tattn_kernel_out"),
    "save_attn_mlp_qkv": ("attn_out", "mlp_wide", "qkv"),
    "save_attn_mlp_qkv_kern": ("attn_out", "mlp_wide", "qkv",
                               "attn_kernel_out", "tattn_kernel_out"),
    "save_attn_mlp_qkv_sig": ("attn_out", "mlp_wide", "qkv", "act_sig"),
    "save_attn_mlp_qkv_tkern": ("attn_out", "mlp_wide", "qkv",
                                "tattn_kernel_out"),
    "save_attn_mlp_tqkv": ("attn_out", "mlp_wide", "tqkv"),
    "save_most": ("mlp_wide", "mlp_wide_act"),
}


def _block_forward(p, x, *, remat=False, **kwargs):
    """One pre-LN transformer block; with `time` = (T, N), x is
    [(B*T), N, D] and the temporal half runs first.

    remat=True recomputes the block in the backward and keeps only its
    input (missm_tpu/models/tower.py's jax.checkpoint with policy=None). A
    policy name keeps the block's input and the values the policy names
    (ops/basic.py::keep_contexts: the outputs of the ops in those `named`
    regions, the custom kernel ops among them, so a kept attention output
    keeps its log-sum-exp and the backward kernel runs without the forward
    one again); the backward's recompute runs the rest. Without grad mode
    there is nothing to keep, and the block just runs."""
    if not isinstance(remat, bool) and remat not in REMAT_POLICIES:
        # an unknown name must not measure full remat in silence
        raise ValueError(f"unknown remat policy {remat!r}; expected True, "
                         f"False or one of {sorted(REMAT_POLICIES)}")
    if remat is False or not torch.is_grad_enabled():
        return _block(p, x, **kwargs)
    fn = functools.partial(_block, p, **kwargs)
    if remat is True:
        return checkpoint(fn, x, use_reentrant=False)
    contexts = functools.partial(keep_contexts, REMAT_POLICIES[remat],
                                 remat == "save_most")
    return checkpoint(fn, x, use_reentrant=False, context_fn=contexts)


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


def patch_keep_indices(generator: torch.Generator, videos: int,
                       tokens: int, prob: float):
    """Which patch tokens patch dropout keeps, one draw a video: [videos,
    keep] indices into the `tokens` patch tokens (CLS excluded), keep =
    max(1, int(tokens * (1 - prob))), the top `keep` of a normal draw from
    `generator` (missm_tpu/models/tower.py::_patch_dropout draws its normals
    from fold_in(key, video); the two streams differ)."""
    keep = max(1, int(tokens * (1.0 - prob)))
    rand = torch.randn(videos, tokens, generator=generator,
                       device=generator.device)
    return torch.topk(rand, keep, dim=1).indices


def _patch_dropout(x, T, keep_idx):
    """Keep the CLS token and the patch tokens keep_idx [B, keep] names,
    one mask a video shared by its T frames (or tubes), x [(B*T), N, d]
    (reference image/modeling_image.py:19-63)."""
    keep_idx = keep_idx.to(x.device).long()
    if T != 1:
        keep_idx = keep_idx.repeat_interleave(T, dim=0)  # [(B*T), keep]
    toks = torch.gather(x[:, 1:], 1, keep_idx[:, :, None].expand(
        -1, -1, x.shape[-1]))
    return torch.cat([x[:, :1], toks], dim=1)


def _video(pixel_values):
    """(B, T, video [B, C, T, H, W]) of 4-D image, 5-D video or the 7-D
    retrieval-pair layout (b, pair, T, bs, C, H, W), which flattens to
    B = b * pair * bs videos (missm_tpu/models/tower.py:576-588)."""
    if pixel_values.dim() == 7:
        b, pair, T, bs, C, H, W = pixel_values.shape
        frames = pixel_values.permute(0, 1, 3, 2, 4, 5, 6).reshape(
            b * pair * bs, T, C, H, W)
        return b * pair * bs, T, frames.transpose(1, 2)
    if pixel_values.dim() == 5:
        return pixel_values.shape[0], pixel_values.shape[2], pixel_values
    if pixel_values.dim() == 4:
        return pixel_values.shape[0], 1, pixel_values[:, :, None]
    raise ValueError(f"vision input must be 4-D image, 5-D video or 7-D "
                     f"retrieval pairs; got {pixel_values.dim()}-D")


def _embed(params, cfg: VisionConfig, video, B, T):
    """Patch embedding, CLS and position embedding: x [(B*T'), N, d] and
    the instances per video T' (T / tube_size for the tube-3D embedding,
    whose CLS is one a tube; missm_tpu/models/tower.py:596-634)."""
    C = video.shape[1]
    d, p_sz = cfg.hidden_size, cfg.patch_size
    if cfg.use_tube3d:
        # one strided conv over (tube, p, p); the weight is stored
        # (C*tube*p*p, D) in (c, t, i, j) order
        tube = cfg.tube_size
        w = params["patch_embedding"]["w"].reshape(C, tube, p_sz, p_sz, d)
        emb = F.conv3d(video, w.permute(4, 0, 1, 2, 3).to(video.dtype),
                       stride=(tube, p_sz, p_sz))     # [B, d, T', gh, gw]
        T = emb.shape[2]
        emb = emb.flatten(3).permute(0, 2, 3, 1)      # [B, T', gh*gw, d]
        cls = params["class_embedding"][None, :, None, :].expand(B, T, 1, d)
        x = (torch.cat([cls, emb], dim=2)
             + params["position_embedding"][None, None])
        return x.reshape(B * T, -1, d), T
    # frames b-major, t-minor: the [(B*T), N, D] stream of the blocks; a
    # strided conv per frame, the weight stored (C*p*p, D) in (c, i, j) order
    frames = video.transpose(1, 2).reshape(B * T, C, *video.shape[3:])
    w = params["patch_embedding"]["w"].reshape(C, p_sz, p_sz, d)
    emb = F.conv2d(frames, w.permute(3, 0, 1, 2).to(frames.dtype),
                   stride=p_sz)                       # [B*T, d, gh, gw]
    emb = emb.flatten(2).transpose(1, 2)              # [B*T, gh*gw, d]
    cls = params["class_embedding"].expand(B * T, 1, d)
    return torch.cat([cls, emb], dim=1) + params["position_embedding"][None], T


def vision_features(params, cfg: VisionConfig, pixel_values, *, train=False,
                    remat=False, projection=None,
                    generator: torch.Generator | None = None,
                    keep_indices=None):
    """pixel_values: [B, C, H, W], [B, C, T, H, W] or the 7-D
    retrieval-pair layout -> pooled [B, D] (CLS -> post-LN per frame or
    tube -> mean over them -> projection).

    In train mode with force_patch_dropout > 0, patch dropout keeps the
    patch tokens `keep_indices` [B, keep] names, or draws them from
    `generator` (patch_keep_indices) when none are given; without either it
    raises. The JAX package runs large batches in chunks of whole videos
    (`chunk_instances`), which does not change the result; the port runs
    one chunk."""
    B, T, video = _video(pixel_values)
    x, T = _embed(params, cfg, video, B, T)
    if train and cfg.force_patch_dropout > 0.0:
        if keep_indices is None:
            if generator is None:
                raise ValueError("patch dropout needs a torch.Generator (or "
                                 "keep_indices) in training mode")
            keep_indices = patch_keep_indices(generator, B, x.shape[1] - 1,
                                              cfg.force_patch_dropout)
        x = _patch_dropout(x, T, keep_indices)
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
                  train=False, remat=False,
                  generator: torch.Generator | None = None):
    """The contrastive dual-tower forward: (logits_per_image,
    logits_per_text, text_embeds, image_embeds) as in reference
    image/modeling_image.py:941-1030 (missm_tpu/models/tower.py::
    tower_forward). `generator` feeds patch dropout, as the JAX function's
    `rng` does."""
    _, text_pooled = text_features(params["text"], cfg.text, input_ids,
                                   remat=remat,
                                   projection=params["text_projection"])
    image_pooled = vision_features(params["vision"], cfg.vision, pixel_values,
                                   train=train, remat=remat,
                                   projection=params["visual_projection"],
                                   generator=generator)
    te = l2_normalize(text_pooled)
    ie = l2_normalize(image_pooled)
    logits_per_text = te @ ie.T * torch.exp(params["logit_scale"])
    return logits_per_text.T, logits_per_text, te, ie
