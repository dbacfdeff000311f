"""The fusion / imputation heads, after missm_tpu/models/fusion.py: every
head is `init_*(generator, cfg) -> params` plus the shared
`fusion_forward(params, cfg, embeds, missing_index, ...) -> (logits, aux)`.

Missing-modality masks are post-encoder selects on the per-sample scalar
`missing_index` (0 = complete, else MODALITY_CODES): each head computes
every branch and selects by mask, with no data-dependent control flow.
Fusion params are f32. The heads' attention (inter_attention over at most
5 modality tokens, the dense SuperGAT of the graph heads) is plain matmuls,
as the JAX package computes it with einsums. Preserved quirk: in the graph
heads a missing node still reaches the node mean through its self-loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

from ..core.config import MODALITY_CODES
from ..ops.basic import dropout, layer_norm, linear
from ..ops.graph import (fusion_gcn_forward, full_adjacency, init_fusion_gcn,
                         modality_adjacency)

DISTILL_TYPES = ("Distill_tea", "MTD_stu", "KL_stu")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    fusion_type: str
    modality_types: Tuple[str, ...]
    output_dims: int
    feature_dims: int = 768
    fusion_dim: int = 256
    dropout_prob: float = 0.1

    @property
    def num_modalities(self) -> int:
        return len(self.modality_types)


# -- init helpers (torch nn.Linear default init: U(+-1/sqrt(fan_in))) --------

def _torch_linear(gen, d_in, d_out):
    bound = 1.0 / math.sqrt(d_in)
    return {
        "w": torch.empty(d_in, d_out, device=gen.device).uniform_(
            -bound, bound, generator=gen),
        "b": torch.empty(d_out, device=gen.device).uniform_(
            -bound, bound, generator=gen),
    }


def _ln(d, device):
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _init_head(gen, cfg: FusionConfig, in_dim: int):
    """The shared classifier head: Linear -> ReLU -> Dropout -> Linear."""
    return {"fc1": _torch_linear(gen, in_dim, cfg.fusion_dim),
            "fc2": _torch_linear(gen, cfg.fusion_dim, cfg.output_dims)}


def _apply_head(p, cfg, x, train, generator):
    h = torch.relu(linear(p["fc1"], x))
    h = dropout(h, cfg.dropout_prob, deterministic=not train,
                generator=generator)
    return linear(p["fc2"], h)


def _init_projs(gen, cfg: FusionConfig):
    return {m: _torch_linear(gen, cfg.feature_dims, cfg.fusion_dim)
            for m in cfg.modality_types}


def _concat_head(gen, cfg: FusionConfig):
    """The norm and head over the M projected features concatenated."""
    width = cfg.fusion_dim * cfg.num_modalities
    return {"norm": _ln(width, gen.device),
            "head": _init_head(gen, cfg, width)}


# -- mask helpers ------------------------------------------------------------

def missing_masks(cfg: FusionConfig, missing_index) -> Dict[str, torch.Tensor]:
    """{modality: [B] bool, True where that modality is MISSING}. Modalities
    without a missing code (depth, thermal) are always present."""
    return {m: missing_index == MODALITY_CODES.get(m, -1)
            for m in cfg.modality_types}


def present_matrix(cfg: FusionConfig, missing_index) -> torch.Tensor:
    """[B, M] bool, True where present, columns in modality_types order."""
    return torch.stack([missing_index != MODALITY_CODES.get(m, -1)
                        for m in cfg.modality_types], dim=1)


def _zero_missing(x, miss):
    return torch.where(miss[:, None], 0.0, x)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def init_sum(gen, cfg):
    return {"proj": _init_projs(gen, cfg),
            "norm": _ln(cfg.fusion_dim, gen.device),
            "head": _init_head(gen, cfg, cfg.fusion_dim)}


def _fwd_sum(p, cfg, embeds, missing_index, train, generator):
    miss = missing_masks(cfg, missing_index)
    total = 0.0
    for m in cfg.modality_types:
        total = total + _zero_missing(linear(p["proj"][m], embeds[m]), miss[m])
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], total), train,
                       generator), {}


def init_concat(gen, cfg):
    # imputation statistics, zeros (concat_zero) until set_statistics fills
    # them with the train set's mean or median
    return {"proj": _init_projs(gen, cfg), **_concat_head(gen, cfg),
            "statistics": {m: torch.zeros(cfg.feature_dims, device=gen.device)
                           for m in cfg.modality_types}}


def set_statistics(params, statistics: Mapping):
    """The concat head's params with `statistics` ({modality: [feature_dims]}
    arrays or tensors) in place of its imputation statistics, each on the
    device and in the type of the leaf it replaces."""
    new = dict(params)
    new["statistics"] = {
        m: torch.as_tensor(v, dtype=params["statistics"][m].dtype,
                           device=params["statistics"][m].device)
        for m, v in statistics.items()}
    return new


def _fwd_concat(p, cfg, embeds, missing_index, train, generator):
    miss = missing_masks(cfg, missing_index)
    parts = [linear(p["proj"][m], torch.where(
        miss[m][:, None], p["statistics"][m][None, :], embeds[m]))
        for m in cfg.modality_types]
    cat = torch.cat(parts, dim=-1)
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], cat), train,
                       generator), {}


def init_regression(gen, cfg):
    return {"proj": _init_projs(gen, cfg), **_concat_head(gen, cfg),
            "regressors": {f"{s}_to_{t}": _torch_linear(gen, cfg.feature_dims,
                                                        cfg.fusion_dim)
                           for s in cfg.modality_types
                           for t in cfg.modality_types if s != t}}


def _fwd_regression(p, cfg, embeds, missing_index, train, generator):
    """A missing modality's projected feature is the presence-weighted mean
    of the other modalities' regressed predictions."""
    miss = missing_masks(cfg, missing_index)
    projected = {m: linear(p["proj"][m], embeds[m])
                 for m in cfg.modality_types}
    for target in cfg.modality_types:
        sources = [s for s in cfg.modality_types if s != target]
        preds = torch.stack([linear(p["regressors"][f"{s}_to_{target}"],
                                    embeds[s]) for s in sources], dim=1)
        w = torch.stack([(~miss[s]).float() for s in sources],
                        dim=1)[:, :, None]                       # [B, S, 1]
        avg = (preds * w).sum(1) / torch.clamp(w.sum(1), min=1e-6)
        projected[target] = torch.where(miss[target][:, None], avg,
                                        projected[target])
    cat = torch.cat([projected[m] for m in cfg.modality_types], dim=-1)
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], cat), train,
                       generator), {}


def init_retrieval(gen, cfg):
    """The retrieval substitution happens in the data layer (a complete
    sample of the same label); the head is a plain concat."""
    return {"proj": _init_projs(gen, cfg), **_concat_head(gen, cfg)}


def _fwd_retrieval(p, cfg, embeds, missing_index, train, generator):
    cat = torch.cat([linear(p["proj"][m], embeds[m])
                     for m in cfg.modality_types], dim=-1)
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], cat), train,
                       generator), {}


def init_intra_attention(gen, cfg):
    d = cfg.fusion_dim
    return {"proj": _init_projs(gen, cfg), "norm": _ln(d, gen.device),
            "head": _init_head(gen, cfg, d),
            "fusion_representation": _normal(gen, (1, d)),
            "gate_fc1": _torch_linear(gen, d * 2, d // 4),
            "gate_fc2": _torch_linear(gen, d // 4, d)}


def _fwd_intra_attention(p, cfg, embeds, missing_index, train, generator):
    """SE-style sigmoid channel gating against a learned fusion token."""
    miss = missing_masks(cfg, missing_index)
    total = 0.0
    for m in cfg.modality_types:
        data = linear(p["proj"][m], embeds[m])
        fused = p["fusion_representation"].expand(data.shape[0], -1)
        gate = torch.sigmoid(linear(p["gate_fc2"], torch.relu(
            linear(p["gate_fc1"], torch.cat([data, fused], dim=-1)))))
        total = total + _zero_missing(data * gate, miss[m])
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], total), train,
                       generator), {}


# nn.MultiheadAttention(fusion_dim, 4) in the reference: a constant, not a
# params leaf
INTER_ATTN_HEADS = 4


def init_inter_attention(gen, cfg):
    d = cfg.fusion_dim
    # nn.MultiheadAttention's xavier_uniform over the packed (3d, d)
    # in-projection: limit sqrt(6 / (3d + d)) for each of q, k and v; the
    # out-projection has torch's linear default and a zero bias
    limit = math.sqrt(6.0 / (3 * d + d))

    def xavier():
        return {"w": torch.empty(d, d, device=gen.device).uniform_(
                    -limit, limit, generator=gen),
                "b": torch.zeros(d, device=gen.device)}

    p = {"proj": _init_projs(gen, cfg), "norm": _ln(d, gen.device),
         "head": _init_head(gen, cfg, d),
         "query_token": _normal(gen, (1, 1, d)),
         "attn": {"q": xavier(), "k": xavier(), "v": xavier()}}
    p["attn"]["out"] = dict(_torch_linear(gen, d, d),
                            b=torch.zeros(d, device=gen.device))
    return p


def _fwd_inter_attention(p, cfg, embeds, missing_index, train, generator):
    """Modalities as tokens; one learned query attends over them with the
    missing mask as key padding (4 heads)."""
    present = present_matrix(cfg, missing_index)                  # [B, M]
    tokens = torch.stack([linear(p["proj"][m], embeds[m])
                          for m in cfg.modality_types], dim=1)    # [B, M, D]
    B, M, D = tokens.shape
    H = INTER_ATTN_HEADS
    hd = D // H
    q = linear(p["attn"]["q"], p["query_token"].expand(B, 1, D))
    k = linear(p["attn"]["k"], tokens)
    v = linear(p["attn"]["v"], tokens)
    q = q.reshape(B, 1, H, hd).transpose(1, 2) * (hd ** -0.5)
    k = k.reshape(B, M, H, hd).transpose(1, 2)
    v = v.reshape(B, M, H, hd).transpose(1, 2)
    logits = q @ k.transpose(-1, -2)                          # [B, H, 1, M]
    logits = torch.where(present[:, None, None, :], logits,
                         torch.finfo(logits.dtype).min)
    out = torch.softmax(logits, dim=-1) @ v                  # [B, H, 1, hd]
    out = linear(p["attn"]["out"], out.transpose(1, 2).reshape(B, D))
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], out), train,
                       generator), {}


def init_graph_fusion(gen, cfg):
    return {"proj": _init_projs(gen, cfg),
            "norm": _ln(cfg.fusion_dim, gen.device),
            "head": _init_head(gen, cfg, cfg.fusion_dim),
            "gcn": init_fusion_gcn(gen, in_dim=cfg.fusion_dim, hidden=128,
                                   out_dim=cfg.fusion_dim, heads=4)}


def _fwd_graph_fusion(p, cfg, embeds, missing_index, train, generator):
    present = present_matrix(cfg, missing_index)
    nodes = torch.stack([linear(p["proj"][m], embeds[m])
                         for m in cfg.modality_types], dim=1)
    out = fusion_gcn_forward(p["gcn"], nodes, modality_adjacency(present))
    pooled = out.mean(dim=1)  # over ALL nodes, missing ones included
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], pooled), train,
                       generator), {}


def init_unified_graph(gen, cfg):
    # stage 1 reconstructs feature_dims-wide features; stage 2 fuses
    return {"norm": _ln(cfg.fusion_dim, gen.device),
            "head": _init_head(gen, cfg, cfg.fusion_dim),
            "complete_gcn": init_fusion_gcn(
                gen, in_dim=cfg.feature_dims, hidden=cfg.feature_dims // 2,
                out_dim=cfg.feature_dims, heads=4),
            "fusion_gcn": init_fusion_gcn(
                gen, in_dim=cfg.feature_dims, hidden=128,
                out_dim=cfg.fusion_dim, heads=4)}


def _fwd_unified_graph(p, cfg, embeds, missing_index, train, generator):
    """A stage-1 GCN over the present modalities reconstructs each missing
    node's feature; a stage-2 GCN over the full graph fuses."""
    present = present_matrix(cfg, missing_index)
    feats = torch.stack([embeds[m] for m in cfg.modality_types], dim=1)
    recon = fusion_gcn_forward(p["complete_gcn"], feats,
                               modality_adjacency(present))
    filled = torch.where(present[:, :, None], feats, recon)
    B, M, _ = filled.shape
    out = fusion_gcn_forward(p["fusion_gcn"], filled,
                             full_adjacency(B, M, device=filled.device))
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], out.mean(dim=1)),
                       train, generator), {}


def init_dedicated_dnn(gen, cfg):
    M, C = cfg.num_modalities, cfg.feature_dims
    branches = {m: _torch_linear(gen, C * (M - 1), cfg.fusion_dim)
                for m in cfg.modality_types}
    branches["full"] = _torch_linear(gen, C * M, cfg.fusion_dim)
    return {"branches": branches, "norm": _ln(cfg.fusion_dim, gen.device),
            "head": _init_head(gen, cfg, cfg.fusion_dim)}


def _fwd_dedicated_dnn(p, cfg, embeds, missing_index, train, generator):
    """Per-sample routing to a leave-one-modality-out branch: every branch
    computed, the row's own selected by mask."""
    miss = missing_masks(cfg, missing_index)
    feats = torch.stack([embeds[m] for m in cfg.modality_types], dim=1)
    B, M, C = feats.shape
    out = linear(p["branches"]["full"], feats.reshape(B, M * C))
    for i, m in enumerate(cfg.modality_types):
        rest = torch.cat([feats[:, :i], feats[:, i + 1:]],
                         dim=1).reshape(B, (M - 1) * C)
        out = torch.where(miss[m][:, None], linear(p["branches"][m], rest),
                          out)
    return _apply_head(p["head"], cfg, layer_norm(p["norm"], out), train,
                       generator), {}


def init_distillation(gen, cfg):
    return {"mlp_fc1": _torch_linear(gen, cfg.feature_dims
                                     * cfg.num_modalities, cfg.fusion_dim),
            "mlp_fc2": _torch_linear(gen, cfg.fusion_dim, cfg.fusion_dim),
            "norm": _ln(cfg.fusion_dim, gen.device),
            "head": _init_head(gen, cfg, cfg.fusion_dim)}


def _shared_mlp(p, x):
    return linear(p["mlp_fc2"], torch.relu(linear(p["mlp_fc1"], x)))


def _fwd_distillation(p, cfg, embeds, missing_index, train, generator):
    """Teacher/student representation-distillation head: aux['features'] is
    the concat of the zero-masked raw embeddings, what the MSE / KL
    distillation losses compare."""
    miss = missing_masks(cfg, missing_index)
    feats = torch.cat([_zero_missing(embeds[m], miss[m])
                       for m in cfg.modality_types], dim=-1)
    logits = _apply_head(p["head"], cfg,
                         layer_norm(p["norm"], _shared_mlp(p, feats)), train,
                         generator)
    return logits, {"features": feats}


init_self_distill = init_distillation


def _fwd_self_distill(p, cfg, embeds, missing_index, train, generator):
    """Self-distillation. Train mode returns in aux one student view per
    modality (that modality alone in its concat slot, zeros elsewhere), the
    full-concat teacher features and the presence mask; the train step
    applies the 0.01-weighted KL."""
    miss = missing_masks(cfg, missing_index)
    masked = [_zero_missing(embeds[m], miss[m]) for m in cfg.modality_types]
    tea = _shared_mlp(p, torch.cat(masked, dim=-1))
    logits = _apply_head(p["head"], cfg, layer_norm(p["norm"], tea), train,
                         generator)
    if not train:
        return logits, {}
    M = cfg.num_modalities
    stu = []
    for i, x in enumerate(masked):
        slot = torch.cat([x.new_zeros(x.shape[0], i * x.shape[1]), x,
                          x.new_zeros(x.shape[0], (M - 1 - i) * x.shape[1])],
                         dim=-1)
        stu.append(_shared_mlp(p, slot))
    return logits, {"present_masks": present_matrix(cfg, missing_index),
                    "stu_features": torch.stack(stu, dim=1),
                    "tea_features": tea}


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_INIT = {
    "sum": init_sum,
    "concat": init_concat,
    "regression": init_regression,
    "retrieval": init_retrieval,
    "intra_attention": init_intra_attention,
    "inter_attention": init_inter_attention,
    "graph_fusion": init_graph_fusion,
    "unified_graph": init_unified_graph,
    "dedicated_dnn": init_dedicated_dnn,
    "Distill_tea": init_distillation,
    "MTD_stu": init_distillation,
    "KL_stu": init_distillation,
    "self_distill": init_self_distill,
}

_FWD = {
    "sum": _fwd_sum,
    "concat": _fwd_concat,
    "regression": _fwd_regression,
    "retrieval": _fwd_retrieval,
    "intra_attention": _fwd_intra_attention,
    "inter_attention": _fwd_inter_attention,
    "graph_fusion": _fwd_graph_fusion,
    "unified_graph": _fwd_unified_graph,
    "dedicated_dnn": _fwd_dedicated_dnn,
    "Distill_tea": _fwd_distillation,
    "MTD_stu": _fwd_distillation,
    "KL_stu": _fwd_distillation,
    "self_distill": _fwd_self_distill,
}

FUSION_TYPES = tuple(_INIT)


def init_fusion(gen: torch.Generator, cfg: FusionConfig):
    """Seeded f32 params of cfg's head on the generator's device."""
    return _INIT[cfg.fusion_type](gen, cfg)


def fusion_forward(params, cfg: FusionConfig,
                   embeds: Mapping[str, torch.Tensor], missing_index, *,
                   train: bool = False, generator: torch.Generator | None = None):
    """embeds: {modality: [B, feature_dims]} f32; missing_index: [B] int.
    Returns (logits [B, output_dims], aux dict)."""
    return _FWD[cfg.fusion_type](params, cfg, embeds, missing_index, train,
                                 generator)
