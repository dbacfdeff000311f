"""Dense SuperGAT over tiny per-sample modality graphs, after
missm_tpu/ops/graph.py.

The two graph fusion heads run SuperGAT over per-sample graphs of at most 5
nodes (one per modality; edges between present modality pairs). As in the
JAX package this is a masked dense attention over [B, M, M] in plain
PyTorch, the 'MX' attention of torch_geometric's default:
  h_j = x_j W                                  (per head)
  e_ij = (att_l . h_j + att_r . h_i) * sigmoid(h_i . h_j)
  a_ij = softmax_j( leaky_relu(e_ij, 0.2) )    over the masked neighborhood
  out_i = sum_j a_ij h_j  (+ bias)
Self-loops are always present, so a missing node still attends to itself.
Heads are concatenated when `concat=True`, averaged otherwise. SuperGAT's
self-supervised edge loss is not part of the forward and is not computed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(gen, shape, limit):
    return torch.empty(shape, device=gen.device).uniform_(-limit, limit,
                                                          generator=gen)


def init_supergat(gen: torch.Generator, in_dim: int, out_dim: int,
                  heads: int):
    """Glorot for W (PyG default), glorot for the att vectors (fan_in =
    heads, fan_out = out_dim, PyG's (1, heads, out) tensors); no bias."""
    limit_w = (6.0 / (in_dim + heads * out_dim)) ** 0.5
    limit_a = (6.0 / (heads + out_dim)) ** 0.5
    return {"w": _uniform(gen, (in_dim, heads * out_dim), limit_w),
            "att_l": _uniform(gen, (heads, out_dim), limit_a),
            "att_r": _uniform(gen, (heads, out_dim), limit_a)}


def init_supergat_layer(gen: torch.Generator, in_dim: int, out_dim: int,
                        heads: int, concat: bool):
    """init_supergat with a zero bias of the layer's output width."""
    p = init_supergat(gen, in_dim, out_dim, heads)
    p["bias"] = torch.zeros(heads * out_dim if concat else out_dim,
                            device=gen.device)
    return p


def supergat_dense(params, x, adj, *, heads: int, concat: bool,
                   negative_slope: float = 0.2):
    """x: [B, M, C_in]; adj: [B, M, M] bool (True = edge j->i, diagonal
    True). Returns [B, M, heads*C_out] (concat) or [B, M, C_out]."""
    B, M, _ = x.shape
    h = (x.float() @ params["w"].float()).reshape(B, M, heads, -1)

    # e[b, i, j, h]: (att_l . h_j + att_r . h_i) * sigmoid(h_i . h_j)
    al = torch.einsum("bjhc,hc->bjh", h, params["att_l"])
    ar = torch.einsum("bihc,hc->bih", h, params["att_r"])
    e_go = al[:, None, :, :] + ar[:, :, None, :]
    e_dp = torch.einsum("bihc,bjhc->bijh", h, h)
    e = F.leaky_relu(e_go * torch.sigmoid(e_dp), negative_slope)

    edge = adj[:, :, :, None]
    e = torch.where(edge, e, torch.finfo(e.dtype).min)
    a = torch.where(edge, torch.softmax(e, dim=2), 0.0)

    out = torch.einsum("bijh,bjhc->bihc", a, h)
    out = out.reshape(B, M, -1) if concat else out.mean(dim=2)
    return out + params["bias"]


def modality_adjacency(present, self_loops: bool = True):
    """present: [B, M] bool -> adjacency [B, M, M]: edges between distinct
    present pairs plus a self-loop on every node."""
    pair = present[:, :, None] & present[:, None, :]
    eye = torch.eye(present.shape[1], dtype=torch.bool,
                    device=present.device)[None]
    adj = pair & ~eye
    return adj | eye if self_loops else adj


def full_adjacency(batch: int, m: int, device=None):
    """All distinct pairs and self-loops (unified_graph's stage 2)."""
    return torch.ones(batch, m, m, dtype=torch.bool, device=device)


def init_fusion_gcn(gen: torch.Generator, in_dim=256, hidden=128,
                    out_dim=256, heads=4):
    """SuperGAT(in -> hidden, H heads, concat) -> GELU -> SuperGAT(hidden*H
    -> out, 1 head, no concat)."""
    return {"gat1": init_supergat_layer(gen, in_dim, hidden, heads, True),
            "gat2": init_supergat_layer(gen, hidden * heads, out_dim, 1,
                                        False)}


def fusion_gcn_forward(params, x, adj):
    heads = params["gat1"]["att_l"].shape[0]
    h = supergat_dense(params["gat1"], x, adj, heads=heads, concat=True)
    h = F.gelu(h, approximate="none")
    return supergat_dense(params["gat2"], h, adj, heads=1, concat=False)
