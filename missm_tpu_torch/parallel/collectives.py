"""The collectives of the parallel layouts, written out.

The JAX package runs one program over n devices and lets GSPMD insert every
collective: the gradient all-reduce of DP, FSDP's gathers and
reduce-scatters, Megatron TP's all-reduces, the pipeline's ppermutes. Here
one process drives one device, and each of those is a call on a
`torch.distributed` group:

- `copy_to_model` / `reduce_from_model` (`RowReduce`): Megatron's pair over
  the model group, identity forward and all-reduce backward, and the
  reverse;
- `gather_shard`: FSDP's all-gather before use, whose backward
  reduce-scatters the gradient over the data group;
- `all_gather`, `reduce_scatter`, `all_reduce`, `broadcast`, `send`,
  `recv`: plain functions for the FSDP gather and gradient reduction, the
  DP gradient all-reduce and the pipeline's activations.

Gloo takes CUDA tensors for all_reduce and broadcast (`GLOO_CUDA_OPS`,
PyTorch's backend table); for its other ops a CUDA tensor is staged
through the host. (On the card, torch 2.11's gloo also took all_gather and
reduce_scatter_tensor, and failed send/recv of a CUDA tensor.) The choice
is made by the group's backend name, never by catching an error. NCCL
takes every op on the card, one rank a device.

Each call runs with the dispatch modes off: a block kept under a named remat
policy (ops/basic.py::_Keeper) must run its collectives again in the
recompute, as every rank of the group does, and never replay a kept one.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

# the ops gloo runs on CUDA tensors itself (PyTorch's backend table)
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})


class ModelAxis(NamedTuple):
    """The model (tensor-parallel) axis as the blocks see it: its group and
    its size."""
    group: object
    size: int


def _staged(op: str, t: torch.Tensor, group) -> bool:
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def _global(group, rank: int) -> int:
    return dist.get_global_rank(group, rank)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """A new tensor: the reduction of `t` over `group` (`t` is not
    changed)."""
    with _disable_current_modes():
        if _staged("all_reduce", t, group):
            buf = t.detach().cpu().clone()
            dist.all_reduce(buf, op=op, group=group)
            return buf.to(t.device)
        buf = t.detach().clone()
        dist.all_reduce(buf, op=op, group=group)
        return buf


def all_gather(t: torch.Tensor, dim: int, group):
    """The shards of every rank of `group`, concatenated along `dim` in rank
    order."""
    n = dist.get_world_size(group)
    with _disable_current_modes():
        if _staged("all_gather", t, group):
            src = t.detach().cpu().contiguous()
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
            return torch.cat(parts, dim).to(t.device)
        src = t.detach().contiguous()
        if dist.get_backend(group) == "nccl":
            moved = src.movedim(dim, 0).contiguous()
            out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
            dist.all_gather_into_tensor(out, moved, group=group)
            return out.movedim(0, dim).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group):
    """This rank's shard along `dim` of the sum of `t` over `group`. NCCL
    reduce-scatters; gloo has no reduce-scatter, so it all-reduces and keeps
    the shard (the same sum, twice the bytes)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    with _disable_current_modes():
        if dist.get_backend(group) == "nccl":
            moved = t.detach().movedim(dim, 0).contiguous()
            out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
            dist.reduce_scatter_tensor(out, moved, group=group)
            return out.movedim(0, dim).contiguous()
    full = all_reduce(t, group)
    return full.chunk(n, dim)[r].contiguous()


def broadcast(t: torch.Tensor, src: int, group):
    """`t` of the rank `src` of `group` (a group rank), on every rank; `t`
    gives the shape and dtype elsewhere."""
    with _disable_current_modes():
        buf = t.detach().clone() if dist.get_rank(group) == src else \
            torch.empty_like(t)
        if _staged("broadcast", buf, group):
            host = buf.cpu()
            dist.broadcast(host, src=_global(group, src), group=group)
            return host.to(t.device)
        dist.broadcast(buf, src=_global(group, src), group=group)
        return buf


def send(t: torch.Tensor, dst: int, group):
    """Send `t` to the rank `dst` of `group`; blocks until it is sent."""
    with _disable_current_modes():
        src = t.detach().contiguous()
        if _staged("send", src, group):
            src = src.cpu()
        dist.send(src, dst=_global(group, dst), group=group)


def recv(shape, dtype, device, src: int, group):
    """A tensor of `shape` and `dtype` on `device`, received from the rank
    `src` of `group`."""
    with _disable_current_modes():
        on_host = (torch.device(device).type == "cuda"
                   and dist.get_backend(group) == "gloo")
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if on_host else device)
        dist.recv(buf, src=_global(group, src), group=group)
        return buf.to(device)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the gradient over
    the model group (each rank holds the part of it that its columns
    give)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.float(), ctx.group).to(g.dtype), None


class RowReduce(torch.autograd.Function):
    """Megatron's g with the row-parallel bias: the forward sums the
    partial products over the model group in f32, adds the (replicated)
    bias and rounds once to x's type, as the unsharded product rounds once;
    the backward passes the gradient through and sums the bias's over the
    rows."""

    @staticmethod
    def forward(ctx, x, bias, group):
        ctx.has_bias = bias is not None
        ctx.bias_dtype = None if bias is None else bias.dtype
        y = all_reduce(x.float(), group)
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        db = None
        if ctx.has_bias and ctx.needs_input_grad[1]:
            db = g.reshape(-1, g.shape[-1]).float().sum(0).to(ctx.bias_dtype)
        return g, db, None


class _GatherShard(torch.autograd.Function):
    """FSDP's gather before use: the forward all-gathers a leaf's shards
    over the data group, the backward reduce-scatters its gradient (summed
    in f32) back to the shard."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(shard, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.float(), ctx.dim, ctx.group).to(g.dtype),
                None, None)


def gather_shard(shard, dim: int, group):
    """The full leaf of FSDP shards along `dim` over `group`, with the
    reduce-scatter of its gradient."""
    return _GatherShard.apply(shard, dim, group)


def model_rank(axis) -> int:
    """This rank's coordinate on the model axis `axis`."""
    return dist.get_rank(axis.group)


def copy_to_model(x, axis):
    """x entering the column-parallel products of the model axis `axis`
    (a ModelAxis)."""
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x, bias, axis):
    """The row-parallel partial products `x` summed over `axis`, plus
    `bias`."""
    return RowReduce.apply(x, bias, axis.group)
