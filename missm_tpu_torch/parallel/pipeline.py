"""Pipeline parallelism over a tower's blocks, after
missm_tpu/parallel/pipeline.py: the GPipe schedule and the memory-capped
1F1B one.

Not in the reference (its only strategy is DDP, train_ddp.py:145,189). The
stages of the mesh's pipe axis own contiguous ranges of the blocks (and
their Adam state, built on them); microbatches of the activation stream
through the stages, each hop a send and a receive of the [mb, N, D]
activation between neighbour stages.

The JAX package runs one program over every stage (shard_map, ppermute,
ticks M + S - 1, microbatch t - r on stage r at tick t). Here each stage is
a process that runs the ticks of that schedule which are not bubbles
(`ticks`): it receives microbatch m from the stage before (stage 0 takes
it from x), runs its blocks and sends the result on. The sends and receives pair up in order,
and the hops only go one way in each pass, so no stage waits on one that
waits on it. The last stage's outputs go to every stage (a broadcast), so
pooling, the fusion head and the loss stay replicated over pipe, as the
JAX package's masked psum keeps them.

The backward is written out (`_Pipeline`), for both schedules: the
cotangent of microbatch m comes from the stage after (from the loss at the
last stage), the stage's blocks give theirs and x's, and x's goes back.
The gradient of x reaches every stage (stage 0's, broadcast), as JAX's
psum over pipe gives it, so the embeddings' gradients stay replicated; the
extras' cotangents (the text key bias, when it takes one) are summed over
the stages in f32.

- 'gpipe' keeps each microbatch's graph from the forward (JAX's autodiff
  through the schedule: live activations scale with M·L/S a stage);
- '1f1b' keeps only each stage's input microbatches and recomputes one
  microbatch at a time in the backward (JAX's memory-capped schedule, not
  a textbook interleaved 1F1B: the loss is downstream of the whole batch,
  so forward and backward ticks cannot interleave): one more forward of
  the stage's blocks a microbatch.

Every pipelined tower runs its own schedule in turn; their hops share the
pipe group as one ordered stream. The forward runs the towers in program
order and the autograd engine their backwards in the same order on every
stage, since every stage builds the same graph outside the schedule.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.mesh import PIPE_AXIS, axis_group, axis_index
from . import collectives as C

SCHEDULES = ("gpipe", "1f1b")


def ticks(n_pipe: int, m: int, stage: int, backward: bool = False):
    """[(tick, microbatch)] stage `stage` runs, in order, of the JAX
    package's M + S - 1 ticks: microbatch t - r on stage r at tick t in the
    forward, t - (S - 1 - r) in the backward (a bubble tick runs
    nothing)."""
    lag = n_pipe - 1 - stage if backward else stage
    return [(t, t - lag) for t in range(m + n_pipe - 1)
            if 0 <= t - lag < m]


@dataclasses.dataclass(frozen=True)
class PipeConfig:
    """The static pipeline spec (missm_tpu/parallel/pipeline.py::PipeConfig).
    microbatches = 0 means n_pipe (the fewest that keep every stage busy in
    steady state). schedule: 'gpipe' or '1f1b'."""
    mesh: object
    n_pipe: int
    microbatches: int = 0
    schedule: str = "gpipe"

    @property
    def m(self) -> int:
        return self.microbatches or self.n_pipe

    @property
    def stage(self) -> int:
        return axis_index(self.mesh, PIPE_AXIS)

    @property
    def group(self):
        return axis_group(self.mesh, PIPE_AXIS)


def _flatten(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _flatten(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, it) for v in tree]
    return next(it)


@dataclasses.dataclass(eq=False)
class _Run:
    pipe: PipeConfig
    block_fn: object
    blocks: object       # the structure of the stage's blocks
    n_extras: int

    def unflatten(self, leaves):
        return _unflatten(self.blocks, iter(leaves))


def _schedule(run: _Run, x, extras, blocks, keep_graph: bool):
    """The forward schedule on this stage: (y, stage inputs, outputs)."""
    pipe = run.pipe
    S, M, r, group = pipe.n_pipe, pipe.m, pipe.stage, pipe.group
    xs = x.chunk(M)
    with torch.set_grad_enabled(keep_graph):
        exs = [e.chunk(M) for e in extras]
    ins, outs = [], []
    for _, m in ticks(S, M, r):
        inp = xs[m] if r == 0 else C.recv(xs[0].shape, x.dtype, x.device,
                                          r - 1, group)
        ex = [e[m] for e in exs]
        if keep_graph:
            inp = inp.detach().requires_grad_()
            with torch.enable_grad():
                out = run.block_fn(blocks, inp, *ex)
        else:
            out = run.block_fn(blocks, inp, *ex)
        if r < S - 1:
            C.send(out, r + 1, group)
        ins.append(inp if keep_graph else inp.detach())
        outs.append(out)
    y = torch.cat(outs) if r == S - 1 else torch.empty_like(x)
    return C.broadcast(y.detach(), S - 1, group), ins, outs


class _Pipeline(torch.autograd.Function):
    """The schedule with its hand-written backward (see the module)."""

    @staticmethod
    def forward(ctx, run, x, *tensors):
        extras = [e.detach().requires_grad_(e.requires_grad)
                  for e in tensors[:run.n_extras]]
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in tensors[run.n_extras:]]
        blocks = run.unflatten(leaves)
        gpipe = run.pipe.schedule == "gpipe"
        y, ins, outs = _schedule(run, x, extras, blocks, keep_graph=gpipe)
        ctx.run, ctx.extras, ctx.leaves, ctx.blocks = run, extras, leaves, \
            blocks
        ctx.ins, ctx.outs = ins, (outs if gpipe else None)
        ctx.x_like = (x.shape, x.dtype, x.device)
        return y

    @staticmethod
    def backward(ctx, dy):
        run = ctx.run
        pipe = run.pipe
        S, M, r, group = pipe.n_pipe, pipe.m, pipe.stage, pipe.group
        wants = [t for t in ctx.leaves if t.requires_grad]
        ex_wants = [e for e in ctx.extras if e.requires_grad]
        with torch.enable_grad():
            exs = [e.chunk(M) for e in ctx.extras]
        db = [None] * len(wants)
        dex = [None] * len(ex_wants)
        dxs = []
        mb_shape = ctx.ins[0].shape
        for _, m in ticks(S, M, r, backward=True):
            g = dy.chunk(M)[m] if r == S - 1 else C.recv(
                mb_shape, dy.dtype, dy.device, r + 1, group)
            if ctx.outs is not None:
                inp, out = ctx.ins[m], ctx.outs[m]
            else:
                inp = ctx.ins[m].detach().requires_grad_()
                with torch.enable_grad():
                    out = run.block_fn(ctx.blocks, inp,
                                       *[e[m] for e in exs])
            grads = torch.autograd.grad(out, [inp] + wants + ex_wants,
                                        g.to(out.dtype), allow_unused=True)
            dx = grads[0] if grads[0] is not None else torch.zeros_like(inp)
            if r > 0:
                C.send(dx, r - 1, group)
            dxs.append(dx)
            for i, t in enumerate(grads[1:1 + len(wants)]):
                if t is not None:
                    db[i] = t if db[i] is None else db[i] + t
            for i, t in enumerate(grads[1 + len(wants):]):
                if t is not None:
                    t = t.float()
                    dex[i] = t if dex[i] is None else dex[i] + t
        ctx.outs = ctx.ins = None
        shape, dtype, device = ctx.x_like
        dx = torch.cat(dxs) if r == 0 else torch.empty(shape, dtype=dtype,
                                                       device=device)
        dx = C.broadcast(dx.to(dtype), 0, group)
        db = iter(db)
        leaf_grads = [(next(db) if t.requires_grad else None)
                      for t in ctx.leaves]
        leaf_grads = [g if g is not None or not t.requires_grad
                      else torch.zeros_like(t)
                      for g, t in zip(leaf_grads, ctx.leaves)]
        dex = iter(dex)
        ex_grads = []
        for e in ctx.extras:
            if not e.requires_grad:
                ex_grads.append(None)
                continue
            d = next(dex)
            d = torch.zeros(e.shape, device=e.device) if d is None else d
            ex_grads.append(C.all_reduce(d, group).to(e.dtype))
        return (None, dx, *ex_grads, *leaf_grads)


def pipeline_blocks(pipe: PipeConfig, blocks, x, extras=(), *, group: int = 1,
                    block_fn):
    """Run `block_fn(blocks, x_mb, *extras_mb) -> y_mb` (the stage's blocks,
    in order) over the pipe axis under `pipe.schedule`.

    blocks: this stage's blocks (Layout.partition cut them). x: [rows, ...]
    activations (rows = B * T for temporal towers), replicated over pipe.
    extras: batch-aligned tensors (the text key bias) split into
    microbatches alongside x. group: rows that stay in one microbatch (the
    frame count T of a temporal tower, whose blocks reshape whole
    videos)."""
    S, M = pipe.n_pipe, pipe.m
    rows = x.shape[0]
    if rows % (M * group):
        raise ValueError(
            f"batch rows {rows} not divisible into {M} microbatches of "
            f"whole {group}-row groups (pipe_microbatches must divide the "
            f"per-call batch)")
    if pipe.schedule not in SCHEDULES:
        raise ValueError(f"unknown pipe schedule {pipe.schedule!r}; "
                         f"expected 'gpipe' or '1f1b'")
    if S == 1:
        return block_fn(blocks, x, *extras)
    leaves = _flatten(blocks, [])
    run = _Run(pipe=pipe, block_fn=block_fn, blocks=blocks,
               n_extras=len(extras))
    grads = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *extras, *leaves])
    if not grads:
        y, _, _ = _schedule(run, x, list(extras), blocks, keep_graph=False)
        return y
    return _Pipeline.apply(run, x, *extras, *leaves)
