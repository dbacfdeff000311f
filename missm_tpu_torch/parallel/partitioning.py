"""Parameter and batch partitioning over the (data, model[, pipe]) mesh,
after missm_tpu/parallel/partitioning.py.

The rules are the JAX package's:

- DP (the reference's DDP): params replicated, each data rank takes its
  rows of the batch, and the gradients are summed over the data group
  (train/step.py).
- Megatron TP over the model axis: q/k/v/fc1 w and b column-parallel, the
  out/fc2 w row-parallel (`_COL`, `_ROW`), for every block leaf of every
  tower (the temporal attention and MLP included); every other leaf, LoRA
  factors too, replicated.
- FSDP (ZeRO-3) over the data axis: each leaf of at least `fsdp_min_size`
  elements is sharded along its largest axis that n_data divides and TP
  leaves free; one with no such axis stays replicated (the per-leaf guard
  an odd device count needs). The Adam moments are built on the local
  shards, so they shard with their leaf.
- Pipe: the stages own contiguous ranges of each tower's blocks.

The port's blocks are a list of per-layer dicts where JAX stacks them
[L, ...], so a spec here is the JAX spec of the stacked leaf without its
leading layer entry (which JAX never shards but over pipe). JAX applies
`fsdp_min_size` to the stacked leaf, L times a layer's; so does
`param_pspecs`, or a block leaf JAX shards would stay replicated here.

A spec is a tuple with one entry a dimension: None, "data" or "model".
`Layout` holds the specs of a run's full tree and what each rank does
with them: its slices (`partition`), the FSDP gather before use and the
gradient reduction (train/step.py), and the full tree back from the
shards (`gather`, for checkpoints).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, axis_group,
                         axis_index, axis_size)
from . import collectives as C

# (parent module, leaf) -> which axis of the (in, out) matmul is sharded
_COL = {("q", "w"), ("k", "w"), ("v", "w"), ("fc1", "w"),
        ("q", "b"), ("k", "b"), ("v", "b"), ("fc1", "b")}
_ROW = {("out", "w"), ("fc2", "w")}

FSDP_MIN_SIZE = 65536  # leaves below this (elements) stay replicated


def _tp_spec(names, ndim):
    if "blocks" not in names or len(names) < 2:
        return (None,) * ndim
    pair = (names[-2], names[-1])
    if pair in _COL:
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if pair in _ROW:
        spec = [None] * ndim
        spec[-2] = MODEL_AXIS
        return tuple(spec)
    return (None,) * ndim


def _fsdp_spec(shape, base, size, n_data, min_size):
    """`base` with DATA_AXIS on the largest still-unsharded axis that
    n_data divides; `size` is the leaf's element count as JAX counts it (the
    stacked [L, ...] size for a block leaf)."""
    if len(shape) == 0 or size < min_size:
        return base
    spec = list(base)
    best = None
    for ax in range(len(shape)):
        if spec[ax] is not None or shape[ax] % n_data:
            continue
        if best is None or shape[ax] > shape[best]:
            best = ax
    if best is None:
        return base
    spec[best] = DATA_AXIS
    return tuple(spec)


def _map_paths(fn, tree, names=(), layers=1):
    """fn(names, leaf, layers) over a param tree; `layers` is the length of
    the `blocks` list a leaf sits in (1 outside one)."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, names + (k,),
                              len(v) if k == "blocks" else layers)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, names + (str(i),), layers)
                for i, v in enumerate(tree)]
    return fn(names, tree, layers)


def param_pspecs(params, tp: bool = False, fsdp_size: int = 0,
                 fsdp_min_size: int = FSDP_MIN_SIZE, pipe: bool = False):
    """The spec of every leaf of `params` (the full tree): the Megatron
    col/row specs over MODEL_AXIS with `tp`, and with `fsdp_size` > 1 large
    leaves over DATA_AXIS as well. `pipe` shards no dimension of a layer:
    its stages own block ranges (`stage_range`)."""
    del pipe  # the JAX spec's layer entry, which the port does not have

    def spec(names, leaf, layers):
        shape = tuple(leaf.shape)
        s = _tp_spec(names, len(shape)) if tp else (None,) * len(shape)
        if fsdp_size and fsdp_size > 1:
            s = _fsdp_spec(shape, s, leaf.numel() * layers, fsdp_size,
                           fsdp_min_size)
        return s

    return _map_paths(spec, params)


def stage_range(n_layers: int, n_pipe: int, stage: int) -> range:
    """The blocks stage `stage` of `n_pipe` owns."""
    if n_layers % n_pipe:
        raise ValueError(f"{n_layers} layers not divisible by pipe axis "
                         f"{n_pipe}")
    per = n_layers // n_pipe
    return range(stage * per, (stage + 1) * per)


def zip_map(fn, *trees):
    """fn over the leaves of trees of one structure (dicts and lists), the
    first tree's structure out."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: zip_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [zip_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


@dataclasses.dataclass(eq=False)
class Layout:
    """One run's parallel layout: the mesh, which of TP, FSDP and pipe are
    on, and `specs`, the full tree's specs (param_pspecs). Built by
    `make_layout`; carried by ModelConfig.parallel."""
    mesh: object
    tp: bool
    fsdp: bool
    pipe: bool
    specs: object
    fsdp_min_size: int = FSDP_MIN_SIZE

    # -- the axes as this rank sees them --------------------------------
    @property
    def n_data(self) -> int:
        return axis_size(self.mesh, DATA_AXIS)

    @property
    def data_index(self) -> int:
        return axis_index(self.mesh, DATA_AXIS)

    @property
    def data_group(self):
        return axis_group(self.mesh, DATA_AXIS)

    @property
    def n_model(self) -> int:
        return axis_size(self.mesh, MODEL_AXIS)

    @property
    def model_axis(self):
        """The blocks' ModelAxis under TP, else None."""
        if not self.tp or self.n_model == 1:
            return None
        return C.ModelAxis(axis_group(self.mesh, MODEL_AXIS), self.n_model)

    @property
    def n_pipe(self) -> int:
        return axis_size(self.mesh, PIPE_AXIS)

    @property
    def stage(self) -> int:
        return axis_index(self.mesh, PIPE_AXIS)

    # -- slicing ---------------------------------------------------------
    def _coord(self, axis):
        return ((self.n_data, self.data_index) if axis == DATA_AXIS
                else (self.n_model, axis_index(self.mesh, MODEL_AXIS)))

    def _stage_blocks(self, tree):
        """`tree` (params or specs) with each blocks list cut to this
        stage's range."""
        if not self.pipe or self.n_pipe == 1:
            return tree
        if isinstance(tree, dict):
            return {k: ([self._stage_blocks(b) for b in
                         (v[i] for i in stage_range(len(v), self.n_pipe,
                                                    self.stage))]
                        if k == "blocks" else self._stage_blocks(v))
                    for k, v in tree.items()}
        return tree

    @functools.cached_property
    def local_specs(self):
        return self._stage_blocks(self.specs)

    def shard(self, leaf, spec):
        """This rank's slice of a full leaf (None passes through)."""
        if leaf is None:
            return None
        out = leaf
        for ax, name in enumerate(spec):
            if name is not None:
                n, i = self._coord(name)
                out = out.chunk(n, ax)[i]
        return out.contiguous() if out is not leaf else out

    def partition(self, params):
        """This rank's tree of a full param tree (or of one shaped like it):
        its stage's blocks, each leaf cut to its slices. New tensors where a
        leaf is cut; the others are `params`' own."""
        return zip_map(self.shard, self._stage_blocks(params),
                        self.local_specs)

    # -- gathering -------------------------------------------------------
    def materialize(self, tree, specs):
        """`tree` (a local subtree, `specs` its local specs) with every FSDP
        shard gathered over the data group before use, the gradient going
        back by reduce-scatter (collectives.gather_shard); TP shards stay,
        the blocks compute on them."""
        if not self.fsdp or self.n_data == 1:
            return tree

        def one(leaf, spec):
            if leaf is None or DATA_AXIS not in spec:
                return leaf
            return C.gather_shard(leaf, spec.index(DATA_AXIS),
                                  self.data_group)
        return zip_map(one, tree, specs)

    def _unshard(self, leaf, spec):
        for ax, name in enumerate(spec):
            if name == DATA_AXIS:
                leaf = C.all_gather(leaf, ax, self.data_group)
            elif name == MODEL_AXIS:
                leaf = C.all_gather(leaf, ax, axis_group(self.mesh,
                                                         MODEL_AXIS))
        return leaf

    def gather(self, local):
        """The full tree from every rank's `local` tree (a collective: every
        rank calls it and gets the full tree). Leaves that are not tensors
        (None) pass through."""
        def one(leaf, spec):
            return leaf if leaf is None else self._unshard(leaf, spec)

        out = zip_map(one, local, self.local_specs)
        if not self.pipe or self.n_pipe == 1:
            return out
        return self._gather_blocks(out)

    def _gather_blocks(self, tree):
        group = axis_group(self.mesh, PIPE_AXIS)
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k != "blocks":
                    out[k] = self._gather_blocks(v)
                    continue
                parts = [zip_map(lambda t: None if t is None else
                                  C.all_gather(t[None], 0, group), b)
                         for b in v]
                out[k] = [zip_map(lambda t, s=s: None if t is None
                                   else t[s], b)
                          for s in range(self.n_pipe) for b in parts]
            return out
        return tree


def make_layout(params, mesh, tp: bool = False, fsdp: bool = False,
                fsdp_min_size: int = FSDP_MIN_SIZE, pipe: bool = False,
                towers=None) -> Layout:
    """The Layout of the full tree `params` on `mesh`. With `towers`
    ({modality: TowerConfig}) TP checks that every tower's heads split over
    the model axis; every sharded dimension must divide by its axis."""
    n_data = axis_size(mesh, DATA_AXIS)
    specs = param_pspecs(params, tp=tp, fsdp_size=n_data if fsdp else 0,
                         fsdp_min_size=fsdp_min_size, pipe=pipe)
    lay = Layout(mesh=mesh, tp=tp, fsdp=fsdp, pipe=pipe, specs=specs,
                 fsdp_min_size=fsdp_min_size)
    n_model = axis_size(mesh, MODEL_AXIS)
    if tp and n_model > 1:
        for mod, tcfg in (towers or {}).items():
            for part in (tcfg.vision, tcfg.text):
                if part.num_heads % n_model:
                    raise ValueError(
                        f"{mod} tower: {part.num_heads} heads do not split "
                        f"over model axis {n_model}")

        def divisible(leaf, spec):
            for ax, name in enumerate(spec):
                if name == MODEL_AXIS and leaf.shape[ax] % n_model:
                    raise ValueError(
                        f"a leaf of shape {tuple(leaf.shape)} does not "
                        f"split over model axis {n_model}")
        zip_map(divisible, params, specs)
    if pipe:
        _map_paths(lambda names, leaf, layers: "blocks" in names
                   and stage_range(layers, axis_size(mesh, PIPE_AXIS), 0),
                   params)
    return lay


def partition_params(params, mesh, tp: bool = False, fsdp: bool = False,
                     fsdp_min_size: int = FSDP_MIN_SIZE, pipe: bool = False):
    """This rank's slices of the full tree `params` (make_layout(...)
    .partition); the JAX function device_puts the tree with its specs."""
    return make_layout(params, mesh, tp=tp, fsdp=fsdp,
                       fsdp_min_size=fsdp_min_size, pipe=pipe).partition(
                           params)


def shard_batch(batch, mesh, microbatches: int = 1):
    """This rank's rows of every leaf of a global batch (dicts of arrays or
    tensors): the rows of its data coordinate. With `microbatches` = A > 1
    the batch is seen as A microbatches of B / A rows, and the rank takes
    its slice of each, so that its local microbatch i is its part of the
    global microbatch i (train/step.py's accumulation)."""
    n, i = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(rows(v) for v in x)
        B = x.shape[0]
        if B % (n * microbatches):
            raise ValueError(f"batch {B} not divisible into {microbatches} "
                             f"microbatch(es) over data axis {n}")
        h = B // (n * microbatches)
        idx = [a * n * h + i * h + j for a in range(microbatches)
               for j in range(h)]
        if torch.is_tensor(x):
            return x[torch.as_tensor(idx, device=x.device)]
        return x[idx]
    return rows(batch)
