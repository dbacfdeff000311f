"""The device mesh, after missm_tpu/core/mesh.py.

The reference's only parallelism is DDP over NCCL (train_ddp.py:145,189).
The JAX package runs one process over n devices and names its mesh axes
data, model and pipe; here one process drives one device under
`torch.distributed`, and the mesh is a `DeviceMesh` over the ranks with
the same axis names. The minor axes (model, pipe) take consecutive ranks,
so that on a multi-GPU node they stay on NVLink neighbours; across nodes
only the data axis crosses (`hybrid_shapes`). A pipe axis exists only when
n_pipe > 1, so a 2-axis mesh stays as it was.

The process group must be up before `make_mesh` (cli/common.py::
maybe_init_distributed, or `torch.distributed.init_process_group`).
"""
from __future__ import annotations

import os
import warnings

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def make_mesh(n_data: int | None = None, n_model: int = 1, n_pipe: int = 1,
              *, device_type: str = "cuda"):
    """A (data, model[, pipe]) DeviceMesh over every rank of the process
    group. With no arguments every rank sits on the data axis (pure DP, the
    reference's DDP world). `device_type` is the card by default; the CPU
    worlds of the tests pass "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(cli.common.maybe_init_distributed or "
            "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world < n_model * n_pipe:
        raise ValueError(
            f"mesh needs at least n_model*n_pipe = {n_model}*{n_pipe} = "
            f"{n_model * n_pipe} devices, have {world}")
    if n_data is None:
        n_data = world // (n_model * n_pipe)
    if n_data * n_model * n_pipe != world:
        raise ValueError(
            f"mesh {n_data}x{n_model}x{n_pipe} does not cover the "
            f"{world} ranks of the process group")
    _check_local(n_model, n_pipe)
    if n_pipe > 1:
        shape, names = ((n_data, n_model, n_pipe),
                        (DATA_AXIS, MODEL_AXIS, PIPE_AXIS))
    else:
        shape, names = (n_data, n_model), (DATA_AXIS, MODEL_AXIS)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _check_local(n_model: int, n_pipe: int):
    """Warn when a node's ranks cannot hold whole model x pipe groups: the
    JAX package's `_topology_grid` warns when its placement falls back to an
    order that may put model/pipe partners on far chips. Here the partners
    of one group then span nodes, and every block's collective crosses
    them."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    inner = n_model * n_pipe
    if local and inner > 1 and local % inner:
        warnings.warn(
            f"LOCAL_WORLD_SIZE {local} does not hold whole model x pipe "
            f"groups of {inner} ranks; model/pipe collectives may cross "
            f"nodes", stacklevel=3)


def hybrid_shapes(n_data: int, n_model: int, n_pipe: int, n_slices: int):
    """(per-node shape, across-node shape) of a multi-node layout, or None
    when model x pipe cannot stay inside a node (the JAX package's per-slice
    ICI and DCN shapes): only the data axis spans nodes, it must split
    evenly across them, and every node holds the full model x pipe
    extent."""
    if n_slices <= 1 or n_data % n_slices:
        return None
    if n_pipe > 1:
        return ((n_data // n_slices, n_model, n_pipe), (n_slices, 1, 1))
    return ((n_data // n_slices, n_model), (n_slices, 1))


def axis_size(mesh, name: str) -> int:
    """The mesh's extent along `name`; 1 without a mesh or such an axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along `name`; 0 without a mesh or such an
    axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this rank's line along `name`, or None when the
    axis is absent or of size 1 (nothing to communicate)."""
    if axis_size(mesh, name) == 1:
        return None
    return mesh.get_group(name)


def data_coordinate(mesh) -> tuple[int, int]:
    """(shard_index, num_shards) of this rank's rows: its data coordinate
    and the data axis size. Every model and pipe rank of one data replica
    reads the same rows."""
    return axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)


def local_batch_size(global_batch: int, mesh) -> int:
    n = axis_size(mesh, DATA_AXIS)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data axis {n}")
    return global_batch // n
