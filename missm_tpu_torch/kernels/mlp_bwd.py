"""The MLP backward's input gradient, fused: the hand-written CUDA kernel
csrc/mlp_bwd.cu, its wrapper and its plain PyTorch version.

`mlp_bwd_dx` takes the place of K6, missm_tpu/kernels/mlp_bwd.py::mlp_bwd_dx:
for a quick_gelu MLP h -> quick_gelu(h W1) W2 whose forward saved the fc1
pre-activation `wide`,

    dh = R(R((dy W2^T) * qg'(wide)) W1^T),
    qg'(x) = s (1 + 1.702 x (1 - s)),  s = sigmoid(1.702 x),

with R rounding to dy's type: the first product and the derivative in f32,
dwide rounded once, the second product accumulated in f32. The kernel keeps
dwide [M, FF] on the chip: in bf16 a cluster of C blocks owns 128 rows, each
block D / C of the output columns, and each step of C * 64 FF columns the
blocks exchange their dwide chunks through distributed shared memory. `plan`
says what each bf16 launch computes.

No model path calls it, as in the JAX package: its callers are the probe
(probes/mlp_bwd_probe.py) and the tests. On a CPU tensor the wrapper
computes the plain version; on a CUDA tensor it launches the kernel or
raises, and each launch adds one to LAUNCHES["mlp_bwd_dx"].
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..ops.basic import matmul_f32
from . import build
from .launches import LAUNCHES

D_SIZES = (128, 256, 512, 768, 1024)  # the widths csrc/mlp_bwd.cu is built for
ROWS = 128          # rows a cluster owns: two consumer warpgroups of 64
DEPTH = 64          # depth of a stage; FF columns of a block's dwide chunk
NOUT = (128, 256)   # output columns a block owns (wgmma's N), as built
MAX_CLUSTER = 8
MAX_STAGES = 4
SMEM_LIMIT = 232_448


def tiles(d: int) -> tuple:
    """The bf16 kernel's tiles (rows, cluster) at width d: clusters of C
    blocks each owning d / C output columns, as built (NOUT), the narrower
    first. The first is the default: with 128 output columns a block the
    accumulator stays in registers, with 256 it spills (PERF.md, PR 9)."""
    return tuple((ROWS, d // n) for n in NOUT
                 if d % n == 0 and d // n <= MAX_CLUSTER)


TILES = tiles(1024)  # the probe's width: its sweep


def default_tile(d: int):
    return tiles(d)[0]


# Clusters of C blocks (one an SM) that an H100 runs at once, from
# cudaOccupancyMaxActiveClusters on the card (kernels/ln_linear.py).
ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15}


def _stage_bytes(nout: int) -> int:
    """A (dy [128, 64], W2 [64, 64]) stage or a W1 [nout, 64] stage."""
    return max(ROWS * DEPTH * 2 + 64 * DEPTH * 2, nout * DEPTH * 2)


def _smem(cluster: int, nout: int, stages: int) -> int:
    """The aligned dwide step buffer, the wide tile, the ring and the
    barriers (a full and an empty one a stage, the wide tile's two, two a
    consumer warpgroup for the dwide step)."""
    chunk = ROWS * DEPTH * 2
    return (1024 + cluster * chunk + chunk + stages * _stage_bytes(nout)
            + 8 * (2 * stages + 2 + 4))


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one bf16 launch at [m, d, ff] with tile (rows, cluster)
    computes: row tiles of `rows` rows (the last ragged), each owned by a
    cluster of `cluster` blocks; block c owns output columns
    `out_cols(c)` and computes the dwide chunk `ff_chunks(c)` of each FF
    step; `stages` stages in flight; `smem_bytes` of dynamic shared
    memory."""
    m: int
    d: int
    ff: int
    rows: int
    cluster: int
    stages: int
    smem_bytes: int

    @property
    def nout(self) -> int:
        return self.d // self.cluster

    @property
    def row_tiles(self) -> tuple:
        return tuple((r, min(self.rows, self.m - r))
                     for r in range(0, self.m, self.rows))

    @property
    def grid(self) -> int:
        return len(self.row_tiles) * self.cluster

    @property
    def waves(self) -> int:
        """Waves of clusters on an H100 (ACTIVE_CLUSTERS at once)."""
        return -(-len(self.row_tiles) // ACTIVE_CLUSTERS[self.cluster])

    @property
    def steps(self) -> int:
        return self.ff // (self.cluster * DEPTH)

    def out_cols(self, rank: int) -> range:
        return range(rank * self.nout, (rank + 1) * self.nout)

    def ff_chunks(self, rank: int) -> tuple:
        """The first FF column of the dwide chunk block `rank` computes in
        each step."""
        step = self.cluster * DEPTH
        return tuple(s * step + rank * DEPTH for s in range(self.steps))


@functools.lru_cache(maxsize=None)
def plan(m: int, d: int, ff: int, tile=None) -> Plan:
    """The bf16 launch at [m, d, ff] with `tile` (default: default_tile(d)).
    Raises ValueError on what the kernel was not built for or what does
    not fit."""
    tile = default_tile(d) if tile is None and d in D_SIZES else tile
    if d not in D_SIZES:
        raise ValueError(f"mlp_bwd_dx kernel takes D in {D_SIZES}; got {d}")
    if tuple(tile) not in tiles(d):
        raise ValueError(f"no tile {tuple(tile)} at D={d}; built: {tiles(d)}")
    rows, cluster = tile
    if m < 1 or ff < 1 or ff % (cluster * DEPTH):
        raise ValueError(f"FF={ff} is not a positive multiple of "
                         f"{cluster * DEPTH} (tile {tuple(tile)}), or m={m} < 1")
    nout = d // cluster
    stages = MAX_STAGES
    while stages >= 2 and _smem(cluster, nout, stages) > SMEM_LIMIT:
        stages -= 1
    if stages < 2:
        raise ValueError(f"tile {tuple(tile)} at D={d} does not fit")
    return Plan(m, d, ff, rows, cluster, stages, _smem(cluster, nout, stages))


def quick_gelu_grad(x):
    """d quick_gelu / dx = s (1 + 1.702 x (1 - s)), s = sigmoid(1.702 x)."""
    s = torch.sigmoid(1.702 * x)
    return s * (1.0 + 1.702 * x * (1.0 - s))


def mlp_bwd_dx_plain(dy, wide, w1, w2):
    """The kernel's function in plain PyTorch, after the JAX package's
    mlp_bwd_dx_xla: two f32-accumulating products around one elementwise
    pass, dwide rounded to dy's type between them."""
    dwide = matmul_f32(dy, w2.t()) * quick_gelu_grad(wide.float())
    return matmul_f32(dwide.to(dy.dtype), w1.t()).to(dy.dtype)


def mlp_bwd_dx(dy, wide, w1, w2, *, tile=None):
    """dh [M, D] in dy's type, for dy [M, D], wide [M, FF], w1 [D, FF] and
    w2 [FF, D]. `tile` (bf16 on CUDA only): one of tiles(D), default
    default_tile(D)."""
    if dy.device.type == "cpu":
        return mlp_bwd_dx_plain(dy, wide, w1, w2)
    out = _launch(dy, wide, w1, w2, tile)
    LAUNCHES["mlp_bwd_dx"] += 1
    return out


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(dy, wide, w1, w2, tile):
    """The K6 kernel. Raises on what it does not take: tensors not CUDA,
    contiguous, 16-byte aligned and of one type (float32 or bfloat16),
    shapes that disagree, D not one of D_SIZES; in bf16 what `plan` refuses
    (a tile it was not built for, FF not a multiple of the tile's step);
    FF not a multiple of 16 in float32."""
    if dy.device.type != "cuda":
        raise ValueError(f"mlp_bwd_dx kernel needs CUDA tensors, got {dy.device}")
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dy must be float32 or bfloat16; got {dy.dtype}")
    if dy.dim() != 2 or wide.dim() != 2:
        raise ValueError("dy and wide must be 2-D")
    M, D = dy.shape
    FF = wide.shape[1]
    shapes = dict(wide=(M, FF), w1=(D, FF), w2=(FF, D))
    for name, t in dict(wide=wide, w1=w1, w2=w2).items():
        if tuple(t.shape) != shapes[name] or t.dtype != dy.dtype:
            raise ValueError(f"{name} must be {dy.dtype} {shapes[name]}; got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in dict(dy=dy, wide=wide, w1=w1, w2=w2).items():
        if t.device != dy.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                             f"on {dy.device}")
    bf16 = dy.dtype == torch.bfloat16
    if D not in D_SIZES:
        raise ValueError(f"mlp_bwd_dx kernel takes D in {D_SIZES}; got {D}")
    if bf16:
        tile = plan(M, D, FF, None if tile is None else tuple(tile))
        tile = (tile.rows, tile.cluster)
    else:
        tile = (0, 0)
        if FF % 16:
            raise ValueError(f"FF={FF} is not a multiple of 16")
    out = torch.empty_like(dy)
    fn = build.function("mlp_bwd", "missm_mlp_bwd_dx", _ARGTYPES)
    rc = fn(dy.data_ptr(), wide.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            out.data_ptr(), M, D, FF, int(bf16), tile[0], tile[1],
            torch.cuda.current_stream(dy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_bwd_dx kernel launch failed: CUDA error {rc}")
    return out
