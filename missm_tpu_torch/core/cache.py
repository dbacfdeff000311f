"""Where the port's compiled kernels persist, after missm_tpu/core/cache.py.

The JAX package keeps a persistent XLA compilation cache. The port
compiles nothing at run time but its CUDA libraries, which
`kernels/build.py` caches by digest under `BUILD_DIR`
(`build/missm_tpu_torch/` at the repository root), so this points that
directory elsewhere: at `path`, or at `$MISSM_TORCH_CACHE`. With neither
the default stays. Unlike the JAX function, a directory that cannot be
created raises here: a build directory that cannot be used would only
fail later, at the first kernel launch.
"""
from __future__ import annotations

import os
from pathlib import Path


def enable_compilation_cache(path: str | None = None) -> Path:
    """Point the kernel build cache at `path` or `$MISSM_TORCH_CACHE`,
    creating the directory; returns the directory in use. Call once at
    entry (cli/common.py::setup_mesh does)."""
    from ..kernels import build

    where = path or os.environ.get("MISSM_TORCH_CACHE")
    if where:
        build.BUILD_DIR = Path(where).expanduser().resolve()
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return build.BUILD_DIR
