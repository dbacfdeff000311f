"""Build the CUDA sources under `missm_tpu_torch/csrc/` with nvcc and load them.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (`build/missm_tpu_torch/lib<name>_<digest>.so` at the repository
root), which `ctypes` loads. The digest covers the source and the flags, so a
changed source builds anew and an unchanged one is reused. Nothing is built
when a module is imported: the first kernel launch builds what it needs, and
`build_all` builds every source at once, one nvcc process per source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "missm_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; None if the library is already built."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return log


def build_all() -> dict:
    """Compile every csrc/*.cu concurrently. Returns {name: (seconds,
    compiler log)}; the log holds ptxas' register and shared-memory report."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    started = {n: _start(n) for n in names}
    result = {}
    for n in names:
        log = _finish(n, started[n])
        result[n] = (time.perf_counter() - t0, log)
    return result


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(_library_path(name)))
