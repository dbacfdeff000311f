"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell (weights and inputs from --seed, every shape warmed up),
measures for --seconds, checks what the timed path produced against the
plain reference, and prints one JSON line as the last line of its output.
It needs a CUDA card and exits non-zero without one.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment():
    """Every cache inside the checkout, at fixed paths; no JAX through a
    library that would load it."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host sets the pace of these cells,
    # and idle intra-op threads only contend with the thread that launches
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # the portbench directory itself would shadow the standard library
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))


def _card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "not read"
    print(f"card: {out}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    _card_line()
    from portbench import harness
    return harness.run(args, T0)


if __name__ == "__main__":
    sys.exit(main())
