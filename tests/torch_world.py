"""Spawned gloo CPU worlds for the port's parallel tests.

`run_world(n, "module:function", tmp_path, **kwargs)` starts n processes,
each `python tests/torch_world.py ...`, joins them into one gloo process
group through a `file://` rendezvous in `tmp_path` (no TCP port: several
test workers share the machine), calls `function(rank, n, **kwargs)` in
every rank and returns the ranks' results (pickled through `tmp_path`).
The children import torch and the port only, never JAX: the kwargs are
numpy arrays and plain values.

Each world has its own timeout (the process group's, and a deadline on the
children), so a hang fails its test instead of running the suite into its
limit. One torch thread a rank.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import uuid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(n: int, target: str, tmp_path, *, timeout: float = 120.0,
              env=None, **kwargs):
    """The n ranks' return values of `target` ("module:function")."""
    tag = uuid.uuid4().hex[:8]
    work = os.path.join(str(tmp_path), f"world_{tag}")
    os.makedirs(work)
    with open(os.path.join(work, "args.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    child_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                     MKL_NUM_THREADS="1", **(env or {}))
    child_env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(n):
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), work, str(r), str(n),
             target, str(timeout)],
            cwd=REPO, env=child_env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        out = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                out.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                           + f.read()[-4000:])
        raise AssertionError(
            f"world of {n} running {target}: "
            + (f"{len(hung)} rank(s) hung past {timeout} s; " if hung else "")
            + f"failed ranks {failed}\n" + "\n".join(out))
    results = []
    for r in range(n):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _child(work, rank, n, target, timeout):
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(work, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "rendezvous"),
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mod, fn = target.split(":")
        out = getattr(importlib.import_module(mod), fn)(rank, n, **kwargs)
        with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
           float(sys.argv[5]))
