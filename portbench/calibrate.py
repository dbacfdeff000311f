"""The readings a cell's limits are set from, in one process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --seconds 3 \
        --out build/portbench/readings.jsonl

For each of --seeds, a sound run (set-up, a window of --seconds, the check);
for each of --control-seeds, the check's numbers with the reference at
float8 in the port's place; for each of --fault-seeds and each fault of the
cell's kind (faults.py), a run with that fault planted. One JSON line per
reading: {"what", "seed", "readings": {name: value}}. The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(HERE.parent))

    import torch

    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell, cfg, mix = harness.cell_files(args.workload)
    limits = cell["limits"]
    Runner = harness.kind_runner(mix["kind"])
    kinds = (faults.SWEEP_FAULTS if mix["kind"] == "sweep"
             else faults.TRAIN_FAULTS)
    jobs = [("sound", s, None) for s in args.seeds]
    jobs += [("control", s, None) for s in args.control_seeds]
    jobs += [(f, s, f) for s in args.fault_seeds for f in kinds]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a", encoding="utf-8") as out:
        for what, seed, fault in jobs:
            t0 = time.perf_counter()
            runner = Runner(cfg, mix, seed, dev)
            if fault is None:
                harness.measure(runner, args.seconds, False, t0)
            else:
                with faults.planted(fault):
                    harness.measure(runner, args.seconds, False, t0)
            checks = (runner.control(limits) if what == "control"
                      else runner.check(limits))
            line = {"workload": args.workload, "what": what, "seed": seed,
                    "seconds": time.perf_counter() - t0,
                    "readings": {c.name: c.value for c in checks},
                    "notes": {c.name: c.note for c in checks if c.note}}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            out.flush()
            del runner
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
