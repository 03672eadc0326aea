"""The readings that the limits of `limits/<workload>.json` are set from,
on the card, at the cell's own sizes, in one process:

    python3 portbench/tools/readings.py --workload glis80-train \
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31,32,33

Prints one JSON line per reading: the program's numbers on each seed
(sound runs: the lower readings), the control's (the reference in fp8 in
the program's place: the upper readings) and each planted fault's
(`portbench.faults`). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import faults, harness  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--faults", default="", help="comma-separated; default every fault "
                   "the cell's loop can have (portbench.faults.FAULTS)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    harness.set_cache_env()
    import torch

    cell = harness.find_cell(a.workload)
    dev = torch.device(a.device)

    def emit(kind, seed, numbers, detail, t0):
        print(json.dumps({"workload": a.workload, "kind": kind, "seed": seed,
                          "numbers": numbers, "detail": detail,
                          "s": time.perf_counter() - t0}), flush=True)

    jobs = [("program", s) for s in a.seeds] + [("control", s) for s in a.control_seeds]
    planted = a.faults.split(",") if a.faults else faults.FAULTS[cell.mix["loop"]]
    jobs += [(f"fault:{f}", s) for f in planted for s in a.fault_seeds]
    for kind, seed in jobs:
        t0 = time.perf_counter()
        run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False, device=dev)
        run.loop_name = cell.mix["loop"]
        fault = kind.split(":", 1)[1] if kind.startswith("fault:") else None
        detail: dict = {}
        with faults.planted(fault, run.loop_name):
            numbers = faults.reading(run, control=kind == "control", detail=detail)
        emit(kind, seed, numbers, detail, t0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
