#!/usr/bin/env python3
"""How often a process of the port aborts as it exits, on the CPU.

    python scripts/torch_exit_abort_probe.py daemon [--runs 20]
    python scripts/torch_exit_abort_probe.py resume [--root DIR] [--minutes 15]

`daemon`: runs a short script `--runs` times for each kind of daemon
thread, left running as the interpreter exits: one that makes tensors
with `torch.from_numpy`, one that copies numpy arrays, one that sleeps;
prints how many runs ended in an abort (a negative return code, "terminate
called without an active exception" on stderr).

`resume`: the scenario of `tests/test_torch_port_parallel_cli.py`'s
world-2 resume case, over and over for `--minutes`: two gloo ranks
(`gea_torch.parallel.spawn`) run 2 steps of a tiny G-LIS or R-iterative
run, then resume it to 4 in the same processes
(`tests/torch_port_dp_workers.py::resume`), and exit. Imports `gea_torch`
from `--root` (default: this checkout), so two checkouts can run side by
side under the same load. Prints each failure and the count of runs and
failures; ranks run with faulthandler on, so an abort dumps its threads.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

DAEMON = """
import threading, time, numpy as np, torch
a = np.zeros((64, 64, 64, 3), np.uint8)
def loop():
    while True:
        {body}
threading.Thread(target=loop, daemon=True).start()
time.sleep(0.1)
"""
BODIES = {"torch.from_numpy": "torch.from_numpy(np.ascontiguousarray(a))",
          "numpy copy": "np.ascontiguousarray(a[:, ::2])",
          "sleep": "time.sleep(0.001)"}
TINY = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size", "32",
        "--code_size", "16", "--num_features", "4", "--max_features", "16", "--batch_size", "4",
        "--dtype", "float32", "--log_interval", "1", "--vis_rows", "2"]
TRAINERS = {"glis": ("train_glis", "TrainGLISConfig", ["--r_iterations", "1"]),
            "r_iterative": ("train_r_iterative", "TrainRIterativeConfig", ["--r_hidden", "32"])}


def daemon(runs: int) -> int:
    for kind, body in BODIES.items():
        aborts = 0
        for _ in range(runs):
            p = subprocess.run([sys.executable, "-c", DAEMON.format(body=body)],
                               capture_output=True, text=True, timeout=120)
            aborts += p.returncode < 0 or "terminate called" in p.stderr
        print(f"daemon thread in {kind}: {aborts} of {runs} runs aborted", flush=True)
    return 0


def resume(root: str, minutes: float) -> int:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["PYTHONFAULTHANDLER"] = "1"
    import torch

    import torch_port_dp_workers as workers
    from gea_torch.parallel import spawn

    torch.set_num_threads(1)
    deadline = time.monotonic() + 60 * minutes
    runs = fails = 0
    while time.monotonic() < deadline:
        for trainer, (module, cls, extra) in TRAINERS.items():
            tmp = tempfile.mkdtemp(prefix="gea_torch_abort_probe_")
            split = os.path.join(tmp, "split")
            argv = [TINY + extra + ["--save_path", split, "--niter", str(n), "--vis_interval", "2",
                                    "--save_interval", "2"] for n in (2, 4)]
            runs += 1
            try:
                spawn(workers.resume, 2, torch.device("cpu"), args=(module, cls, argv),
                      timeout=400)
            except BaseException as e:  # a rank's abort, or any other failure
                fails += 1
                print(f"run {runs} [{trainer}] failed: {type(e).__name__}: {e}", flush=True)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    print(f"{root}: {fails} of {runs} resumed world-2 runs failed", flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("daemon", "resume"))
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--minutes", type=float, default=15.0)
    args = p.parse_args()
    return daemon(args.runs) if args.mode == "daemon" else resume(args.root, args.minutes)


if __name__ == "__main__":
    sys.exit(main())
