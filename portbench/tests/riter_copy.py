"""`benchcopy`'s copy of the benchmark with a tiny R-iterative cell added:
configuration `tinyriter` and cell `tiny-riter` (the `riter` mix at K = 2),
which takes the limits of `riter80-train`, and a dry run that plants
`portbench.faults_riter`'s faults."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import benchcopy

TINY_RITER = dict(image_size=32, code_size=16, norm="weight", r_iterations=0, num_features=8,
                  max_features=32, spatial_code=0, dtype="float32", r_chain_length=2,
                  r_hidden=32, lambda_r=0.9, lr=0.0002, beta1=0.5, beta2=0.999, batch_size=4,
                  grad_accum=1, remat=False, lr_schedule="constant", num_devices=1)
RITER_METRICS = ("chain_ms_per_step.riter", "gr_backward_ms_per_step.riter",
                 "kernels_roofline.riter", "step_mfu.riter", "idle_share.riter")


def make_copy(dest: str) -> str:
    benchcopy.make_copy(dest)
    pb = os.path.join(dest, "portbench")
    benchcopy.write(os.path.join(pb, "configs", "tinyriter.json"),
                    {"name": "tinyriter", "flags": TINY_RITER})
    with open(os.path.join(pb, "mixes", "riter.json")) as f:
        mix = json.load(f)
    mix["flags"].update(steps_per_dispatch=2, log_interval=2)
    benchcopy.write(os.path.join(pb, "mixes", "tinyriter.json"), dict(mix, trace_seconds=0.2))
    shutil.copy(os.path.join(pb, "limits", "riter80-train.json"),
                os.path.join(pb, "limits", "tiny-riter.json"))
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinyriter", "source": "tests",
                             "file": "portbench/configs/tinyriter.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": "tiny-riter", "config": "tinyriter",
                               "traffic": "tinyriter", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "riter80-train" in m.get("workloads", ()):
            m["workloads"].append("tiny-riter")
    benchcopy.write(path, bench)
    return dest


DRIVER = """
import sys
sys.path[:0] = [{copy!r}, {root!r}]
from portbench import faults_riter, harness
with faults_riter.planted({fault!r}):
    code = harness.main({argv!r}, device="cpu")
sys.exit(code)
"""


def dry_run(copy: str, seed: int = 2147483713, seconds: float = 0.5, trace: int = 0,
            fault=None, timeout: int = 600) -> subprocess.CompletedProcess:
    """The harness's run of `tiny-riter` in the copy on the CPU, in its own
    process, with `fault` planted."""
    argv = ["--workload", "tiny-riter", "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    code = DRIVER.format(copy=copy, root=benchcopy.ROOT, fault=fault, argv=argv)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                          text=True, timeout=timeout)
