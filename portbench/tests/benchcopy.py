"""A copy of the benchmark with tiny cells added, for the CPU tests: the
same harness and loops at sizes a test run holds. `make_copy(dir)` copies
`portbench/` and `BENCHMARK.json` into `dir` and adds the configurations
`tiny` (train) and `tinysn` (spatial noise, filter), the mixes `tinytrain`
and `tinyfilter`, and the cells `tiny-train`, `tinysn-train` and
`tiny-filter`, which take the limits of the cells they stand for."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = dict(image_size=32, code_size=16, norm="weight", r_iterations=3, num_features=8,
            max_features=32, lis_hidden_mult=1, spatial_code=0, include_initial_image=True,
            dtype="float32", gan_loss="bce", lr=0.0002, beta1=0.5, beta2=0.999,
            stage_weight_initial=0.2, batch_size=4, g_ema=0.0, grad_accum=1, remat=False,
            lr_schedule="constant", num_devices=1)
STANDS_FOR = {"tiny-train": "glis80-train", "tinysn-train": "glis80-train",
              "tiny-filter": "glis160-filter"}


def write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_copy(dest: str) -> str:
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(dest, "portbench")
    write(os.path.join(pb, "configs", "tiny.json"), {"name": "tiny", "flags": TINY})
    write(os.path.join(pb, "configs", "tinysn.json"),
          {"name": "tinysn", "flags": dict(TINY, spatial_code=2)})
    with open(os.path.join(pb, "mixes", "train.json")) as f:
        train = json.load(f)
    train["flags"].update(steps_per_dispatch=2, log_interval=2)
    write(os.path.join(pb, "mixes", "tinytrain.json"), dict(train, trace_seconds=0.2))
    with open(os.path.join(pb, "mixes", "filter.json")) as f:
        filt = json.load(f)
    write(os.path.join(pb, "mixes", "tinyfilter.json"),
          dict(filt, count=4, oversample=2, batch_size=4, warm_requests=1, trace_seconds=0.2))
    for tiny, real in STANDS_FOR.items():
        src = os.path.join(pb, "limits", real + ".json")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(pb, "limits", tiny + ".json"))
    bench["configs"] += [
        {"name": "tiny", "source": "tests", "file": "portbench/configs/tiny.json",
         "reduced": [], "why": "tests"},
        {"name": "tinysn", "source": "tests", "file": "portbench/configs/tinysn.json",
         "reduced": [], "why": "tests"}]
    bench["workloads"] += [
        {"name": "tiny-train", "config": "tiny", "traffic": "tinytrain", "chips": 1,
         "why": "tests"},
        {"name": "tinysn-train", "config": "tinysn", "traffic": "tinytrain", "chips": 1,
         "why": "tests"},
        {"name": "tiny-filter", "config": "tinysn", "traffic": "tinyfilter", "chips": 1,
         "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for tiny, real in STANDS_FOR.items():
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    write(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


DRIVER = """
import sys
sys.path[:0] = [{copy!r}, {root!r}]
from portbench import faults, harness
with faults.planted({fault!r}, {loop!r}):
    code = harness.main({argv!r}, device="cpu")
sys.exit(code)
"""


def dry_run(copy: str, workload: str, seed: int = 2147483713, seconds: float = 0.5,
            trace: int = 0, fault=None, timeout: int = 600) -> subprocess.CompletedProcess:
    """The harness's run of `workload` in the copy on the CPU, in its own
    process, with `fault` planted (`portbench.faults`)."""
    loop = "train" if workload.endswith("train") else "filter"
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    code = DRIVER.format(copy=copy, root=ROOT, fault=fault, loop=loop, argv=argv)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                          text=True, timeout=timeout)


def last_json(stdout: str):
    lines = [ln for ln in stdout.strip().splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines else None
