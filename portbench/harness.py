"""The general harness: finds a cell's files by name, sets up the caches,
runs the cell's loop (set-up, window, traced segment, correctness check),
asks each per-layer metric's reader for its number and prints the result.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
harness reads `configs/<config>.json` and `mixes/<traffic>.json`; the mix
names its loop (`loops/<loop>.py`, a class `Loop`), and the cell's limits
are `limits/<workload>.json`. Per-layer metric `<name>` is read by
`metrics/<name>.py`'s `read(run)`, which returns a number or None. Adding a
cell, a configuration, a mix of an existing loop or a metric is adding
files and entries: nothing here names one.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gea")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot, against the uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_env(root: str = ROOT) -> None:
    """Every kernel and build cache at a fixed path inside the checkout,
    before torch or Triton is imported: Triton's, CUDA's and PyTorch's
    extension and inductor caches (the port's nvcc builds are under
    build/gea_torch_kernels/ already). No library loads JAX."""
    cache = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or `gea`'s, compared
    as whole names (`gea_torch` is not `gea`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    """A module from a file whose name may hold dots (`metrics/<metric>.py`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""

    name: str
    workload: Dict
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def model(self) -> Dict:
        return self.config["flags"]


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    base = os.path.join(root, "portbench")
    mix = load_json(os.path.join(base, "mixes", w["traffic"] + ".json"))
    limits_path = os.path.join(base, "limits", workload + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(workload, w, config, mix, limits,
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)])


@dataclass
class Run:
    """What one run knows: its cell, arguments and device, and what its
    loop measured, for the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    loop_name: str = ""
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counts: Dict[str, float] = field(default_factory=dict)  # steps, requests, ...
    spans: Dict[str, float] = field(default_factory=dict)  # host seconds by span
    end_to_end: Dict[str, float] = field(default_factory=dict)
    trace_summary: Optional[Any] = None  # tracing.TraceSummary of the traced segment
    kernel_calls: List[Dict] = field(default_factory=list)  # op, bound_ms, ms
    phases: List = field(default_factory=list)  # (set-up phase, seconds since the start)
    notes: List[str] = field(default_factory=list)  # what the loop saw, for stderr


def metric_reader(name: str):
    return load_file_module(os.path.join(HERE, "metrics", name + ".py"),
                            "portbench_metric_" + name.replace(".", "_"))


def read_metrics(run: Run, specs: List[Dict]) -> Dict[str, Dict]:
    """{name: {value, unit}} of each metric whose reader finds something."""
    out = {}
    for spec in specs:
        value = metric_reader(spec["name"]).read(run)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(torch, dev) -> Dict:
    return {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0}


def main(argv, device: Optional[str] = None) -> int:
    """Run the cell; `device="cpu"` is the tests' dry run at tiny sizes
    (its line says so), never the benchmark's."""
    args = parse_args(argv)
    set_cache_env()
    cell = find_cell(args.workload)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {chips} CUDA device(s) needed, {n} found", file=sys.stderr)
            return 2
        device = "cuda"
    torch.set_num_threads(min(4, torch.get_num_threads()))
    # Generators take seeds in [0, 2**63); any whole number maps there.
    run = Run(cell=cell, seed=args.seed % 2 ** 63, seconds=args.seconds, trace=bool(args.trace),
              device=torch.device(device))
    run.loop_name = cell.mix["loop"]
    loop = importlib.import_module(f"portbench.loops.{run.loop_name}").Loop(run)

    run.phases.append(("torch imported", process_age_s()))
    loop.setup()
    setup_s = process_age_s()
    loop.window()
    info = device_info(torch, run.device)
    if run.trace:
        loop.traced_segment()
        loop.time_kernel_calls()
    loop.release()
    numbers = loop.check()
    run.end_to_end["setup_s"] = setup_s
    if run.trace:
        metrics = read_metrics(run, cell.per_layer)
        info = {**info, "busy_s": run.trace_summary.busy_s,
                "window_s": run.trace_summary.window_s}
    else:
        metrics = {m["name"]: {"value": float(run.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in run.end_to_end}
    correct = all(n["value"] is not None and n["limit"] is not None and n["value"] <= n["limit"]
                  for n in numbers.values())
    # JSON has no infinity: a number that is not finite reads as null (and
    # is not correct); a metric that is not finite is left out.
    numbers = {k: {**n, "value": n["value"] if math.isfinite(n["value"] or 0.0) else None}
               for k, n in numbers.items()}
    metrics = {k: m for k, m in metrics.items() if math.isfinite(m["value"])}
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which no run may load", file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": info}
    if run.trace and run.trace_summary is not None:
        result["breakdown"] = run.trace_summary.breakdown()
    if device == "cpu":
        result["dry_run"] = "cpu"
    result["check"] = numbers
    for name, at in run.phases:
        print(f"portbench set-up: {name} at {at:.2f} s", file=sys.stderr)
    for note in run.notes:
        print(f"portbench {note}", file=sys.stderr)
    for name, n in numbers.items():
        print(f"portbench check {name} = {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(f"portbench correct = {bool(correct)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
