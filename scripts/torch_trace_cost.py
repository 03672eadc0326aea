"""The cost of one span of `gea_torch.utils.trace`, in ns, on this host:

    python3 scripts/torch_trace_cost.py [--spans 1000000]

Times `with trace.span("x"): pass` with the tracer off, on, and on with
ranges (with no profiler running, and under a CPU torch.profiler, whose
records it fills: a tenth of the spans there), each as the best of 5 runs
of `timeit` less the same loop around an empty `with`. Prints one JSON
line; where a card is visible, with its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gea_torch.utils import trace  # noqa: E402


class _Empty:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def per_span_ns(n: int, stmt: str, env: dict) -> float:
    return min(timeit.repeat(stmt, number=n, repeat=5, globals=env)) / n * 1e9


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "none"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spans", type=int, default=1_000_000)
    n = p.parse_args(argv).spans
    env = {"trace": trace, "empty": _Empty()}
    base = per_span_ns(n, "with empty: pass", env)
    stmt = "with trace.span('x'): pass"
    out = {"spans": n, "empty_with_ns": base}
    trace.enable(False)
    out["off_ns"] = per_span_ns(n, stmt, env) - base
    trace.enable(True)
    out["on_ns"] = per_span_ns(n, stmt, env) - base
    trace.enable(True, ranges=True)
    out["ranges_ns"] = per_span_ns(n, stmt, env) - base
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["ranges_profiled_ns"] = per_span_ns(n // 10, stmt, env) - base
    trace.enable(False)
    trace.reset()
    out["host"] = {"cpus": os.cpu_count(), "torch": torch.__version__, "card": card()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
