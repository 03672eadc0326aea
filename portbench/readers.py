"""What the per-layer metric readers (`metrics/<name>.py`) share. Each
returns None where the run has nothing to read: another loop's cell, or a
run without the trace."""

from __future__ import annotations

from typing import Optional

from portbench import cost


def peak_flops(run) -> float:
    return cost.PEAK_FLOPS[run.cell.model.get("dtype", "float32")]


def per_unit_ms(run, loop: str, span: str, unit: str) -> Optional[float]:
    """Host ms of `span` in the window a `unit` (a step, a render)."""
    n = run.counts.get(unit)
    if run.loop_name != loop or not n or span not in run.spans:
        return None
    return run.spans[span] / n * 1e3


def idle_pct(run, loop: str) -> Optional[float]:
    t = run.trace_summary
    if run.loop_name != loop or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernels_roofline_pct(run, loop: str) -> Optional[float]:
    """Sum of the calls' bounds over the sum of their times, one unit's
    calls into the port's three ops."""
    calls = [c for c in run.kernel_calls if c["ms"] is not None]
    if run.loop_name != loop or not calls:
        return None
    return 100.0 * sum(c["bound_ms"] for c in calls) / sum(c["ms"] for c in calls)
