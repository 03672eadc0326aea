"""The program's own spans (`gea_torch.utils.trace`) in one cell, on the
card, at the cell's own sizes, in one process:

    python3 portbench/tools/program_spans.py --workload glis160-filter --seed 7 --seconds 30

Runs the cell's loop as `run.py --trace 1` does (set-up, the window, the
traced segment) with the program's tracer on for the window, and on with
profiler ranges for the traced segment. Prints one JSON line: the window's
rate with the tracer on, the harness's per-layer metrics of the run, the
program's span totals of the window (`program_spans`) and of the segment
(`segment_spans`), the segment's idle time by the innermost
`gea_torch.span::` range the host was in (`breakdown.program_idle_gaps`),
the readings that those give (`readings`), and the checks that they fit
inside the harness's own measures of the same layers (`consistent`). In
the training cell it then runs `DRAINED` more chunks, each after a
synchronise, so that the dispatcher's spans find the device's queue empty
and time its own host work alone (`drained`, ms a step).

The benchmark's own runs never run this: the harness turns no program
tracer on. Against a program without `gea_torch.utils.trace` every
reading is None.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import harness, tracing  # noqa: E402

RANGE_PREFIX = "gea_torch.span::"
NO_SPAN = "no program span"
DRAINED = 64  # chunks
Gap = Tuple[str, float, int]  # (span, seconds, gaps)


def program_tracer():
    """The program's tracer, or None where the program has none."""
    try:
        return importlib.import_module("gea_torch.utils.trace")
    except ImportError:
        return None


def program_gaps(events: Iterable[Tuple[str, bool, bool, float, float]]) -> List[Gap]:
    """The device's idle time inside the `portbench::segment` range, by the
    innermost program range the host was in: the idle gaps, merged as
    `tracing.summarize` merges them, are cut at every range's start and end,
    and each piece goes to the innermost range open over it (`NO_SPAN`
    outside them all). A gap counts once for each name it gives time to.
    (The harness names a whole gap by its middle; a gap between two
    requests then goes whole to one span.) `events` as `tracing._events`
    yields them."""
    device, spans, segment = [], [], None
    for name, dev, user, s, e in events:
        if dev and not user:
            device.append((s, e))
        elif not dev and name == tracing.SEGMENT:
            segment = (s, e)
        elif not dev and name.startswith(RANGE_PREFIX):
            spans.append((name[len(RANGE_PREFIX):], s, e))
    if segment is None:
        raise RuntimeError("the traced segment's range is missing from the trace")
    lo, hi = segment
    _, merged = tracing.union_length([(max(s, lo), min(e, hi)) for s, e in device
                                      if e > lo and s < hi])
    gaps, t = [], lo
    for s, e in merged + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    spans.sort(key=lambda r: r[1])
    starts = [s for _, s, _ in spans]
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    named: Dict[str, List[float]] = {}
    for gs, ge in gaps:
        edges = [gs, *cuts[bisect.bisect_right(cuts, gs):bisect.bisect_left(cuts, ge)], ge]
        seen = set()
        for a, b in zip(edges, edges[1:]):
            name = tracing.innermost(spans, starts, (a + b) / 2)
            name = NO_SPAN if name == "no harness span" else name
            acc = named.setdefault(name, [0.0, 0])
            acc[0] += b - a
            if name not in seen:
                seen.add(name)
                acc[1] += 1
    return [(n, s, int(k)) for n, (s, k) in named.items()]


def span_ms(totals: Dict, names: Tuple[str, ...], units: float) -> Optional[float]:
    """Host ms of the named spans together, a unit."""
    if not units or not all(n in totals for n in names):
        return None
    return sum(totals[n].seconds for n in names) / units * 1e3


def idle_in_pct(gaps: Optional[List[Gap]], name: str, window_s: float) -> Optional[float]:
    """Share of the traced segment idle while the host was in span `name`."""
    if gaps is None or window_s <= 0:
        return None
    return 100.0 * sum(s for n, s, _ in gaps if n == name) / window_s


def readings(run, totals: Dict, gaps: Optional[List[Gap]]) -> Dict[str, Optional[float]]:
    """The program's readings of the run, by the loop's kind: per unit of the
    window from the span totals, and shares of the segment from the gaps."""
    if run.loop_name == "filter":
        n = run.counts.get("requests")
        renders = totals["serve.render"].count if "serve.render" in totals else 0
        w = run.trace_summary.window_s if run.trace_summary else 0.0
        return {"draw_ms_per_request.filter": span_ms(totals, ("serve.draw",), n),
                "join_ms_per_request.filter": span_ms(totals, ("serve.join",), n),
                "stage_ms_per_render.filter": span_ms(
                    totals, ("serve.stage_in", "serve.stage_out"), renders),
                "idle_in_join_share.filter": idle_in_pct(gaps, "serve.join", w),
                "idle_in_draw_share.filter": idle_in_pct(gaps, "serve.draw", w)}
    if run.loop_name == "train":
        n = run.counts.get("steps")
        return {"noise_ms_per_step.train": span_ms(totals, ("dispatch.noise",), n),
                "replay_ms_per_step.train": span_ms(totals, ("dispatch.replay",), n)}
    return {}


def consistent(r: Dict, metrics: Dict) -> Dict[str, Optional[bool]]:
    """Each program reading within the harness's outside measure of its
    layer (None where either side is missing)."""
    m = {k: v["value"] for k, v in metrics.items()}

    def le(parts, whole):
        if whole not in m or any(r.get(p) is None for p in parts):
            return None
        return sum(r[p] for p in parts) <= m[whole]

    if "noise_ms_per_step.train" in r:
        return {"noise + replay <= dispatch_host": le(
            ("noise_ms_per_step.train", "replay_ms_per_step.train"),
            "dispatch_host_ms_per_step.train")}
    if "stage_ms_per_render.filter" in r:
        return {"stage <= enqueue": le(("stage_ms_per_render.filter",),
                                       "enqueue_ms_per_render.filter"),
                "idle in join + draw <= idle": le(
                    ("idle_in_join_share.filter", "idle_in_draw_share.filter"),
                    "idle_share.filter")}
    return {}


def drained_ms(loop, tr) -> Dict[str, float]:
    """The dispatcher's spans, ms a step, over `DRAINED` chunks that each
    start on an idle device: its input made, then a synchronise."""
    from portbench.loops import sync

    tr.reset()
    tr.enable(True)
    for _ in range(DRAINED):
        reals = [loop.input_fn(next(loop.data), loop.it + i) for i in range(loop.k)]
        sync(loop.run.device)
        loop.fn(loop.state, reals)
        loop.it += loop.k
    sync(loop.run.device)
    tr.enable(False)
    return {k: v.seconds / (DRAINED * loop.k) * 1e3 for k, v in sorted(tr.totals().items())}


def as_json(totals: Dict) -> Dict[str, List[float]]:
    return {k: [v.count, v.seconds, v.self_seconds] for k, v in sorted(totals.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    harness.set_cache_env()
    import torch

    cell = harness.find_cell(a.workload)
    run = harness.Run(cell=cell, seed=a.seed % 2 ** 63, seconds=a.seconds, trace=True,
                      device=torch.device(a.device))
    run.loop_name = cell.mix["loop"]
    mod = importlib.import_module(f"portbench.loops.{run.loop_name}")
    loop = mod.Loop(run)
    tr = program_tracer()
    loop.setup()
    window, segment, got = {}, {}, {}
    if tr is not None:
        tr.reset()
        tr.enable(True)
    loop.window()
    if tr is not None:
        window = tr.totals()
        tr.reset()
        tr.enable(True, ranges=True)
    summarize = mod.summarize

    def keep(prof, units):
        got["gaps"] = program_gaps(tracing._events(prof))
        return summarize(prof, units)

    mod.summarize = keep
    try:
        loop.traced_segment()
    finally:
        mod.summarize = summarize
        if tr is not None:
            segment = tr.totals()
            tr.enable(False)
    drained = drained_ms(loop, tr) if tr is not None and run.loop_name == "train" else {}
    info = harness.device_info(torch, run.device)
    loop.release()
    gaps = got.get("gaps") if tr is not None else None
    metrics = harness.read_metrics(run, cell.per_layer)
    r = readings(run, window, gaps)
    t = run.trace_summary
    out = {"workload": a.workload, "seed": a.seed, "device": info,
           "window": {"seconds": run.window_s, **run.end_to_end, **run.counts},
           "metrics": metrics, "readings": r, "consistent": consistent(r, metrics),
           "program_spans": as_json(window), "segment_spans": as_json(segment),
           "drained": drained,
           "segment": {"window_s": t.window_s, "busy_s": t.busy_s, "units": t.units},
           "breakdown": {**t.breakdown(), "program_idle_gaps": [
               [f"{n} ({k} gaps)", s] for n, s, k in sorted(gaps or [], key=lambda g: -g[1])]}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
