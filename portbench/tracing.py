"""Host spans around the calls into each layer, and the reading of a
torch.profiler trace of the traced segment.

`Spans` sums host seconds by span name (`perf_counter`, always on, about
a microsecond a span). Inside a traced segment each span is also a
`record_function` range named `portbench::<name>`, so that the device's
idle gaps can be named by what the host was doing.

`TraceSummary` reads the profiler's events: the device's busy time (the
union of its kernels' and copies' intervals), the segment's length, device
time by kernel name, and the idle gaps, each named by the innermost harness
span open at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

SPAN_PREFIX = "portbench::"
SEGMENT = SPAN_PREFIX + "segment"
# Kernels of the port's three ops (`gea_torch/csrc/*.cu`, `ops/tprelu.py`).
PORT_KERNELS = ("seed_tap_gemm", "seed_f32_", "seed_bwd_", "lis_kernel", "lis_chain_",
                "tprelu_kernel", "tprelu_grad_")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


class Spans:
    """Host seconds and counts by span name; ranges for the profiler while
    `profiling` is set."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            from torch.profiler import record_function

            rf = record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1
            if rf is not None:
                rf.__exit__(None, None, None)

    def reset(self) -> None:
        self.seconds.clear()
        self.counts.clear()


Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> Tuple[float, List[Interval]]:
    """(total length, merged intervals) of [start, end) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # (kernel name, seconds), all of them
    port_s: float  # device seconds in the port's kernels
    idle_gaps: List[Tuple[str, float, int]] = field(default_factory=list)  # (span, s, gaps)
    units: float = 0.0  # steps or requests the segment ran

    @property
    def library_s(self) -> float:
        return sum(s for _, s in self.device_ops) - self.port_s

    def breakdown(self) -> Dict:
        ops = sorted(self.device_ops, key=lambda r: -r[1])[:10]
        gaps = sorted(self.idle_gaps, key=lambda r: -r[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[f"{n} ({k} gaps)", s] for n, s, k in gaps]}


def _events(prof) -> Iterable[Tuple[str, bool, bool, float, float]]:
    """(name, on the device, a user range, start s, end s) of each event."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            dev = e.device_type() == DeviceType.CUDA
            start = e.start_ns() / 1e9
            yield e.name(), dev, bool(e.is_user_annotation()), start, start + e.duration_ns() / 1e9
    except AttributeError:
        for e in prof.events():
            dev = e.device_type == DeviceType.CUDA
            yield (e.name, dev, bool(e.is_user_annotation), e.time_range.start / 1e6,
                   e.time_range.end / 1e6)


def innermost(spans, starts, t: float, depth: int = 64) -> str:
    """The name of the latest-started span (sorted by start) open at t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        name, s, e = spans[j]
        if s <= t < e:
            return name
    return "no harness span"


def summarize(prof, units: float) -> TraceSummary:
    """The segment is the `portbench::segment` range on the host; device
    work and gaps are taken inside it."""
    device, spans, segment = [], [], None
    for name, dev, user, s, e in _events(prof):
        if dev and not user:
            device.append((name, s, e))
        elif not dev and name.startswith(SPAN_PREFIX):
            if name == SEGMENT:
                segment = (s, e)
            else:
                spans.append((name[len(SPAN_PREFIX):], s, e))
    if segment is None:
        raise RuntimeError("the traced segment's range is missing from the trace")
    lo, hi = segment
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    busy, merged = union_length([(s, e) for _, s, e in inside])
    by_name: Dict[str, float] = {}
    port = 0.0
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        if is_port_kernel(n):
            port += e - s
    gaps, t = [], lo
    for s, e in merged + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    spans.sort(key=lambda r: r[1])
    starts = [s for _, s, _ in spans]
    named: Dict[str, List[float]] = {}
    for gs, ge in gaps:
        acc = named.setdefault(innermost(spans, starts, (gs + ge) / 2), [0.0, 0])
        acc[0] += ge - gs
        acc[1] += 1
    return TraceSummary(window_s=hi - lo, busy_s=busy, device_ops=list(by_name.items()),
                        port_s=port, idle_gaps=[(n, s, int(k)) for n, (s, k) in named.items()],
                        units=units)


@contextlib.contextmanager
def traced(spans: Spans, sync):
    """torch.profiler (host and device) over the block, which runs inside
    the `portbench::segment` range and ends with `sync()`; yields a list
    that receives the profiler once it has stopped."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: List = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    spans.profiling = True
    try:
        with record_function(SEGMENT):
            yield out
            sync()
    finally:
        spans.profiling = False
        prof.__exit__(None, None, None)
    out.append(prof)

