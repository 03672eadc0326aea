"""Host spans inside the program: the one span mechanism of `gea_torch`.

    from gea_torch.utils import trace

    with trace.span("serve.join"):
        ...

Off (the default), `span` is one check of a module flag and returns one
shared object that does nothing: no allocation, no clock read, no call into
torch. On (`enable(True)`), each span adds its `perf_counter_ns` duration,
its self time (the duration less what its child spans cover) and a count
to in-memory totals by name (`totals()`, `reset()`). With `ranges` as well,
each span is also a `torch.profiler.record_function` range named
`gea_torch.span::<name>`, so a profiler trace shows it on the clock of the
device's kernels, and an idle gap of the device can be named by the span the
host was in. The custom ops' own names (`gea_torch::<op>`) are left to them.

Spans nest by thread: a span's parent is the span open around it on its
thread.

Spans belong in host code only: never inside what `torch.cuda.graph`
captures or `torch.export` traces, where they would run once, at capture.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, NamedTuple, Tuple

RANGE_PREFIX = "gea_torch.span::"


class Total(NamedTuple):
    count: int
    seconds: float
    self_seconds: float


class _Off:
    """What `span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_record_function = None  # torch's record_function while ranges are on
_lock = threading.Lock()
_totals: Dict[str, list] = {}  # name -> [count, ns, self ns]
_local = threading.local()  # .stack: the open spans of the thread


class _Span:
    __slots__ = ("name", "t0", "child_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child_ns = 0
        self.range = None
        if _record_function is not None:
            self.range = _record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(None, None, None)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += ns - self.child_ns
        return False


def span(name: str):
    """A context manager timing the block as span `name` while the tracer
    is on."""
    if not _on:
        return _OFF
    return _Span(name)


def enable(on: bool = True, ranges: bool = False) -> Tuple[bool, bool]:
    """Turn the tracer on or off, with profiler ranges or without (ranges
    need it on). Returns the previous (on, ranges), to put back after."""
    global _on, _record_function
    was = (_on, _record_function is not None)
    if ranges and on:
        from torch.autograd.profiler import record_function

        _record_function = record_function
    else:
        _record_function = None
    _on = bool(on)
    return was


def totals() -> Dict[str, Total]:
    """{span name: (count, seconds, self seconds)} since the last reset."""
    with _lock:
        return {name: Total(c, ns / 1e9, self_ns / 1e9)
                for name, (c, ns, self_ns) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()

