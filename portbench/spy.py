"""A spy on the entries of the port's three ops, and the timing of each
call it saw.

Every forward and backward call of `gea_torch.ops.tprelu`, `.lis` and
`.seed` passes through one module-level function of its module (the
autograd Functions call them by name): `_forward` and `_backward`, and
LIS's `_chain_backward`. While a `Spy` is installed each such call is
recorded with copies of its arguments. `time_calls` then replays each
recorded call through the original entry and times it with CUDA events
(the stream held busy by a spin kernel while the host enqueues, so the
events time the device's work), and pairs it with its bound from
`portbench.cost`: the share reads the same work whatever kernel does it.
"""

from __future__ import annotations

import importlib
import statistics
from typing import Callable, Dict, List, Tuple

import torch

from portbench.cost.kernels import call_bound_ms

ENTRIES = (
    ("gea_torch.ops.tprelu", "_forward", "tprelu"),
    ("gea_torch.ops.tprelu", "_backward", "tprelu_backward"),
    ("gea_torch.ops.lis", "_forward", "lis"),
    ("gea_torch.ops.lis", "_chain_backward", "lis_chain_backward"),
    ("gea_torch.ops.seed", "_forward", "seed"),
    ("gea_torch.ops.seed", "_backward", "seed_backward"),
)
REPS, WARMUP = 20, 3
SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's clock: longer than any call's enqueue


def _copy(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copy(v) for v in x)
    return x


class Spy:
    """Records (op, entry, args) of every call while installed."""

    def __init__(self):
        self.calls: List[Tuple[str, Callable, tuple]] = []
        self._saved: List[Tuple[object, str, Callable]] = []

    def __enter__(self):
        for module, attr, op in ENTRIES:
            mod = importlib.import_module(module)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(op, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap(self, op: str, orig: Callable) -> Callable:
        def spied(*args):
            self.calls.append((op, orig, _copy(args)))
            return orig(*args)
        return spied


def time_ms(fn: Callable[[], object]) -> float:
    """Median device time of one call of fn over REPS calls, after WARMUP."""
    for _ in range(WARMUP):
        fn()
    pairs = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_calls(calls) -> List[Dict]:
    """[{op, bound_ms, by, ms}] of each recorded call (ms None off the card)."""
    out = []
    for op, entry, args in calls:
        b_ms, by = call_bound_ms(op, args)
        ms = None
        if torch.cuda.is_available() and _on_cuda(args):
            with torch.no_grad():
                ms = time_ms(lambda: entry(*args))
        out.append({"op": op, "bound_ms": b_ms, "by": by, "ms": ms})
    return out


def _on_cuda(args) -> bool:
    for a in args:
        if torch.is_tensor(a):
            return a.is_cuda
        if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
            return a[0].is_cuda
    return False
