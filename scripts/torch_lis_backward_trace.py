#!/usr/bin/env python3
"""Where the LIS chain backward's time goes, phase by phase, on one NVIDIA
GPU.

    python scripts/torch_lis_backward_trace.py

Builds `gea_torch/csrc/lis_bwd.cu` with -DLIS_TRACE into
`build/lis_trace/` (the kernel then records the SM clock of block 0 of each
row group's cluster at its phase boundaries; `kTraceSlots` in the source)
and runs the flagship chain (3 links, batch 64, code = hidden = 256, bf16)
through `gea_torch.ops.lis`'s own wrapper with that build swapped in, for
the need sets of `lis_chain_needs` (G-LIS, batch norm, R-separate; the
cases of `tests/torch_port_card_cases.py`). Prints, per phase, the median
over 20 calls and the row groups of its SM cycles and its microseconds at
the SM clock (the spin kernel's, `cycles_per_ms`), the call's device time
(CUDA events) behind a spin, as `portbench.spy.time_ms` times it, and the
time a call over 20 calls back to back (the host's enqueue of a call where
that is longer). The traced build's times are the source's: the marks are
one store of one thread between barriers. About 30 s on an H100.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch_port_card_cases as cc  # noqa: E402

from gea_torch.ops import build, lis  # noqa: E402
from portbench.spy import time_ms  # noqa: E402

CALLS = 20
PHASES = ("operands landed", "A: dh, dh_pre", "T(dh_pre) exchange; pre, dW2",
          "B: dz, G", "G exchange; dW1, copies")


def traced_lib() -> ctypes.CDLL:
    out = build.BUILD_DIR.parent / "lis_trace"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "lis_bwd_trace.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-DLIS_TRACE", "-o", str(so),
           str(build.CSRC / "lis_bwd.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if any(w in line for w in ("registers", "spill")):
            print(f"[build] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.gea_lis_chain_backward.restype = ctypes.c_int
    lib.gea_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gea_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Traced:
    """`lis._bwd_lib()`'s stand-in: the traced build, each call's pointers
    followed by the trace buffer."""

    def __init__(self, base, lib, trace):
        self.base, self.lib, self.trace = base, lib, trace
        self.gea_cuda_error_string = lib.gea_cuda_error_string

    def gea_lis_chain_backward(self, ptrs, dims, stream):
        ext = (ctypes.c_uint64 * (len(ptrs) + 1))(*ptrs, self.trace.data_ptr())
        return self.lib.gea_lis_chain_backward(ext, dims, ctypes.c_void_p(stream))

    def __getattr__(self, name):
        return getattr(self.base, name)


def cycles_per_ms() -> float:
    """The spin kernel's clock, from CUDA events around one long spin."""
    cycles = 50_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lis_backward_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = cc.nvidia_smi()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    base = lis._bwd_lib()
    lib = traced_lib()
    per_us = cycles_per_ms() / 1e3
    links, dt = 3, torch.bfloat16
    args = cc.lis_chain_args(64, 256, 256, links, dt, torch.Generator().manual_seed(0))
    slots = 3 + 5 * 8  # kTraceSlots
    for what, needs in list(cc.lis_chain_needs(links).items())[:3]:
        plan = lis.backward_plan(64, 256, 256, True, needs, lis._sm_count(0),
                                 lis.resident_clusters(0, True))
        trace = torch.zeros((plan.groups, slots), dtype=torch.int64, device="cuda")
        lis._bwd_lib = lambda: Traced(base, lib, trace)
        try:
            ms = time_ms(lambda: lis.lis_chain_backward(*args, needs))
            # Back to back, with no spin to cover the host's enqueue: the
            # host time of a call, where that is the longer.
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(CALLS):
                lis.lis_chain_backward(*args, needs)
            end.record()
            torch.cuda.synchronize()
            b2b = start.elapsed_time(end) / CALLS
            rows = []
            for _ in range(CALLS):
                trace.zero_()
                lis.lis_chain_backward(*args, needs)
                torch.cuda.synchronize()
                rows += trace.cpu().tolist()
        finally:
            lis._bwd_lib = lambda: base
        walked = links - plan.first
        marks = [0, 1, 2] + [3 + 5 * w + i for w in range(walked) for i in range(5)]
        names = ["first operands", "prologue (pre of the last link)"] + [
            f"link {links - 1 - w}: {p}" for w in range(walked) for p in PHASES]
        print(f"[trace] {what}: plan {plan.config}, {plan.groups} row groups, one call "
              f"{ms:.4f} ms (CUDA events; {b2b:.4f} ms a call back to back); SM clock "
              f"{per_us:.0f} cycles/us", flush=True)
        total = []
        for name, a, b in zip(names, marks, marks[1:]):
            cyc = statistics.median(r[b] - r[a] for r in rows)
            total.append(cyc)
            print(f"[trace]   {name:36s} {cyc:8.0f} cycles {cyc / per_us:8.3f} us", flush=True)
        print(f"[trace]   start to end of the walk {sum(total):8.0f} cycles "
              f"{sum(total) / per_us:8.3f} us", flush=True)
        inner = [1, slots - 3, slots - 2, slots - 1, 2]  # within the prologue
        for name, a, b in zip(("P items landed", "their pre, db2", "next copies issued",
                               "the first G exchanged"), inner, inner[1:]):
            cyc = statistics.median(r[b] - r[a] for r in rows)
            print(f"[trace]     prologue: {name:24s} {cyc:8.0f} cycles", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
