"""Host-side breakdown of `ServingModel.stream` on one GPU, at flagship width
in bf16 (random weights from `gea_torch.interop`'s seeded initialisers):

    python scripts/torch_stream_depth.py

Prints, for 32 batches of 64 codes, images/s and the median host time of a
`dispatch` at depths 1, 2, 4, 8, 8, 4, 2, 1 (so each depth runs once with
the pinned-memory cache as the last run left it, and once after a deeper
run grew it); the same batches through synchronous `.cuda()`/`.cpu()`
calls without pinned buffers; the host time of enqueueing one render; and
torch.profiler's CPU table of one stream at depth 1 and 8, whose
`cudaHostAlloc` rows are the caching host allocator growing. Needs CUDA;
builds the kernels first.
"""

import os
import statistics
import subprocess
import sys
import time
from collections import deque

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gea_torch import FLAGSHIP, serve  # noqa: E402
from gea_torch.interop import (  # noqa: E402
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.ops import build  # noqa: E402

BATCHES, BATCH = 32, 64


def timed_stream(model, zs, depth: int) -> tuple:
    """stream's loop with its dispatch and retire timed: (images/s,
    median dispatch ms, total retire wait ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disp, wait, q = [], [], deque()

    def retire():
        t = time.perf_counter()
        serve._fetch(q.popleft())
        wait.append(time.perf_counter() - t)

    for z in zs:
        if len(q) >= depth:
            retire()
        t = time.perf_counter()
        q.append(model.dispatch(z))
        disp.append(time.perf_counter() - t)
    while q:
        retire()
    wall = time.perf_counter() - t0
    return BATCH * len(zs) / wall, statistics.median(disp) * 1e3, sum(wait) * 1e3


def sync_calls(model, zs) -> float:
    """images/s of synchronous renders with pageable copies."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for z in zs:
            out = model.exported(torch.from_numpy(z).cuda())
            {k: v.cpu().numpy() for k, v in out.items()}
    return BATCH * len(zs) / (time.perf_counter() - t0)


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    build.build_all()
    cfg = FLAGSHIP
    model = serve.ServingModel.from_modules(
        generator_from_jax_params(init_generator_params(cfg, 0), cfg),
        discriminator_from_jax_params(init_discriminator_params(cfg, 1), cfg))
    rng = np.random.default_rng(1)
    zs = [rng.standard_normal((BATCH, cfg.code_size)).astype(np.float32)
          for _ in range(BATCHES)]
    for _ in range(3):
        list(model.stream(iter(zs[:4]), depth=8))
    for depth in (1, 2, 4, 8, 8, 4, 2, 1):
        rate, dispatch_ms, wait_ms = timed_stream(model, zs, depth)
        print(f"depth {depth}: {rate:.1f} img/s, median dispatch {dispatch_ms:.3f} ms, total "
              f"wait {wait_ms:.1f} ms; {smi}", flush=True)
    print(f"synchronous .cuda()/.cpu() calls: "
          f"{[round(sync_calls(model, zs), 1) for _ in range(2)]} img/s; {smi}", flush=True)
    with torch.inference_mode():
        zt = torch.from_numpy(zs[0]).cuda()
        for sync_each in (True, False):
            torch.cuda.synchronize()
            times = []
            for _ in range(BATCHES):
                t = time.perf_counter()
                model.exported(zt)
                times.append(time.perf_counter() - t)
                if sync_each:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            print(f"render enqueue host ms (synchronize after each: {sync_each}): median "
                  f"{statistics.median(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; {smi}",
                  flush=True)
    from torch.profiler import ProfilerActivity, profile

    for depth in (1, 8):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            list(model.stream(iter(zs), depth=depth))
        print(f"--- depth {depth}, the outputs kept (list), CPU profile; {smi}")
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=14), flush=True)


if __name__ == "__main__":
    main()
