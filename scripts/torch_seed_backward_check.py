#!/usr/bin/env python3
"""The seed segment's backward kernels (`gea_torch::fused_seed_backward`)
against their plain version on one NVIDIA GPU, and where their time goes.

    python scripts/torch_seed_backward_check.py

Builds the CUDA kernels, then at small, ragged and flagship shapes, in fp32
and bf16, with every gradient, dz alone and the weights alone, prints each
gradient's largest |kernel - plain| over its largest |plain| and its mean
|kernel - plain| over its mean |plain|. At the G-LIS step's shape (256
stacked codes) and R-iterative's (64) it times the kernels and the plain
version (CUDA events, median of 10 after 3 warm-ups) and lists each kernel
of one call, one by one: its device time and its launches a call
(torch.profiler over 10 calls), beside the plan's list of launches
(`seed.backward_plan`). Two calls on the same inputs must agree bit for
bit. Exits non-zero if a gradient is not finite or strays beyond 1e-4
(fp32) or 2e-2 (bf16) of its largest value, or if two calls differ. Prints
what ptxas says of each kernel's registers and spills. About 30 s on an
H100.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gea_torch.ops import build  # noqa: E402
from gea_torch.ops import seed  # noqa: E402

NAMES = ("dz", "dwp", "dbp", "dslope", "dtrans", "dwc", "dbc")
NEEDS = {"all": (True,) * 7, "dz": (True,) + (False,) * 6, "weights": (False,) + (True,) * 6}
SHAPES = [  # (batch, code, s0, c0, c1)
    (8, 16, 5, 32, 16), (3, 8, 4, 16, 8), (5, 8, 7, 16, 24), (33, 40, 7, 256, 96),
    (7, 256, 5, 512, 512), (64, 256, 5, 512, 256), (256, 256, 5, 512, 256),
]
TIMED = {64, 256}  # batches timed


def make(batch, code, s0, c0, c1, dt, gen):
    def r(shape, scale, d=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", d)

    p = s0 * s0 * c0
    return (r((batch, code), 1.0, dt), r((code, p), code**-0.5, dt), r(p, 0.1),
            torch.rand(c0, generator=gen).cuda() * 0.5, r(c0, 0.1),
            r((4, 4, c0, c1), (16 * c0) ** -0.5, dt), r(c1, 0.1),
            r((batch, 2 * s0, 2 * s0, c1), 0.1, dt))


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # the stream busy while the host enqueues
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(x.elapsed_time(y) for x, y in pairs)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_seed_backward_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    build.build_all()
    for line in build.BUILD_LOGS.get("seed_bwd", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    bad = 0
    for shape in SHAPES:
        batch, code, s0, c0, c1 = shape
        for dt in (torch.float32, torch.bfloat16):
            if dt == torch.bfloat16 and (code % 8 or c0 % 8 or c1 % 8):
                continue
            args = make(*shape, dt, gen)
            limit = 2e-2 if dt == torch.bfloat16 else 1e-4
            for label, need in NEEDS.items():
                got = seed.fused_seed_backward(*args, s0, need)
                want = seed.fused_seed_backward_plain(*args, s0, need)
                errs = []
                for name, k, w in zip(NAMES, got, want):
                    if w is None:
                        continue
                    e = (k.float() - w.float()).abs()
                    rel = (e.max() / w.float().abs().max().clamp_min(1e-30)).item()
                    mean = (e.mean() / w.float().abs().mean().clamp_min(1e-30)).item()
                    ok = bool(torch.isfinite(k.float()).all()) and rel <= limit
                    bad += not ok
                    errs.append(f"{name} {rel:.2e}/{mean:.1e}{'' if ok else ' BAD'}")
                again = seed.fused_seed_backward(*args, s0, need)
                same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
                bad += not same
                print(f"{shape} {str(dt)[6:]} {label}: max/mean rel {', '.join(errs)}; "
                      f"two calls {'bit for bit' if same else 'DIFFER'}", flush=True)
            if batch in TIMED:
                k_ms = time_ms(lambda: seed.fused_seed_backward(*args, s0))
                p_ms = time_ms(lambda: seed.fused_seed_backward_plain(*args, s0))
                print(f"  every gradient: kernels {k_ms:.4f} ms, plain {p_ms:.4f} ms", flush=True)
                for label, need in NEEDS.items():
                    plan = seed.backward_plan(batch, code, s0, c0, c1, dt == torch.bfloat16,
                                              need, sms)
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            seed.fused_seed_backward(*args, s0, need)
                        torch.cuda.synchronize()
                    print(f"  {label}: plan {' '.join(plan.launches())} (D grid "
                          f"{plan.d_grid}, W grid {plan.w_grid}: {plan.n_wc} dWc, {plan.n_z} dz, "
                          f"{plan.n_wp} dwp items; dWc chunks {plan.wc_chunks})", flush=True)
                    for e in prof.key_averages():
                        if e.self_device_time_total > 0:
                            print(f"    {e.self_device_time_total / 1e3 / 10:.4f} ms "
                                  f"x{e.count / 10:g} a call  {e.key[:90]}", flush=True)
    print(f"{bad} gradients beyond their limit; {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
