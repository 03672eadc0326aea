#!/usr/bin/env python3
"""The LIS link's backward kernel (`gea_torch::lis_residual_mlp_backward`)
against its plain version on one NVIDIA GPU, and its time alone.

    python scripts/torch_lis_backward_check.py

Builds the CUDA kernels (printing what `nvcc -Xptxas -v` says of the
backward's), then at the flagship link (batch 64, code = hidden = 256), at
batches 1, 17, 33 and 128, at hidden 512 (`lis_hidden_mult` 2), at widths
below one tile and at the near-zero case of `chip_smoke.lis_near_zero`, in
fp32 and bf16, with every gradient, dz alone and the weights alone, prints
each gradient's largest |kernel - plain| over its largest |plain| and its
mean |kernel - plain| over its mean |plain|, held to `chip_smoke.py`'s
LIS_BWD_TOL and (dz, dw1, dw2) LIS_BWD_MEAN_TOL. At the flagship link it
times the kernel and the plain version (`chip_smoke.time_ms`: CUDA events,
median of 20 after 3 warm-ups) beside the bound and an empty launch, and
lists the device kernels of one call (torch.profiler). Exits non-zero if a
gradient is not finite or strays beyond its limit. About 30 s on an H100.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(64, 256, 256), (1, 256, 256), (17, 256, 256), (33, 256, 256), (128, 256, 256),
          (64, 256, 512), (30, 40, 48), (5, 16, 32)]  # batch, code, hidden


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lis_backward_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gea_torch.ops import build, lis
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    build.build_all()
    for line in build.BUILD_LOGS.get("lis_bwd", "").splitlines():
        if any(w in line for w in ("registers", "spill", "smem")):
            print(f"[build] {line.strip()}", flush=True)
    gen = torch.Generator().manual_seed(0)
    floor_ms = cs.empty_launch_ms()
    bad = 0
    cases = [(shape, False) for shape in SHAPES] + [(SHAPES[0], True)]
    for (batch, code, hidden), near_zero in cases:
        for dt in (torch.float32, torch.bfloat16):
            args = cs.lis_backward_args(batch, code, hidden, dt, gen)
            label = f"({batch}, {code}, {hidden}) {str(dt)[6:]}"
            if near_zero:
                args, flips = cs.lis_near_zero(args)
                label += f" near zero ({flips} fp32 flips)"
            for what, need in cs.LIS_NEEDS.items():
                got = lis.lis_residual_mlp_backward(*args, need)
                want = lis.lis_residual_mlp_backward_plain(*args, need)
                errs = []
                for name, (rel, mean, _) in cs.grad_errors(got, want, cs.LIS_GRADS).items():
                    k = got[cs.LIS_GRADS.index(name)]
                    ok = (bool(torch.isfinite(k.float()).all()) and rel <= cs.LIS_BWD_TOL[dt]
                          and (name not in cs.LIS_MEAN_CHECKED or mean <= cs.LIS_BWD_MEAN_TOL[dt]))
                    bad += not ok
                    errs.append(f"{name} {rel:.2e}/{mean:.1e}{'' if ok else ' BAD'}")
                print(f"{label} {what}: max/mean rel {', '.join(errs)}", flush=True)
            if (batch, code, hidden) == SHAPES[0] and not near_zero:
                for what, need in cs.LIS_NEEDS.items():
                    k_ms = cs.time_ms(lambda: lis.lis_residual_mlp_backward(*args, need))
                    p_ms = cs.time_ms(lambda: lis.lis_residual_mlp_backward_plain(*args, need))
                    b_ms, b_by = cs.bound(*cs.lis_backward_cost(args, need), dt)
                    print(f"  {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                          f"{b_ms:.4f} ms ({b_by}), empty launch {floor_ms:.4f} ms", flush=True)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    lis.lis_residual_mlp_backward(*args)
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    if e.self_device_time_total > 0:
                        print(f"    {e.self_device_time_total / 1e3:.4f} ms x{e.count} {e.key[:90]}",
                              flush=True)
    print(f"{bad} gradients beyond their limit; {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
