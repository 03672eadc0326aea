#!/usr/bin/env python3
"""LIS's backward kernel (`csrc/lis_bwd.cu`: `gea_torch::lis_chain_backward`,
and `gea_torch::lis_residual_mlp_backward`, a chain of one) against its
plain version on one NVIDIA GPU, and where its time goes.

    python scripts/torch_lis_backward_check.py

Builds the CUDA kernels (printing what `nvcc -Xptxas -v` says of the
backward's registers, spills and shared memory) and the clusters of 8 and
16 the card holds at once. Then, in fp32 and bf16: chains of 1, 2 and 3
links at the flagship link (batch 64, code = hidden = 256), at batches 1,
17, 33 and 128, at hidden 512 (`lis_hidden_mult` 2) and at widths below one
tile, each with the need sets of `chip_smoke.lis_chain_needs` (G-LIS, batch
norm, R-separate, every gradient), and the flagship chain at the near-zero
case of `chip_smoke.lis_near_zero` on every link; each through
`chip_smoke.compare_lis_chain` (every gradient within LIS_BWD_TOL of its
max against the plain chain and, on the kernel's own cotangent, against
the plain link, there with dz, dw1 and dw2 within LIS_BWD_MEAN_TOL of their
mean; a second call equal bit for bit); the single-link op at the same
shapes through `chip_smoke.compare_lis_backward`. The plan's shared memory
(`lis.chain_smem_bytes`) must equal the kernel's (`Layout`). At the flagship
3-link chain, for each need set and for each cluster size and ring depth
that fits, it times the call and the plain version (`chip_smoke.time_ms`:
CUDA events, median of 20 after 3 warm-ups) beside the bound and an empty
launch, and lists each kernel of one G-LIS call with its device time and
launches (torch.profiler over 10 calls) beside the plan's list. Exits
non-zero if a gradient strays beyond its limit or two calls differ. About
60 s on an H100.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(64, 256, 256), (1, 256, 256), (17, 256, 256), (33, 256, 256), (128, 256, 256),
          (64, 256, 512), (30, 40, 48), (5, 16, 32)]  # batch, code, hidden
LINKS = (1, 2, 3)


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
        if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
            print(f"[build] {line.strip()}", flush=True)
    lib = lis._bwd_lib()
    for bf16 in (True, False):
        print(f"[plan] {'bf16' if bf16 else 'fp32'} clusters resident at once: "
              f"{dict(lis.resident_clusters(0, bf16))}", flush=True)
    gen = torch.Generator().manual_seed(0)
    floor_ms = cs.empty_launch_ms()
    bad = 0

    def check(label, dt, args, needs):
        nonlocal bad
        plan = lis.backward_plan(args[0][0].shape[0], args[0][0].shape[1], args[1][0].shape[1],
                                 dt == torch.bfloat16, needs, lis._sm_count(0),
                                 lis.resident_clusters(0, dt == torch.bfloat16))
        cluster, depth = plan.config
        c_bytes = lib.gea_lis_chain_smem_bytes(plan.code, plan.hidden, plan.links, cluster, depth,
                                               2 if plan.bf16 else 4)
        try:
            rel, mean, _, chain = cs.compare_lis_chain(label, dt, args, needs)
            ok = c_bytes == plan.smem_bytes
            msg = f"max rel {rel:.2e} (the chain {chain:.2e}), mean rel {mean:.2e}"
        except AssertionError as e:
            ok, msg = False, str(e)
        bad += not ok
        print(f"{label}: cluster {cluster} depth {depth} smem "
              f"{plan.smem_bytes} (kernel {c_bytes}), {plan.groups} row groups: {msg}"
              f"{'' if ok else ' BAD'}", flush=True)

    for batch, code, hidden in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for links in LINKS:
                args = cs.lis_chain_args(batch, code, hidden, links, dt, gen)
                for what, needs in cs.lis_chain_needs(links).items():
                    check(f"({batch}, {code}, {hidden}) x{links} {str(dt)[6:]} {what}", dt, args,
                          needs)
            one = cs.lis_backward_args(batch, code, hidden, dt, gen)
            for what, need in cs.LIS_NEEDS.items():
                try:
                    rel, mean, _ = cs.compare_lis_backward(f"one link {what}", dt, one, need)
                    msg = f"max rel {rel:.2e}, mean rel {mean:.2e}"
                except AssertionError as e:
                    bad += 1
                    msg = f"{e} BAD"
                print(f"({batch}, {code}, {hidden}) one link {str(dt)[6:]} {what}: {msg}",
                      flush=True)
    for dt in (torch.float32, torch.bfloat16):
        args, flips = cs.lis_chain_near_zero(cs.lis_chain_args(*SHAPES[0], 3, dt, gen))
        for what, needs in cs.lis_chain_needs(3).items():
            check(f"{SHAPES[0]} x3 {str(dt)[6:]} near zero ({flips} fp32 flips) {what}", dt, args,
                  needs)

    dt = torch.bfloat16
    args = cs.lis_chain_args(*SHAPES[0], 3, dt, gen)
    variants = [(c, d) for c in lis.CLUSTERS for d in lis.DEPTHS]
    clusters, depths = lis.CLUSTERS, lis.DEPTHS
    for what, needs in cs.lis_chain_needs(3).items():
        p_ms = cs.time_ms(lambda: lis.lis_chain_backward_plain(*args, needs))
        b_ms, b_by = cs.bound(*cs.lis_chain_cost(args, needs), dt)
        for c, d in variants:
            lis.CLUSTERS, lis.DEPTHS = (c,), (d,)
            plan = lis.backward_plan(64, 256, 256, True, needs, lis._sm_count(0),
                                     lis.resident_clusters(0, True))
            if plan.config is None:
                continue
            k_ms = cs.time_ms(lambda: lis.lis_chain_backward(*args, needs))
            print(f"[time] x3 bf16 {what}: cluster {c} depth {d}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), empty launch {floor_ms:.4f} ms",
                  flush=True)
        lis.CLUSTERS, lis.DEPTHS = clusters, depths
    needs = cs.lis_chain_needs(3)["G-LIS"]
    plan = lis.backward_plan(64, 256, 256, True, needs, lis._sm_count(0),
                             lis.resident_clusters(0, True))
    lis.lis_chain_backward(*args, needs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            lis.lis_chain_backward(*args, needs)
        torch.cuda.synchronize()
    print(f"[profile] one G-LIS call, plan {plan.config} launches {plan.launches()}:", flush=True)
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            print(f"[profile]   {e.self_device_time_total / 1e3 / 10:.4f} ms x{e.count / 10:g} "
                  f"a call {e.key[:90]}", flush=True)
    print(f"{bad} cases beyond their limits; {smi}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
