#!/usr/bin/env python3
"""Device time of the K = 8 graphed train steps of the PyTorch/CUDA port,
for comparing two checkouts of the repo on one card.

    python scripts/torch_graphed_steps.py [--root DIR] [--label NAME] [--out FILE]
        [--dtype bfloat16|float32] [--paths g-lis,r-iterative,...]

Imports `gea_torch` and `chip_smoke` from `--root` (default: this
checkout), builds the CUDA kernels there, and for each of five paths at
flagship width, batch 64, BCE, in bf16 or with `--dtype float32` in fp32
(`chip_smoke.graph_trainers()`: G-LIS, R-separate against a frozen G and D
(made in bf16: leave it out of an fp32 run), R-iterative at chain length
2; G-LIS with `--norm batch`, as phase 17 of `chip_smoke.py` builds it;
and the data-parallel G-LIS step at config 5, 160x160, on a world-1 NCCL
group, as phase 16 builds it; `--paths` picks some) captures a K = 8
`StepDispatcher` graph, then times REPLAYS replays with CUDA events
(device ms a step: the span of a replay over K), takes one replay under
torch.profiler (device busy ms a step; the time of kernels whose names
hold `tprelu_grad_`, TPReLU's backward kernels, `seed_bwd_`, the seed's,
`seed_tap_gemm` or `seed_f32_`, the seed's forward, and `lis_chain_` (or,
in a checkout from before the chain kernel, `lis_bwd_`), LIS's, with
LIS's backward launches a step) and
reads the graph pool's peak MB. Prints one JSON line per path and writes them all
to `--out`. Two checkouts are compared within one call, in turns (A, B,
B, A), each in its own process:

    python scripts/torch_graphed_steps.py --root parent --label parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPLAYS = 6


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--label", default="this checkout")
    p.add_argument("--out", default=None)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="the compute dtype of every path")
    p.add_argument("--paths", default="", help="paths to run, separated by ','")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_graphed_steps: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gea_torch.config import TrainGLISConfig
    from gea_torch.ops import build
    from gea_torch.train import build_glis_train_step
    from gea_torch.train.dispatch import StepDispatcher

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # as the train steps are timed in chip_smoke.py
    build.build_all()
    entries = {tag: (e[0], e[1], e[2], e[4]) for tag, e in cs.graph_trainers().items()}
    bn = TrainGLISConfig.from_args(cs.BN_ARGS)
    entries["g-lis batch norm"] = (bn.replace(steps_per_dispatch=cs.GRAPH_K), cs.bn_state,
                                   build_glis_train_step, cs.real_batch(bn))
    dp = cs.dp_world()
    dp_cfg = cs.dp_config().replace(steps_per_dispatch=cs.GRAPH_K)
    dp_params = cs.dp_params(dp_cfg)
    entries["dp config 5"] = (dp_cfg, lambda c: cs.create_glis_state(c, *dp_params),
                              lambda c: build_glis_train_step(c, dp=dp), cs.real_batch(dp_cfg))
    rows = []
    for tag, (cfg, make_state, build_step, real) in entries.items():
        if args.paths and tag not in args.paths.split(","):
            continue
        cfg = cfg.replace(dtype=args.dtype)
        k = cfg.steps_per_dispatch
        state, step = make_state(cfg), build_step(cfg)
        dispatch = StepDispatcher(cfg, step)
        reals = [real] * k
        t0 = time.perf_counter()
        dispatch(state, reals)  # warm-up, capture, first replay
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        spans = []
        for _ in range(REPLAYS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dispatch(state, reals)
            end.record()
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(end) / k)
        busy, kernels = cs.device_profile(lambda: dispatch(state, reals))
        grad_ms = sum(ms for name, ms, _ in kernels if "tprelu_grad_" in name)
        seed_ms = sum(ms for name, ms, _ in kernels if "seed_bwd_" in name)
        seed_fwd_ms = sum(ms for name, ms, _ in kernels
                          if "seed_tap_gemm" in name or "seed_f32_" in name
                          or "seed_kernel_f32" in name)
        lis = [(ms, n) for name, ms, n in kernels if "lis_bwd_" in name or "lis_chain_" in name]
        lis_ms = sum(ms for ms, _ in lis)
        row = {"label": args.label, "path": tag, "dtype": args.dtype, "k": k,
               "device_ms_per_step": statistics.median(spans), "spans_ms_per_step": spans,
               "busy_ms_per_step": busy / k, "tprelu_grad_ms_per_step": grad_ms / k,
               "seed_bwd_ms_per_step": seed_ms / k, "seed_fwd_ms_per_step": seed_fwd_ms / k,
               "lis_bwd_ms_per_step": lis_ms / k,
               "lis_bwd_launches_per_step": sum(n for _, n in lis) / k,
               "pool_peak_mb": dispatch.chunks[k].pool_peak_mb, "first_call_s": first_s,
               "card": smi, "torch": torch.__version__}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del state, step, dispatch
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
