#!/usr/bin/env python3
"""Device time of each of the port's kernels beside its plain version, one
call at a time, on one NVIDIA GPU, for comparing two checkouts of the repo.

    python scripts/torch_kernel_times.py [--root DIR] [--label NAME] [--out FILE]

Imports `gea_torch` (and `portbench`) from `--root` (default: this
checkout) and the kernel cases from this checkout's
`tests/torch_port_card_cases.py`, builds the CUDA kernels and prints what
ptxas says of each entry's registers and spills. Then, in bf16 and in fp32
(TF32 off), at the shapes of the benchmark's cells: every kernel case of
the 80x80 G-LIS train step (with the R-iterative step's seed and R's head
activation), of the 160x160 spatial-noise step and of the 160x160 filtered
render of 512 codes (the final stage alone); TPReLU's backward, the seed's backward (every
gradient, dz alone and the weights alone) and LIS's chain backward (the
G-LIS, batch-norm and R-separate need sets) at the train steps' shapes.
For each: the kernel's and the plain version's median device time
(`portbench.spy.time_ms`: CUDA events behind a spin, median of 20 calls),
the empty launch under the same timer, the bound
(`portbench.cost.kernels.call_bound_ms`), the launches a step makes, and
for LIS's fp32 forward the sha256 of its output (two checkouts whose
kernels compute the same bits print the same digest). Prints one JSON line
a row, the SM clock and power while the flagship's fp32 seed forward and
backward run back to back (`[clock]`), and each train step's rows ranked by
launches x (ms - bound); appends the rows to `--out`. The card modules
(`tests/test_torch_port_*_card.py`) check the kernels; this script only
times them. Two checkouts in one call, in turns:

    python scripts/torch_kernel_times.py --root build/parent --label parent

About 90 s on an H100 with the build.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COST_OP = {"fused_tprelu": "tprelu", "lis_residual_mlp": "lis", "fused_seed": "seed"}


def under_load(fn, seconds: float = 4.0) -> str:
    """nvidia-smi's SM clock, its maximum and the power drawn, read half way
    through `seconds` of `fn` called back to back."""
    import torch

    got = {}

    def query():
        time.sleep(seconds / 2)
        got["q"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()

    t = threading.Thread(target=query)
    t.start()
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        fn()
    t.join()
    torch.cuda.synchronize()
    return got.get("q", "")


def timed(kernel, plain, op: str, op_args) -> dict:
    """The median device time of `kernel()` and of `plain()`
    (`portbench.spy.time_ms`) and the bound of the call
    (`portbench.cost.kernels.call_bound_ms(op, op_args)`)."""
    from portbench.cost.kernels import call_bound_ms
    from portbench.spy import time_ms

    bound_ms, bound_by = call_bound_ms(op, op_args)
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by}


def calls(cfg, batch: int, render: int, dt):
    """Each kernel call of `cfg`'s train step (or, where `render` is
    not 0, of a render of `render` stages, which runs no backward) at
    `batch`: (kernel, shape label, launches a step or render, kernel(),
    plain(), `portbench.cost` op, its arguments, extra fields). Needs
    `tests/` on sys.path."""
    import torch
    import torch_port_card_cases as cc

    from gea_torch import ops

    for name, label, per_render, per_step, make in cc.cases(cfg, batch, render):
        if render and not per_render:
            continue
        a = make(dt)
        extra = {}
        if name == "lis_residual_mlp" and dt == torch.float32:
            extra["sha256"] = cc.digest(cc.KERNEL[name](*a))
        yield (name, label, per_render if render else per_step,
               lambda a=a, f=cc.KERNEL[name]: f(*a), lambda a=a, f=cc.PLAIN[name]: f(*a),
               COST_OP[name], a, extra)
    if render:
        return
    for label, per_step, make in cc.backward_cases(cfg, batch):
        bwd = (*make(dt), True)
        yield ("fused_tprelu_backward", label, per_step,
               lambda bwd=bwd: ops.fused_tprelu_backward(*bwd),
               lambda bwd=bwd: ops.fused_tprelu_backward_plain(*bwd), "tprelu_backward", bwd, {})
    for label, per_step, make in cc.seed_backward_cases(cfg, batch):
        a = make(dt)
        for what, need in cc.SEED_NEEDS.items():
            yield ("fused_seed_backward", label, per_step if need == cc.ALL_GRADS else 0,
                   lambda a=a, need=need: ops.fused_seed_backward(*a, need),
                   lambda a=a, need=need: ops.fused_seed_backward_plain(*a, need),
                   "seed_backward", (*a, need), {"need": what})
    links, hidden = cfg.r_iterations, cfg.code_size * cfg.lis_hidden_mult
    chain = cc.lis_chain_args(batch, cfg.code_size, hidden, links, dt,
                              torch.Generator().manual_seed(5))
    for what, needs in list(cc.lis_chain_needs(links).items())[:3]:
        yield ("lis_chain_backward", f"{links} links ({batch}, {cfg.code_size}) x "
               f"({cfg.code_size}, {hidden})", int(what == "G-LIS"),
               lambda needs=needs: ops.lis_chain_backward(*chain, needs),
               lambda needs=needs: ops.lis_chain_backward_plain(*chain, needs),
               "lis_chain_backward", (*chain, needs), {"need": what})


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--label", default="this checkout")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), os.path.join(HERE, "tests")]
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import torch_port_card_cases as cc
    from gea_torch import FLAGSHIP, ops
    from gea_torch.ops import build
    from portbench.spy import time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cc.nvidia_smi()
    print(f"{args.label}: {smi}; torch {torch.__version__}", flush=True)
    build.build_all()
    for src, log in build.BUILD_LOGS.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {src} {entry[:60]}: {line.strip()}", flush=True)
    empty_ms = time_ms(lambda: torch.cuda._sleep(0))
    rows = []
    cfg160 = FLAGSHIP.replace(image_size=160, spatial_code=4)
    # (where, config, batch, stages of a render: 0 for a train step's shapes)
    shape_sets = [("glis80 train", FLAGSHIP, cc.BATCH, 0),
                  ("glis160 train", cfg160, cc.BATCH, 0),
                  ("glis160 filter render", cfg160, 512, 1)]
    for dt in (torch.bfloat16, torch.float32):
        for where, cfg, batch, render in shape_sets:
            for instance, label, per, kernel, plain, op, op_args, extra in calls(
                    cfg, batch, render, dt):
                row = {"label": args.label, "card": smi, "where": where, "instance": instance,
                       "shape": label, "dtype": str(dt)[6:], "per_step": per,
                       **timed(kernel, plain, op, op_args), "empty_launch_ms": empty_ms, **extra}
                print(json.dumps(row), flush=True)
                rows.append(row)

    # The SM clock under the fp32 seed, back to back at the flagship: what
    # FFMA peak the card held, beside the 67 TFLOP/s the bound takes.
    dt = torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd = next(make(dt) for name, _, _, per_step, make in cc.cases(FLAGSHIP)
               if name == "fused_seed" and per_step)
    bwd = next(make(dt) for _, per_step, make in cc.seed_backward_cases(FLAGSHIP) if per_step)
    for what, fn in (("seed forward", lambda: ops.fused_seed(*fwd)),
                     ("seed backward, every gradient", lambda: ops.fused_seed_backward(*bwd))):
        q = under_load(fn)
        mhz = [float(v) for v in re.findall(r"([0-9.]+) MHz", q)]
        peak = f"{sms * 128 * 2 * mhz[0] * 1e-6:.1f} TFLOP/s" if mhz else "not read"
        print(f"[clock] fp32 {what}: clocks.sm, clocks.max.sm, power.draw {q}; FFMA peak at "
              f"that clock {peak} ({sms} SMs x 128 lanes)", flush=True)
    del fwd, bwd

    for where in ("glis80 train", "glis160 train"):
        for dtype in ("bfloat16", "float32"):
            step = [r for r in rows if r["where"] == where and r["dtype"] == dtype
                    and r["per_step"]]
            for r in sorted(step, key=lambda r: -r["per_step"] * (r["ms"] - r["bound_ms"])):
                print(f"[step] {where} {dtype} {r['instance']:22s} {r['shape'][:44]:44s} "
                      f"x{r['per_step']} {r['per_step'] * r['ms']:.4f} ms a step, bound "
                      f"{r['per_step'] * r['bound_ms']:.4f}, over it "
                      f"{r['per_step'] * (r['ms'] - r['bound_ms']):.4f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"{args.label}: {len(rows)} rows; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
