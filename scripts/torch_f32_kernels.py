#!/usr/bin/env python3
"""The fp32 instances of the port's kernels at the flagship fp32 G-LIS
step, on one NVIDIA GPU, for comparing two checkouts of the repo.

    python scripts/torch_f32_kernels.py [--root DIR] [--label NAME] [--out FILE]

Imports `gea_torch` and `chip_smoke` from `--root` (default: this checkout),
builds the CUDA kernels there and prints what ptxas says of the fp32 seed
kernels' registers and spills. Then, in fp32 with TF32 off, at every shape
of the flagship G-LIS step (`chip_smoke.cases`: 256 stacked codes for the
seed, batch 64 for LIS and TPReLU) and at config 5's seed (c0 = c1 = 512,
as phase 16 of `chip_smoke.py` builds it), for each kernel instance: the
seed forward and its backward (with every gradient, dz alone and the
weights alone), LIS's forward and its chain backward (3 links, G-LIS's need
sets), TPReLU's forward and backward: the kernel against its plain version
(chip_smoke's limits), the kernel's and the plain version's device time
(`chip_smoke.time_ms`), the bound (`chip_smoke.bound` at 67 TFLOP/s of fp32
or 3.35 TB/s), the launches a G-LIS step makes, and for the seed the fp32
library composite (cuBLAS SGEMM, eager TPReLU, cuDNN transposed conv, TF32
off; a yardstick the port never calls) and its backward under autograd.
The seed forward and backward are also checked at the edge shapes
(`EDGES`: ragged batches, a c1 that no tile divides, s0 4 and 7, the
tiny tests' widths), with two calls on the same inputs equal bit for bit.
LIS's forward runs at `LIS_CASES` on inputs seeded here (timed at the
flagship's widths, batches 1, 64, 128 and 256, beside its plain version and
bound), each with the sha256 of its output's bytes (`lis_digest`): two
checkouts whose kernels compute the same bits print the same digests.
Prints one JSON line per instance, the SM clock and power nvidia-smi reads
while the flagship's seed forward and backward run back to back (`[clock]`,
with the FFMA peak at that clock), then the instances of a step ranked by
launches x (ms - bound); exits non-zero if a check fails. The bounds are
those of `--root`'s `chip_smoke.py`. Two checkouts in
one call, in turns:

    python scripts/torch_f32_kernels.py --root build/parent --label parent

About 60 s on an H100 with the build.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

EDGES = [  # (batch, code, s0, c0, c1)
    (1, 16, 4, 8, 4), (3, 16, 5, 8, 4), (33, 40, 7, 256, 96), (100, 256, 5, 512, 136),
    (65, 256, 6, 128, 132), (9, 256, 5, 512, 512),
]
# (batch, code, hidden, timed): LIS's forward at the flagship's widths, then
# chip_smoke's edge shapes and a ring shallower than its chunks.
LIS_CASES = [
    (1, 256, 256, True), (64, 256, 256, True), (128, 256, 256, True), (256, 256, 256, True),
    (30, 40, 48, False), (17, 256, 256, False), (33, 256, 256, False), (64, 256, 512, False),
    (20, 1024, 1024, False),
]


def lis_digest(t) -> str:
    """sha256 of an fp32 tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


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


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--label", default="this checkout")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_f32_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from gea_torch import FLAGSHIP, ops
    from gea_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(f"{args.label}: {smi}; torch {torch.__version__}", flush=True)
    build.build_all()
    for src in ("lis", "seed", "seed_bwd"):
        entry = ""
        for line in build.BUILD_LOGS.get(src, "").splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "f32" in entry and ("registers" in line or "spill" in line):
                print(f"  ptxas {entry[:60]}: {line.strip()}", flush=True)
    dt = torch.float32
    rows = []

    def emit(row):
        row = {"label": args.label, "card": smi, **row}
        print(json.dumps(row), flush=True)
        rows.append(row)

    cfg = FLAGSHIP
    shape_sets = [("flagship", cs.cases(cfg)),
                  ("config 5", [c for c in cs.cases(cs.dp_config()) if c[0] == "fused_seed"
                                and c[3]])]
    for where, cases in shape_sets:
        for name, label, _, per_step, make in cases:
            a, nbytes, nops = make(dt)
            got = cs.KERNEL[name](*a)
            err = cs.compare(name, label, dt, got, cs.PLAIN[name](*a))
            row = {"where": where, "instance": name, "shape": label, "per_step": per_step,
                   "max_abs_err": err, "ms": cs.time_ms(lambda: cs.KERNEL[name](*a)),
                   "plain_ms": cs.time_ms(lambda: cs.PLAIN[name](*a))}
            if name == "lis_residual_mlp":
                row["sha256"] = lis_digest(got)
            row["bound_ms"], row["bound_by"] = cs.bound(nbytes, nops, dt)
            if name == "fused_seed":
                lib = list(a)
                lib[5] = a[5].permute(2, 3, 0, 1).contiguous()
                row["composite_ms"] = cs.time_ms(lambda: cs.seed_composite(*lib))
            emit(row)
            del a
    for label, per_step, make in cs.backward_cases(cfg):
        x, a, b, g = make(dt)
        err = cs.compare_backward(label, dt, (x, a, b, g, True))[0]
        row = {"where": "flagship", "instance": "fused_tprelu_backward", "shape": label,
               "per_step": per_step, "max_abs_err": err,
               "ms": cs.time_ms(lambda: ops.fused_tprelu_backward(x, a, b, g, True)),
               "plain_ms": cs.time_ms(lambda: ops.fused_tprelu_backward_plain(x, a, b, g, True))}
        row["bound_ms"], row["bound_by"] = cs.bound(*cs.backward_cost(x, True), dt)
        emit(row)
    links, hidden = cfg.r_iterations, cfg.code_size * cfg.lis_hidden_mult
    chain = cs.lis_chain_args(cs.BATCH, cfg.code_size, hidden, links, dt,
                              torch.Generator().manual_seed(5))
    needs = cs.lis_chain_needs(links)["G-LIS"]
    err = cs.compare_lis_chain("G-LIS chain", dt, chain, needs)[0]
    row = {"where": "flagship", "instance": "lis_chain_backward",
           "shape": f"{links} links ({cs.BATCH}, {cfg.code_size}) x ({cfg.code_size}, {hidden})",
           "per_step": 1, "max_abs_err": err,
           "ms": cs.time_ms(lambda: ops.lis_chain_backward(*chain, needs)),
           "plain_ms": cs.time_ms(lambda: ops.lis_chain_backward_plain(*chain, needs))}
    row["bound_ms"], row["bound_by"] = cs.bound(*cs.lis_chain_cost(chain, needs), dt)
    emit(row)
    seed_sets = [("flagship", cs.seed_backward_cases(cfg)),
                 ("config 5", [c for c in cs.seed_backward_cases(cs.dp_config()) if c[1]])]
    for where, cases in seed_sets:
        for label, per_step, make in cases:
            a = make(dt)
            for what, need in cs.SEED_NEEDS.items():
                rel = cs.compare_seed_backward(label, dt, a, need)[0]
                row = {"where": where, "instance": "fused_seed_backward", "shape": label,
                       "need": what, "per_step": per_step if need == cs.ALL_GRADS else 0,
                       "max_rel_err": rel,
                       "ms": cs.time_ms(lambda: ops.fused_seed_backward(*a, need)),
                       "plain_ms": cs.time_ms(lambda: ops.fused_seed_backward_plain(*a, need))}
                row["bound_ms"], row["bound_by"] = cs.bound(*cs.seed_backward_cost(a, need), dt)
                # (a checkout from before chip_smoke timed it: no composite)
                if need == cs.ALL_GRADS and hasattr(cs, "seed_composite_backward_ms"):
                    row["composite_ms"] = cs.seed_composite_backward_ms(a)
                emit(row)
            del a

    # LIS's forward at LIS_CASES, each on its own seeded inputs.
    bad = 0
    for batch, code, hidden, timed in LIS_CASES:
        gen = torch.Generator().manual_seed(batch * 7919 + code * 31 + hidden)
        a = (cs.randn((batch, code), gen), cs.randn((code, hidden), gen, code**-0.5),
             cs.randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
             cs.randn(hidden, gen, 0.1), cs.randn((hidden, code), gen, hidden**-0.5),
             cs.randn(code, gen, 0.1))
        label = f"LIS ({batch}, {code}) x ({code}, {hidden})"
        got = ops.lis_residual_mlp(*a)
        err = cs.compare("lis_residual_mlp", label, dt, got, ops.lis_residual_mlp_plain(*a))
        same = torch.equal(got, ops.lis_residual_mlp(*a))
        bad += not same
        row = {"where": "lis cases", "instance": "lis_residual_mlp", "shape": label,
               "per_step": 0, "max_abs_err": err, "sha256": lis_digest(got),
               "two_calls_equal": same}
        if timed:
            row["ms"] = cs.time_ms(lambda: ops.lis_residual_mlp(*a))
            row["plain_ms"] = cs.time_ms(lambda: ops.lis_residual_mlp_plain(*a))
            nbytes = 4 * (2 * batch * code + 2 * code * hidden + 3 * hidden + code)
            row["bound_ms"], row["bound_by"] = cs.bound(nbytes, 4 * batch * code * hidden, dt)
        emit(row)
        del a

    # The edges: forward and backward against plain, two calls bit for bit.
    gen = torch.Generator().manual_seed(9)
    for batch, code, s0, c0, c1 in EDGES:
        p = s0 * s0 * c0
        a = (cs.randn((batch, code), gen, 1.0), cs.randn((code, p), gen, code**-0.5),
             cs.randn(p, gen, 0.1), torch.rand(c0, generator=gen).cuda() * 0.5,
             cs.randn(c0, gen, 0.1), cs.randn((4, 4, c0, c1), gen, (16 * c0) ** -0.5),
             cs.randn(c1, gen, 0.1), s0)
        label = f"seed batch {batch} code {code} s0 {s0} c0 {c0} c1 {c1}"
        first = ops.fused_seed(*a)
        err = cs.compare("fused_seed", label, dt, first, ops.fused_seed_plain(*a))
        same = torch.equal(first, ops.fused_seed(*a))
        g = cs.randn((batch, 2 * s0, 2 * s0, c1), gen, 0.1)
        bwd = {}
        for what, need in cs.SEED_NEEDS.items():
            bwd[what] = cs.compare_seed_backward(label, dt, (*a[:7], g, s0), need)[0]
            one = ops.fused_seed_backward(*a[:7], g, s0, need)
            two = ops.fused_seed_backward(*a[:7], g, s0, need)
            same &= all(x is None or torch.equal(x, y) for x, y in zip(one, two))
        bad += not same
        print(f"[edge] {label}: forward max|err| {err:.3e}; backward max|err|/max "
              f"{json.dumps(bwd)}; two calls {'bit for bit' if same else 'DIFFER'}", flush=True)

    # The SM clock under the fp32 seed, back to back at the flagship: what
    # FFMA peak the card held, beside the 67 TFLOP/s the bound takes.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd = next(make(dt)[0] for name, _, _, per_step, make in cs.cases(cfg)
               if name == "fused_seed" and per_step)
    bwd = next(make(dt) for _, per_step, make in cs.seed_backward_cases(cfg) if per_step)
    for what, fn in (("seed forward", lambda: ops.fused_seed(*fwd)),
                     ("seed backward, every gradient", lambda: ops.fused_seed_backward(*bwd))):
        q = under_load(fn)
        mhz = [float(v) for v in re.findall(r"([0-9.]+) MHz", q)]
        peak = f"{sms * 128 * 2 * mhz[0] * 1e-6:.1f} TFLOP/s" if mhz else "not read"
        print(f"[clock] {what}: clocks.sm, clocks.max.sm, power.draw {q}; FFMA peak at that "
              f"clock {peak} ({sms} SMs x 128 lanes)", flush=True)
    del fwd, bwd

    step = [r for r in rows if r["where"] == "flagship" and r["per_step"]]
    for r in sorted(step, key=lambda r: -r["per_step"] * (r["ms"] - r["bound_ms"])):
        print(f"[step] {r['instance']:22s} {r['shape'][:48]:48s} x{r['per_step']} "
              f"{r['per_step'] * r['ms']:.4f} ms a step, bound {r['per_step'] * r['bound_ms']:.4f}"
              f", over it {r['per_step'] * (r['ms'] - r['bound_ms']):.4f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(f"{args.label}: {bad} LIS cases and edge shapes whose two calls differ; {smi}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
