#!/usr/bin/env python3
"""What bounds the seed's kernels (`gea_torch/csrc/seed_bwd.cu`, and in fp32
the product core `sgemm_f32.cuh` under the forward and the backward):
variants of the sources, each with one part taken out or changed, timed
beside the unchanged sources on one NVIDIA GPU.

    python scripts/torch_seed_backward_variants.py [--dtype bfloat16|float32] [VARIANT ...]

Each variant is a copy of `gea_torch/csrc/` with a few lines replaced
(`VARIANTS` below, by dtype; the unchanged sources are `source`). All are
built in parallel with the port's nvcc flags into
`build/seed_variants/<dtype>/v<i>/` and bound in place of the port's
libraries; ptxas's registers and spills of the fp32 kernels are printed.
Calls, in the dtype chosen:

* bf16 (the default): the backward with every gradient at the G-LIS step's
  shape (256 codes) and R-iterative's (64);
* fp32 (TF32 off; the variants change the core, `sgemm_f32.cuh`): the
  forward at the flagship G-LIS step's shape and at config 5's
  (`chip_smoke.cases`), the backward at the flagship with every gradient,
  dz alone and the weights alone, and at config 5 with every gradient.

For each variant and call: the call's device time (`chip_smoke.time_ms`),
its largest error over the plain version's largest value (left out for a
variant that computes something else by design), whether it equals the
unchanged sources bit for bit, and each kernel's device time a call
(torch.profiler over 10 calls). A variant whose lines are no longer in
its source stops the script: update its table with the source. About a
minute (bf16) or three (fp32) on an H100 with the builds.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gea_torch.ops import build, seed  # noqa: E402

OUT = os.path.join(ROOT, "build", "seed_variants")
SHAPES = [(256, 256, 5, 512, 256), (64, 256, 5, 512, 256)]  # bf16 (batch, code, s0, c0, c1)

CONVERSION = ("  lo = (double)__uint_as_float(v << 16);\n"
              "  hi = (double)__uint_as_float(v & 0xffff0000u);")
BWD, CORE = "seed_bwd.cu", "sgemm_f32.cuh"
# dtype -> name -> ([(file, lines of the source, what replaces them)],
# computes the same function[, the host plan's constants in
# gea_torch.ops.seed that change with them: the fp32 launches refuse
# shared bytes other than the kernel's]).
VARIANTS = {
    "bfloat16": {
        "source": ([], True),
        # The wgmma passes without their products: what the loads and the
        # epilogues take.
        "no products": ([(
            BWD,
            "    mma_step<MN>(acc, base + slot * kStage + c * kBox, base + slot * kStage + kTile);\n",
            "")], False),
        # ... and without their operand copies: what the products and the
        # epilogues take (the barriers complete without bytes).
        "no operand loads": ([
            (BWD, "        gea::mbar_expect_tx(&full[slot], bytes);\n"
                  "        issue<KIND>(p, maps, x, kt, base + slot * kStage, &full[slot]);\n",
             "        gea::mbar_arrive(&full[slot]);\n"),
            (BWD, "        gea::mbar_expect_tx(s_full, 4 * rows_d * 128);\n",
             "        gea::mbar_arrive(s_full);\n"),
            (BWD, "          gea::tma_load_2d(s_tile + q * kChunk, &maps.m[2], x.n0 + 32 * q, "
                  "x.m0 * p.area, s_full);\n", "          ;\n")], False),
        # The projection with bf16 bits moved into doubles unconverted: what
        # the conversions to fp64 take (the result is wrong).
        "no fp64 conversion": ([(
            BWD, CONVERSION,
            "  lo = __hiloint2double(v, 0);\n  hi = __hiloint2double(v & 0xffff0000u, 0);")],
            False),
        # The same conversion, exact, by integer operations (the fp32 bits'
        # exponent rebiased), with the converting instruction kept for zero
        # exponents with a mantissa and for infinities and NaNs.
        "integer fp64 conversion": ([(
            BWD, CONVERSION,
            "  const uint32_t e = v & 0x7f807f80u, m = v & 0x007f007fu;\n"
            "  if ((__vcmpeq2(e, 0x7f807f80u) | (__vcmpeq2(e, 0u) & __vcmpne2(m, 0u))) != 0u) {\n"
            "    lo = (double)__uint_as_float(v << 16);\n"
            "    hi = (double)__uint_as_float(v & 0xffff0000u);\n"
            "    return;\n"
            "  }\n"
            "  const uint32_t f0 = v << 16, f1 = v & 0xffff0000u;\n"
            "  const uint32_t a0 = f0 & 0x7fffffffu, a1 = f1 & 0x7fffffffu;\n"
            "  const uint32_t h0 = a0 ? (a0 >> 3) + 0x38000000u : 0u;\n"
            "  const uint32_t h1 = a1 ? (a1 >> 3) + 0x38000000u : 0u;\n"
            "  lo = __hiloint2double((int)((f0 & 0x80000000u) | h0), 0);\n"
            "  hi = __hiloint2double((int)((f1 & 0x80000000u) | h1), 0);")], True),
        # A shallower ring in the wgmma passes.
        "3 stages": ([(BWD, "constexpr int kStages = 4;", "constexpr int kStages = 3;")], True),
    },
    "float32": {
        "source": ([], True),
        "k-step 16, ring 4": ([(CORE, "kBN = 128, kBK = 32;", "kBN = 128, kBK = 16;"),
                               (CORE, "kStages = 2;", "kStages = 4;")], True,
                              {"F32_BK": 16, "F32_STAGES": 4}),
        "ring 3": ([(CORE, "kStages = 2;", "kStages = 3;")], True, {"F32_STAGES": 3}),
        "1 block an SM": ([(CORE, "kBlocksPerSM = 2;", "kBlocksPerSM = 1;")], True,
                          {"F32_BLOCKS_PER_SM": 1}),
        # The core's products on whatever the ring holds: what the FMAs take.
        "no operand copies": ([
            (CORE, "    if (s < steps) load(ring + s * kStage, s);\n", ""),
            (CORE, "    if (next < steps) load(ring + (next % kStages) * kStage, next);\n", "")],
            False),
        # 8 FMAs a k in place of 64: what the copies and loads take nearly alone.
        "an eighth of the FMAs": ([(CORE, "for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(",
                                    "for (int j = 0; j < 1; ++j) acc[i][j] = fmaf(")], False),
    },
}


def build_variants(dtype: str, names: list) -> dict:
    """{name: {library: path}}: each variant's copy of csrc/ built (the
    backward's library, and in fp32 the forward's) with the port's flags,
    all at once."""
    nvcc = build.nvcc_path()
    libs = ("seed", "seed_bwd") if dtype == "float32" else ("seed_bwd",)
    out, procs = {}, []
    for i, name in enumerate(names):
        d = os.path.join(OUT, dtype, f"v{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, os.path.join(d, "csrc"))
        for src, old, new in VARIANTS[dtype][name][0]:
            path = os.path.join(d, "csrc", src)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise SystemExit(f"variant {name!r}: its lines are no longer in {src}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for lib in libs:
            so = os.path.join(d, f"{lib}.so")
            cmd = [nvcc, *build.NVCC_FLAGS, "-o", so, os.path.join(d, "csrc", f"{lib}.cu")]
            procs.append((name, lib, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r}: {lib}.cu does not build:\n{log}")
        out.setdefault(name, {})[lib] = so
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "f32" in entry and "registers" in line:
                print(f"  [{name}] ptxas {entry[-40:]}: {line.split(':', 1)[1].strip()}",
                      flush=True)
    return out


def bind(path: str, like: ctypes.CDLL, fn: str) -> ctypes.CDLL:
    """The variant's library, its entry point typed as the port's."""
    lib = ctypes.CDLL(path)
    getattr(lib, fn).argtypes = getattr(like, fn).argtypes
    getattr(lib, fn).restype = ctypes.c_int
    lib.gea_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def calls(dtype: str) -> list:
    """(label, kernel call, plain call) in `dtype`."""
    out = []
    if dtype == "bfloat16":
        gen = torch.Generator().manual_seed(0)
        for batch, code, s0, c0, c1 in SHAPES:
            p = s0 * s0 * c0
            a = (cs.randn((batch, code), gen, 1.0, torch.bfloat16),
                 cs.randn((code, p), gen, code**-0.5, torch.bfloat16), cs.randn(p, gen, 0.1),
                 torch.rand(c0, generator=gen).cuda() * 0.5, cs.randn(c0, gen, 0.1),
                 cs.randn((4, 4, c0, c1), gen, (16 * c0) ** -0.5, torch.bfloat16),
                 cs.randn(c1, gen, 0.1),
                 cs.randn((batch, 2 * s0, 2 * s0, c1), gen, 0.1, torch.bfloat16), s0)
            out.append((f"backward, {batch} codes, every gradient",
                        lambda a=a: seed.fused_seed_backward(*a),
                        lambda a=a: seed.fused_seed_backward_plain(*a)))
        return out
    from gea_torch import FLAGSHIP

    for where, cfg in (("flagship", FLAGSHIP), ("config 5", cs.dp_config())):
        for name, _, _, per_step, make in cs.cases(cfg):
            if name == "fused_seed" and per_step:
                a, _, _ = make(torch.float32)
                out.append((f"{where} forward", lambda a=a: seed.fused_seed(*a),
                            lambda a=a: seed.fused_seed_plain(*a)))
        for _, per_step, make in cs.seed_backward_cases(cfg):
            if not per_step:
                continue
            a = make(torch.float32)
            needs = cs.SEED_NEEDS if where == "flagship" else {"every gradient": cs.ALL_GRADS}
            for what, need in needs.items():
                out.append((f"{where} backward, {what}",
                            lambda a=a, need=need: seed.fused_seed_backward(*a, need),
                            lambda a=a, need=need: seed.fused_seed_backward_plain(*a, need)))
    return out


def kernel_name(key: str) -> str:
    """`seed_bwd_gemm<1>` out of the profiler's demangled signature."""
    m = re.search(r"seed_\w+(<[^>]*>)?", key)
    return m.group(0) if m else key[:40]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", choices=list(VARIANTS), default="bfloat16")
    p.add_argument("variants", nargs="*")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_seed_backward_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    table = VARIANTS[args.dtype]
    names = args.variants or list(table)
    unknown = [n for n in names if n not in table]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(table)}")
    if "source" not in names:
        names = ["source", *names]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(f"{smi}; torch {torch.__version__}; {args.dtype}", flush=True)
    libs = build_variants(args.dtype, names)
    todo = calls(args.dtype)
    wants = [plain() for _, _, plain in todo]
    port = {"seed_bwd": (seed._bwd_lib(), "gea_seed_backward")}
    if args.dtype == "float32":
        port["seed"] = (seed._lib(), "gea_seed_forward")
    base = {k: getattr(seed, k) for k in ("F32_BK", "F32_STAGES", "F32_BLOCKS_PER_SM")}
    refs, times = {}, {}
    for name in names:
        consts = {**base, **(table[name][2] if len(table[name]) > 2 else {})}
        for k, v in consts.items():
            setattr(seed, k, v)
        seed.F32_RING_BYTES = (consts["F32_STAGES"] * 2 * consts["F32_BK"]
                               * (seed.F32_TILE[0] + 4) * 4)
        bound = {lib: bind(libs[name][lib], *port[lib]) for lib in port}
        seed._bwd_lib = lambda lib=bound["seed_bwd"]: lib
        if "seed" in bound:
            seed._lib = lambda lib=bound["seed"]: lib
        for (label, fn, _), want in zip(todo, wants):
            got = fn()
            torch.cuda.synchronize()
            got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
            rel = "-"
            if table[name][1]:
                rel = "%.2e" % max(((k.float() - w.float()).abs().max()
                                    / w.float().abs().max().clamp_min(1e-30)).item()
                                   for k, w in zip(got, want) if w is not None)
            ref = refs.setdefault(label, got)
            same = all(x is None or torch.equal(x, y) for x, y in zip(got, ref))
            ms = cs.time_ms(fn)
            times.setdefault(label, []).append(f"{name} {ms:.4f}")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            kernels = "; ".join(
                f"{kernel_name(e.key)} {e.self_device_time_total / 1e4:.4f}"
                for e in prof.key_averages() if e.self_device_time_total > 0)
            print(f"[{label}] {name}: call {ms:.4f} ms, max|err|/max {rel}, bit for bit with "
                  f"the source {same}; kernels (ms a call) {kernels}", flush=True)
    for label, row in times.items():
        print(f"[{label}] " + ", ".join(row), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
