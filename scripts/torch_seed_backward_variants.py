#!/usr/bin/env python3
"""What bounds the seed backward's kernels (`gea_torch/csrc/seed_bwd.cu`):
variants of the source, each with one part taken out or changed, timed
beside the unchanged source on one NVIDIA GPU.

    python scripts/torch_seed_backward_variants.py [VARIANT ...]

Each variant is the source with a few lines replaced (`VARIANTS` below;
the unchanged source is `source`). All are built in parallel with the
port's nvcc flags into `build/seed_bwd_variants/` and bound in place of the
port's library. Then, at the G-LIS step's shape (256 codes) and
R-iterative's (64), in bf16 with every gradient, each prints the call's time
(CUDA events, median of 10 after 3 warm-ups), its largest error over the
plain version's largest value, whether it equals the unchanged source bit
for bit (a variant that removes work does not, by design), and each kernel's
device time a call (torch.profiler over 10 calls). A variant that no longer
finds its lines in the source stops the script. About 40 s on an H100.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gea_torch.ops import build, seed  # noqa: E402

SOURCE = os.path.join(ROOT, "gea_torch", "csrc", "seed_bwd.cu")
OUT = os.path.join(ROOT, "build", "seed_bwd_variants")
SHAPES = [(256, 256, 5, 512, 256), (64, 256, 5, 512, 256)]  # (batch, code, s0, c0, c1)

CONVERSION = ("  lo = (double)__uint_as_float(v << 16);\n"
              "  hi = (double)__uint_as_float(v & 0xffff0000u);")
# name: [(lines of the source, what replaces them)]
VARIANTS = {
    "source": [],
    # The wgmma passes without their products: what the loads and the
    # epilogues take.
    "no products": [(
        "    mma_step<MN>(acc, base + slot * kStage + c * kBox, base + slot * kStage + kTile);\n",
        "")],
    # ... and without their operand copies: what the products and the
    # epilogues take (the barriers complete without bytes).
    "no operand loads": [
        ("        gea::mbar_expect_tx(&full[slot], bytes);\n"
         "        issue<KIND>(p, maps, x, kt, base + slot * kStage, &full[slot]);\n",
         "        gea::mbar_arrive(&full[slot]);\n"),
        ("        gea::mbar_expect_tx(s_full, 4 * rows_d * 128);\n",
         "        gea::mbar_arrive(s_full);\n"),
        ("          gea::tma_load_2d(s_tile + q * kChunk, &maps.m[2], x.n0 + 32 * q, "
         "x.m0 * p.area, s_full);\n", "          ;\n")],
    # The projection with bf16 bits moved into doubles unconverted: what the
    # conversions to fp64 take (the result is wrong).
    "no fp64 conversion": [(
        CONVERSION,
        "  lo = __hiloint2double(v, 0);\n  hi = __hiloint2double(v & 0xffff0000u, 0);")],
    # The same conversion, exact, by integer operations (the fp32 bits'
    # exponent rebiased), with the converting instruction kept for zero
    # exponents with a mantissa and for infinities and NaNs.
    "integer fp64 conversion": [(
        CONVERSION,
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
        "  hi = __hiloint2double((int)((f1 & 0x80000000u) | h1), 0);")],
    # A shallower ring in the wgmma passes.
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
}


def variant_source(name: str, text: str) -> str:
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name!r}: its lines are no longer in {SOURCE}")
        text = text.replace(old, new)
    return text


def kernel_name(key: str) -> str:
    """`seed_bwd_gemm<1>` out of the profiler's demangled signature."""
    m = re.search(r"seed_bwd_\w+(<[^>]*>)?", key)
    return m.group(0) if m else key[:40]


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.gea_seed_backward.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.gea_seed_backward.restype = ctypes.c_int
    lib.gea_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def make(batch, code, s0, c0, c1, gen):
    def r(shape, scale, d=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", d)

    p = s0 * s0 * c0
    return (r((batch, code), 1.0), r((code, p), code**-0.5), r(p, 0.1, torch.float32),
            torch.rand(c0, generator=gen).cuda() * 0.5, r(c0, 0.1, torch.float32),
            r((4, 4, c0, c1), (16 * c0) ** -0.5), r(c1, 0.1, torch.float32),
            r((batch, 2 * s0, 2 * s0, c1), 0.1), s0)


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
        print("torch_seed_backward_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    if "source" not in names:
        names = ["source", *names]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    procs = {}
    for i, name in enumerate(names):
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name, text))
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", os.path.dirname(SOURCE), "-o",
             os.path.join(OUT, f"v{i}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), f"v{i}.so")
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} does not build:\n{out}")
        libs[name] = load(os.path.join(OUT, so))
    gen = torch.Generator().manual_seed(0)
    for shape in SHAPES:
        args = make(*shape, gen)
        want = seed.fused_seed_backward_plain(*args)
        ref = None
        for name in names:
            seed._bwd_lib = lambda lib=libs[name]: lib  # the op binds the variant
            got = seed.fused_seed_backward(*args)
            torch.cuda.synchronize()
            rel = max(((k.float() - w.float()).abs().max()
                       / w.float().abs().max().clamp_min(1e-30)).item()
                      for k, w in zip(got, want))
            same = ref is None or all(torch.equal(a, b) for a, b in zip(got, ref))
            ref = ref or got
            ms = time_ms(lambda: seed.fused_seed_backward(*args))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    seed.fused_seed_backward(*args)
                torch.cuda.synchronize()
            kernels = "; ".join(
                f"{kernel_name(e.key)} {e.self_device_time_total / 1e4:.4f}"
                for e in prof.key_averages() if e.self_device_time_total > 0)
            print(f"{shape} {name}: call {ms:.4f} ms, max|err|/max {rel:.2e}, bit for bit with "
                  f"the source {same}; kernels (ms a call) {kernels}", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
