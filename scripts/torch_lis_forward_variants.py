#!/usr/bin/env python3
"""What bounds LIS's fp32 forward kernel (`lis_kernel_f32_cluster`,
`gea_torch/csrc/lis.cu`): variants of the source, each with one piece of
work taken out, and other plans of the same source, timed on one NVIDIA GPU
at the flagship link (batch 64, code = hidden = 256, fp32, TF32 off).

    python scripts/torch_lis_forward_variants.py

Each variant is the source with the exact text substitutions of `VARIANTS`
(a substitution that no longer matches the source stops the script: update
the table with the source), built into `build/lis_forward_variants/`, all
builds at once, and swapped in for the wrapper's library. A variant's
output is wrong where it drops work; only its time counts
(`chip_smoke.time_ms`, the median device time of single calls). Then the
source under every plan the launch takes at the flagship (`PLANS`: rows,
cluster, ring depth). Prints each time beside the empty launch's. About
60 s on an H100 with the builds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gea_torch.ops import build, lis  # noqa: E402

F32_MARK = "// ------------------------------------------------------------ fp32, CUDA cores"
SYNC_END = "  cluster.sync();\n  if (tid >= kF32Threads) return;"
ARRIVE = '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n'
WAIT = ('  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");  '
        "// every block has started\n")
DOUBLE_BUFFERED = """if constexpr (RT == 1 && CT == 1) {
        if (kc % 16 == 0) {
          float x0[16], b0[16], x1[16], b1[16];
          auto fetch = [&](float (&xv)[16], float (&bv)[16], int k) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 v = *reinterpret_cast<const float4*>(Ar + k + 4 * q);
              xv[4 * q] = v.x, xv[4 * q + 1] = v.y, xv[4 * q + 2] = v.z, xv[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int q = 0; q < 16; ++q) bv[q] = B[(k + q) * w];
          };
          fetch(x0, b0, 0);
          for (int k = 0; k < kc; k += 32) {
            if (k + 16 < kc) fetch(x1, b1, k + 16);
#pragma unroll
            for (int q = 0; q < 16; ++q) acc[0][0] = fmaf(x0[q], b0[q], acc[0][0]);
            if (k + 16 >= kc) break;
            if (k + 32 < kc) fetch(x0, b0, k + 32);
#pragma unroll
            for (int q = 0; q < 16; ++q) acc[0][0] = fmaf(x1[q], b1[q], acc[0][0]);
          }
          continue;
        }
      }
"""
# name -> [(old, new), ...]
VARIANTS = {
    "source": [],
    # The FMA loops skipped: copies, barriers, exchange and launch alone.
    "no products": [("    if (active) {\n      const float* B",
                     "    if (false) {\n      const float* B")],
    # Loads of 4 k-steps ahead of their FMAs at a time, in place of 16.
    "k loop unrolled 4": [("constexpr int kUnroll = RT * CT == 1 ? 16 : RT * CT == 2 ? 8 : 4;",
                           "constexpr int kUnroll = 4;")],
    # Other register tiles at the flagship: more outputs a thread, fewer
    # threads, fewer loads an FMA.
    "tile 1 x 2": [("  switch (tile_size(a.rows, w)) {", "  switch (2) {")],
    "tile 2 x 2": [("  switch (tile_size(a.rows, w)) {", "  switch (4) {")],
    "tile 1 x 4": [("  switch (tile_size(a.rows, w)) {", "  switch (4) {"),
                   ("    case 4: return layer<2, 2>(", "    case 4: return layer<1, 4>(")],
    "tile 2 x 4": [("  switch (tile_size(a.rows, w)) {", "  switch (8) {")],
    "tile 2 x 1": [("  switch (tile_size(a.rows, w)) {", "  switch (2) {"),
                   ("    case 2: return layer<1, 2>(", "    case 2: return layer<2, 1>(")],
    "tile 4 x 1": [("  switch (tile_size(a.rows, w)) {", "  switch (4) {"),
                   ("    case 4: return layer<2, 2>(", "    case 4: return layer<4, 1>(")],
    # The compiler not told that one block runs an SM (fewer registers).
    "no blocks-an-SM bound": [("__global__ void __launch_bounds__(kF32Threads + 32, 1)\n",
                               "__global__ void __launch_bounds__(kF32Threads + 32)\n")],
    # One output a thread: the next 16 k-steps' operands loaded while this
    # 16's FMAs run (kc a multiple of 16; else the loop as it is).
    "1 x 1 double-buffered": [("#pragma unroll kUnroll\n      for (int k = 0; k < kc; k += 4) {",
                               DOUBLE_BUFFERED + "#pragma unroll kUnroll\n"
                               "      for (int k = 0; k < kc; k += 4) {")],
    # The products' shared-memory loads left out, one operand at a time:
    # the chains of FMAs on values already in registers.
    "no B loads": [("          lds(b, B + (k + kk) * w);",
                    "          for (int j = 0; j < CT; ++j) b[j] = x[0][kk];")],
    "no A loads": [("        for (int r = 0; r < RT; ++r) lds(x[r], Ar + r * lda + k);",
                    "        for (int r = 0; r < RT; ++r)\n"
                    "          x[r][0] = x[r][1] = x[r][2] = x[r][3] = __int_as_float(k + 1);")],
    # B's row stride a constant (right at the flagship's slices alone).
    "B stride fixed at 16": [("lds(b, B + (k + kk) * w);", "lds(b, B + (k + kk) * 16);")],
    # The weight slices not copied (z and the vectors still are).
    "no weight copies": [
        ("    gea::mbar_expect_tx(bar, 4 * kChunk * L.wo);\n"
         "    gea::tma_load_2d(slot, &a.w2map, o0, (c - L.n1) * kChunk, bar);",
         "    gea::mbar_arrive(bar);"),
        ("gea::mbar_expect_tx(bar, 4 * kChunk * (a.rows + L.wh) + ",
         "gea::mbar_expect_tx(bar, 4 * kChunk * a.rows + "),
        ("  gea::tma_load_2d(slot, &a.w1map, h0, c * kChunk, bar);\n", "")],
    # Neither the hidden slices' exchange nor the cluster barriers.
    "no exchange, no cluster barriers": [
        ("  for (int q = tid; q < cl * pieces; q += blockDim.x) {",
         "  for (int q = tid; q < 0; q += blockDim.x) {"),
        (ARRIVE, ""), (WAIT, ""),
        (SYNC_END, "  __syncthreads();\n  if (tid >= kF32Threads) return;")],
    # Nothing but the launch of the same grid of clusters.
    "empty body": [("  const int tid = threadIdx.x;\n  const bool copier",
                    "  if (a.rows > 0) return;\n  const int tid = threadIdx.x;\n"
                    "  const bool copier")],
}
# The source with %globaltimer read at the phase boundaries (`MARKS`: slot,
# name; by thread 0, the copier's marks 1 and 2 by the copier), and the SM
# clock at the first and the last, into a device array that `gea_lis_trace`
# copies out.
TRACE_SUBS = [
    ("__host__ __device__ inline int cdiv(int a, int b)",
     "__device__ unsigned long long g_trace[4096 * 16];\n"
     "#define STAMP(who, k) if (threadIdx.x == (who)) { unsigned long long t_; "
     'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
     "g_trace[blockIdx.x * 16 + (k)] = t_; }\n"
     "#define TRACE(k) STAMP(0, k)\n"
     "#define CLOCK(k) if (threadIdx.x == 0) g_trace[blockIdx.x * 16 + (k)] = clock64();\n"
     "__host__ __device__ inline int cdiv(int a, int b)"),
    ("  const int r0 = (blockIdx.x / cl) * a.rows, h0 = rank * L.wh, o0 = rank * L.wo;\n",
     "  const int r0 = (blockIdx.x / cl) * a.rows, h0 = rank * L.wh, o0 = rank * L.wo;\n"
     "  TRACE(0);\n  CLOCK(14);\n"),
    ("    gea::mbar_init_fence();\n", "    gea::mbar_init_fence();\n    STAMP(kF32Threads, 1);\n"),
    ("issue_chunk(a, L, smem, bars, c, r0, h0, o0);\n  // This block has started",
     "issue_chunk(a, L, smem, bars, c, r0, h0, o0);\n  STAMP(kF32Threads, 2);\n"
     "  // This block has started"),
    ("  __syncthreads();\n  // The copier issues", "  __syncthreads();\n  TRACE(3);\n"
     "  // The copier issues"),
    (ARRIVE, ARRIVE + "  TRACE(4);\n"),
    ("    gea::mbar_wait(bars + c % a.depth, (c / a.depth) & 1);\n",
     "    gea::mbar_wait(bars + c % a.depth, (c / a.depth) & 1);\n"
     "    if (c == 0) TRACE(5);\n    if (c == L.n1) TRACE(10);\n"),
    ("  __syncthreads();\n" + WAIT, "  TRACE(6);\n  __syncthreads();\n" + WAIT + "  TRACE(7);\n"),
    (SYNC_END, "  TRACE(8);\n" + SYNC_END + "\n  TRACE(9);"),
    ("            });\n}\n\n// An fp32 row-major tensor",
     "            });\n  TRACE(11);\n  CLOCK(15);\n}\n\n// An fp32 row-major tensor"),
]
TRACE_TAIL = """
extern "C" int gea_lis_trace(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_trace, n * sizeof(unsigned long long));
}
"""
MARKS = [(0, "start"), (1, "barriers made"), (3, "block barrier"), (4, "cluster arrival"),
         (5, "first chunk landed"), (6, "hidden slice"), (7, "cluster wait"), (8, "push"),
         (9, "cluster barrier"), (10, "W2's first chunk"), (11, "output slice")]
# (rows, cluster, depth) at the flagship; depth 0: the whole ring.
PLANS = [(8, 16, 0), (16, 16, 0), (8, 8, 0), (16, 8, 0), (8, 16, 2), (8, 16, 4)]


def variant_texts() -> dict:
    """{variant: source}; the substitutions apply to the fp32 part alone."""
    head, mark, fp32 = (build.CSRC / "lis.cu").read_text().partition(F32_MARK)
    texts = {}
    for name, subs in [*VARIANTS.items(), ("traced", TRACE_SUBS)]:
        text = fp32
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        texts[name] = head + mark + text + (TRACE_TAIL if name == "traced" else "")
    return texts


def build_variants() -> dict:
    out = build.BUILD_DIR.parent / "lis_forward_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variant_texts().items()):
        src = out / f"v{i}.cu"
        src.write_text(text)
        so = out / f"v{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
        libs[name] = so
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lis_forward_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    base = lis._lib()
    libs = build_variants()
    gen = torch.Generator().manual_seed(0)
    batch, code, hidden = 64, 256, 256
    args = (cs.randn((batch, code), gen), cs.randn((code, hidden), gen, code**-0.5),
            cs.randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
            cs.randn(hidden, gen, 0.1), cs.randn((hidden, code), gen, hidden**-0.5),
            cs.randn(code, gen, 0.1))
    print(f"[variant] empty launch {cs.empty_launch_ms():.4f} ms; plain "
          f"{cs.time_ms(lambda: lis.lis_residual_mlp_plain(*args)):.4f} ms", flush=True)
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("gea_lis_forward", "gea_lis_smem_bytes"):
            f, g = getattr(lib, fn), getattr(base, fn)
            f.argtypes, f.restype = g.argtypes, g.restype
        lib.gea_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gea_cuda_error_string.restype = ctypes.c_char_p
        lis._lib = lambda lib=lib: lib
        try:
            ms = cs.time_ms(lambda: lis.lis_residual_mlp(*args))
        finally:
            lis._lib = lambda: base
        print(f"[variant] {name:34s} {ms:.4f} ms", flush=True)
        if name == "traced":
            lis._lib = lambda lib=lib: lib
            try:
                print_phases(lib, lis.forward_plan(batch, code, hidden, False).blocks,
                             lambda: lis.lis_residual_mlp(*args))
            finally:
                lis._lib = lambda: base
    plan_of = lis.forward_plan
    ref = lis.lis_residual_mlp(*args)
    for rows, cluster, depth in PLANS:
        want = plan_of(batch, code, hidden, False)
        depth = depth or want.chunks

        class Forced(lis.ForwardPlan):
            config = (rows, cluster, depth)

        lis.forward_plan = lambda *a, **k: Forced(batch, code, hidden, False)
        try:
            got = lis.lis_residual_mlp(*args)
            err = cs.compare("lis_residual_mlp", f"plan {rows, cluster, depth}", torch.float32,
                             got, lis.lis_residual_mlp_plain(*args))
            same = torch.equal(got, ref)
            ms = cs.time_ms(lambda: lis.lis_residual_mlp(*args))
        finally:
            lis.forward_plan = plan_of
        print(f"[plan] rows {rows:2d} cluster {cluster:2d} ring {depth}/{want.chunks}: "
              f"{ms:.4f} ms, max|err| {err:.3e}, bits of the default plan's: {same}", flush=True)
    print(smi, flush=True)
    return 0


def print_phases(lib, blocks: int, call) -> None:
    """Over the blocks of 20 calls: when each block starts after the first
    one does, then each mark's median and largest microseconds after the
    one before it, and the SM clock over the block's run."""
    lib.gea_lis_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gea_lis_trace.restype = ctypes.c_int
    runs = []
    for _ in range(20):
        call()
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * (blocks * 16))()
        if lib.gea_lis_trace(ctypes.addressof(host), blocks * 16):
            raise RuntimeError("gea_lis_trace failed")
        runs.append(torch.tensor(list(host), dtype=torch.float64).view(blocks, 16))
    t = torch.cat(runs)
    start = torch.cat([r[:, 0] - r[:, 0].min() for r in runs]) / 1e3
    print(f"[trace] {'start after the first block':30s} median {start.median().item():7.3f} us, "
          f"largest {start.max().item():7.3f} us", flush=True)
    d = (t[:, 2] - t[:, 1]) / 1e3
    print(f"[trace] {'the copier issues its chunks':30s} median {d.median().item():7.3f} us, "
          f"largest {d.max().item():7.3f} us", flush=True)
    for (a, _), (b, name) in zip(MARKS, MARKS[1:]):
        d = (t[:, b] - t[:, a]) / 1e3
        print(f"[trace] {name:30s} median {d.median().item():7.3f} us, largest "
              f"{d.max().item():7.3f} us", flush=True)
    mhz = (t[:, 15] - t[:, 14]) / (t[:, 11] - t[:, 0]) * 1e3
    print(f"[trace] SM clock over a block's run: median {mhz.median().item():.0f} MHz", flush=True)
    whole = torch.stack([(r[:, 11] - r[:, 0].min()).max() for r in runs]) / 1e3
    print(f"[trace] first start to last exit, median over calls {whole.median().item():.3f} us",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
