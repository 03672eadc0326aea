#!/usr/bin/env python3
"""What bounds the LIS chain backward's phases: variants of
`gea_torch/csrc/lis_bwd.cu`, each with one piece of work taken out, traced
beside the source on one NVIDIA GPU.

    python scripts/torch_lis_backward_variants.py

Each variant is the source with the exact text substitutions of `VARIANTS`
(a substitution that no longer matches the source stops the script: update
the table with the source), built with -DLIS_TRACE into
`build/lis_variants/`, all builds at once, and run through
`scripts/torch_lis_backward_trace.py`'s tracing at the flagship chain (3
links, batch 64, code = hidden = 256, bf16) with the G-LIS need set. A
variant's gradients are wrong where it drops work; only its times count.
Prints each variant's phases (median SM cycles over 20 calls and the row
groups) beside the source's, its call's device time, and the number of
SASS instructions of each kernel (cuobjdump). About 90 s on an H100.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gea_torch.ops import build, lis  # noqa: E402

# name -> ([(old, new), ...] substitutions, extra nvcc flags)
VARIANTS = {
    "source": ([], []),
    "no partial stores": ([("store_tile(stg, acc, p.part + lk.slot[",
                            "if (false) store_tile(stg, acc, p.part + lk.slot[")], []),
    "no exact pre": ([("tile8_exact(pre, reinterpret_cast",
                       "pre[0][0] = pre[0][1] = pre[1][0] = pre[1][1] = 0.0;\n"
                       "    if (false) tile8_exact(pre, reinterpret_cast")], []),
    "no cluster barriers": ([('auto arrive_all = [] { asm volatile("barrier.cluster.arrive.release'
                              '.aligned;\\n" ::: "memory"); };', "auto arrive_all = [] {};"),
                             ('auto wait_all = [] { asm volatile("barrier.cluster.wait.acquire.'
                              'aligned;\\n" ::: "memory"); };', "auto wait_all = [] {};")], []),
    "helpers not inlined": ([], ["-DLIS_INLINE=__noinline__"]),
    # Operands not copied in (the slots keep what they held): what each
    # copy costs the walk.
    "no z copies": ([("    bytes = tile_load(reinterpret_cast<T*>(s), L.ld_z, z + (size_t)r0 * code, "
                      "code, kRows, L.kz,\n                      nrows, code, bar, lane, copy);",
                      "    bytes = 0;")], []),
    "no W1[:, slice] copies": ([("    if (!is_w) {  // W1[:, slice] whole, by TMA boxes",
                                 "    if (false) {  // W1[:, slice] whole, by TMA boxes")], []),
    "no W2, W1[out] copies": ([("      bytes += tile_load(reinterpret_cast<T*>(s + L.w_w2), L.ld_z, "
                                "w2 + (size_t)h0 * code, code,\n                         wh, L.kz, "
                                "hidden - h0, code, bar, lane, copy);", ""),
                               ("        bytes += tile_load(reinterpret_cast<T*>(s + L.w_w1r), "
                                "L.ld_f, w1 + (size_t)o0 * hidden,\n                           "
                                "hidden, wo, L.kh, code - o0, hidden, bar, lane, copy);", "        ;")],
                              []),
    # Work done twice on the same data: what the second pass adds is the
    # work's own time once its instructions are cached.
    "no column sums": ([("    if (need_sums) {  // four rows a thread",
                         "    if (false) {  // four rows a thread")], []),
}


def build_variants() -> dict:
    out = build.BUILD_DIR.parent / "lis_variants"
    out.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "lis_bwd.cu").read_text()
    texts = {}
    for name, (subs, _) in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for i, (name, (_, flags)) in enumerate(VARIANTS.items()):
        src = out / f"v{i}.cu"
        src.write_text(texts[name])
        so = out / f"v{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-DLIS_TRACE", *flags,
               f"-I{build.CSRC}", "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
        libs[name] = so
    return libs


def sass_sizes(so) -> dict:
    """{kernel: SASS instructions} of a built library (cuobjdump)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[name] += 1
    return {("chain<bf16>" if "nv_bfloat16" in k else "chain<float>" if "kernelIf" in k
             else "reduce" if "reduce" in k else k[:40]): v for k, v in sizes.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lis_backward_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import ctypes

    import chip_smoke as cs
    import torch_lis_backward_trace as tr

    smi = cs.nvidia_smi()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    base = lis._bwd_lib()
    libs = build_variants()
    per_us = cs.cycles_per_ms() / 1e3
    links, dt = 3, torch.bfloat16
    args = cs.lis_chain_args(64, 256, 256, links, dt, torch.Generator().manual_seed(0))
    needs = cs.lis_chain_needs(links)["G-LIS"]
    plan = lis.backward_plan(64, 256, 256, True, needs, lis._sm_count(0),
                             lis.resident_clusters(0, True))
    names = ["first operands", "prologue"] + [f"link {links - 1 - w}: {p}"
                                              for w in range(links) for p in tr.PHASES]
    marks = [0, 1, 2] + [3 + 5 * w + i for w in range(links) for i in range(5)]
    table = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.gea_lis_chain_backward.restype = ctypes.c_int
        lib.gea_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gea_cuda_error_string.restype = ctypes.c_char_p
        trace = torch.zeros((plan.groups, 3 + 5 * 8), dtype=torch.int64, device="cuda")
        lis._bwd_lib = lambda: tr.Traced(base, lib, trace)
        try:
            ms = cs.time_ms(lambda: lis.lis_chain_backward(*args, needs))
            rows = []
            for _ in range(tr.CALLS):
                trace.zero_()
                lis.lis_chain_backward(*args, needs)
                torch.cuda.synchronize()
                rows += trace.cpu().tolist()
        finally:
            lis._bwd_lib = lambda: base
        phases = [statistics.median(r[b] - r[a] for r in rows) for a, b in zip(marks, marks[1:])]
        table[name] = (ms, phases)
        print(f"[variant] {name:34s} call {ms:.4f} ms, walk {sum(phases) / per_us:7.3f} us, "
              f"SASS {sass_sizes(so)}", flush=True)
    print(f"[variant] plan {plan.config}; SM cycles per phase, SM clock {per_us:.0f} cycles/us",
          flush=True)
    print("[variant] " + " " * 38 + "".join(f"{n[:11]:>12s}" for n in table), flush=True)
    for i, phase in enumerate(names):
        print(f"[variant] {phase:38s}" + "".join(f"{v[1][i]:12.0f}" for v in table.values()),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
