#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`gea_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. print the card's name and power limit, and the torch, CUDA and scipy
   versions;
2. build the CUDA kernels from `gea_torch/csrc/` (nvcc, sm_90a);
3. for each kernel, at the shapes of the flagship serving path and of the
   flagship train step, in fp32 and bf16: compare the kernel with its plain
   PyTorch version within a stated tolerance, and time both (CUDA events,
   warm-up, median of 20 launches) beside the least time the card could
   take (bytes or operations), the device time of an empty kernel launch
   (the floor of any launch) and, for the seed, the bf16 library composite
   (cuBLAS GEMM, TPReLU, cuDNN transposed conv; a yardstick the port never
   calls); TPReLU's backward kernel (`fused_tprelu_backward`) at every
   TPReLU shape, in fp32 and bf16, with da and db and without: dx equal to
   the plain version's bit for bit, da and db within BWD_SUM_TOL, its time
   beside the plain version's, the bound (x and g read, dx written) and
   the empty launch; the seed's backward kernels (`fused_seed_backward`)
   at both seed shapes, in fp32 and bf16, with every gradient, dz alone
   and the weights alone: each gradient within SEED_BWD_TOL of its max and
   its mean error within SEED_BWD_MEAN_TOL of its mean, a second call equal
   to the first bit for bit, what a kernel that left the ds
   rounding out would read (which must exceed the limit), the time beside
   the plain version's, the bf16 composite's backward (cuBLAS, cuDNN), the
   bound and the empty launch; LIS's backward kernel
   (`lis_residual_mlp_backward`) at the G-LIS step's link and at its
   near-zero case (`lis_near_zero`: rows whose s lies within rounding of 0,
   where an fp32 product would take the other branch), in fp32 and bf16,
   with every gradient, dz alone and the weights alone: each gradient
   within LIS_BWD_TOL of its max and the mean error of dz, dw1 and dw2
   within LIS_BWD_MEAN_TOL of their mean, what a kernel that left the
   roundings of h and dh_pre out would read (which must exceed the limit),
   the time beside the plain version's, the bound and the empty launch;
4. at the train step's shapes, in fp32 and bf16: each kernel's
   `torch.autograd.Function` (kernel forward, kernel backward) against
   autograd through its plain
   version, gradients of every input within a stated tolerance, and the
   device time of each backward;
5. edge shapes the flagship never reaches, in fp32 and bf16: the seed at a
   ragged batch, at s0 = 4 and 7, with c1 and code that are not multiples
   of the tiles; the LIS link at a batch that is not a multiple of its row
   tile and at widths below one tile; TPReLU and its backward at C = 3, 5,
   96 and 1000, one row and rows that are not a multiple of a tile, the
   backward with da and db at each and, at each, without them or with an
   fp32 cotangent into bf16 x; the seed's backward at each seed shape and
   at c0 = c1 = 512 (config 5's), with every gradient and with dz alone;
   LIS's backward at batches 1, 17, 30, 33 and 128, at hidden 512
   (`lis_hidden_mult` 2) and at widths below one tile, with every gradient,
   dz alone and the weights alone;
6. build flagship-width G and D from seeded random params in `gea`'s tree
   layout and run `ServingModel.from_modules(G, D).sample_filtered(64,
   oversample=4, batch_size=64)` in bf16 with the launch counters zeroed just before and
   read just after; check the outputs, the launch counts, and an fp32
   render with kernels against the same render with plain versions; with
   torch.profiler, the device's busy share of a call and the device time of
   one render + score by kernel;
7. the main path, the G-LIS train step (`gea_torch.train`) at flagship
   width in bf16 with batch 64 and BCE: 2 warm-up steps, of which the first
   checks that every parameter of G and D got a finite, non-zero gradient
   and that one step launches seed 1, LIS 3, TPReLU 9, TPReLU's
   backward 9, LIS's backward 3 and the seed's backward once; then 10
   steps timed on the host clock with the launch counters zeroed just
   before and read just after; every parameter moved; the device time of
   one step (CUDA events behind a spin; whether the spin covered the
   step's enqueue is checked and printed), the device's idle share and a
   torch.profiler breakdown of one step by category, with the backward
   of each port kernel's Function (each its kernels, by name, with no
   cuBLAS or cuDNN kernel under the seed's, and under LIS's none and no
   kernel inside its op but the port's) and Adam on their own; then 2 fp32
   steps
   with kernels against 2 with plain versions (metrics, step 1's
   gradients, parameters), beside a second run of the plain versions;
8. the trainer, `python -m gea_torch.cli.train_glis` called in-process at
   flagship width with synthetic data drawn on the device: 40 steps with
   the launch counters zeroed just before and read just after (exactly 40
   steps' and 2 sample renders' launches), the run directory's artifacts;
   the checkpoint of step 40 restored into a fresh state equals the trained
   state bit for bit, as does a state with an EMA shadow and a cosine
   schedule after 2 steps; a relaunch resumes at step 40 and reaches 60
   with finite metrics; 40 steps each of the host-streamed synthetic data,
   of the host preprocess and of a folder of JPEGs with `--data_cache` and
   with `--device_data_cache`. Every CLI run, the relaunch included, has
   the launch counters zeroed just before it and read just after, and
   must launch exactly its steps' and renders' kernels. For each run the
   meter's rate, the median
   host time of a loop iteration and of its wait for input, and the
   device's idle share over 10 steps of the same path under
   torch.profiler; the host time of one synthetic batch; the two parts of
   a checkpoint save and one restore;
9. R-separate, `python -m gea_torch.cli.train_r_separate` called
   in-process against phase 8's main run directory as its frozen G (and D):
   40 steps with renders and saves at 20, with exactly 40 steps' and 2
   renders' launches (TPReLU 13, its backward 10, LIS 6, LIS's backward 3
   and the seed's backward 1, each with dz alone, seed 2, a step; 10, 0, 6,
   0, 0, 2 a render);
   the run directory's artifacts; every parameter of R got a finite,
   non-zero gradient and moved; the frozen G and D are unchanged bit for
   bit and hold no gradient; a bitwise checkpoint round trip of the R
   state; 10 bare steps timed as in phase 7 (wall, images/s, device time,
   idle share, a torch.profiler breakdown by category with each port
   kernel's forward and backward on their own); a relaunch resuming
   at 40 to 60 with exact launches; 2 fp32 steps with kernels against 2
   with plain versions beside a second plain run;
10. R-iterative, `python -m gea_torch.cli.train_r_iterative` in-process at
   flagship width with `--r_chain_length 2 --lambda_r 0.9` and synthetic
   data drawn on the device: the same list (TPReLU 43, its backward 26,
   seed 6, the seed's backward 3 a step; 17, 0, 3, 0 a render), with G, D
   and R all trained;
11. evaluation (`gea_torch.eval.fid`, the trainers' `--fid_interval` and
   the offline evaluators), on the run directories phases 8-10 leave:
   both feature networks on the card, fp32 without TF32, against the golden
   written from `gea` (`tests/torch_port_fid_golden.json`: feature means
   and covariance trace within rtol 1e-4, the proxy-FID of its two halves
   within rtol 1e-3) and the device time of a batch of 64; each trainer
   for 20 steps without and with `--fid_interval 10 --fid_samples 1024`
   (G-LIS fresh, R-separate against phase 8's run, R-iterative fresh),
   with exact launches (the steps' and 2 evaluations of 16 renders), 2
   finite rows in fid.jsonl, a best.json whose checkpoint restores, the
   rate with tracking against the rate without, and outside the loop the
   wall time of the real side and of one evaluation with its launches and
   the device's idle share; then `compute_fid` (plain, `--d_filter`,
   `--r_path` on phase 9's run, `--second_opinion`, `--step -1` on the
   tracked G-LIS run), `eval_stages` on phase 8's run and `eval_chain` on
   phase 10's, 2048 samples each in batches of 64, with exact launches and
   finite values;
12. the demo data and the samplers: (a) `gea_torch.cli.make_demo_data`
   writes demo20k's first 1,251 images (`--size 200 --seed 0 --quality 92
   --style diverse`, timed); where pillow and libjpeg are those of
   `data/demo20k/MANIFEST.json`, the sha256 of img00000.jpg and
   img01250.jpg must be the manifest's, else both versions are printed and
   the script says the hash check did not run; (b) `train_glis` in-process
   on them at flagship width, batch 64, `--data_cache --g_ema 0.999
   --fid_interval 20`, 40 steps and a save at 40, with exact launches;
   (c) every sampler, with exact launches and its images/s with and
   without the PNG/GIF writes: `sample` on (b)'s run (plain, `--d_filter`,
   `--d_threshold` on its fill path, `--save_gif`, `--use_ema`, `--step -1`,
   `--d_filter_step -1`), `sample_interpolations` (slerp, lerp),
   `sample_r_separate` on phase 9's run, `sample_r_iterative` on phase 10's
   (its chain length and 3); `info` on the four runs (parameter counts of
   the modules each holds); `convert_checkpoint` export and `--from_torch`
   re-import of (b)'s run and phase 10's, each rendering the same images
   bit for bit; (d) the flagship fp32 render and D's logits, without TF32
   and with the kernels, against the golden written from `gea`
   (`tests/torch_port_render_golden.json`, atol 1e-4);
13. export and serving, on the run directories of phases 9, 10 and 12(b),
   in bf16 (as trained) and in fp32 without TF32 (the same checkpoints
   under a float32 config): `gea_torch.cli.export_model` in-process with
   `--all_stages 1 --with_scores 1`, `--step -1 --use_ema`, `--batch 64`,
   `--r_path` (phase 9's run) and `--ri_path` (phase 10's, at its chain
   length and at 3 links), each with its selfcheck, its wall time, the
   artifact's MB and `serve.load`'s time; each artifact's render of 64 codes
   (numpy, seed 0) against the live `ServingModel.from_modules` render of
   the same options (fp32: uint8 within 1 level, scores within 1e-5; bf16:
   the selfcheck's band), and one call of each with the launch counters
   zeroed just before and read just after: the artifact must launch
   exactly what the live call launches, per kernel, and what the path
   needs; then, on the bf16 scored artifact with every stage, the device
   time of one render + score beside the live function's (turns artifact,
   live, artifact, live), `sample_filtered(64, oversample=4,
   batch_size=64)` candidates/s and idle share beside phase 6's live
   figures, `stream` images/s at depth 1 and 8 over 32 batches of 64; the
   scored artifacts loaded with device="cpu" render a batch of 3 within the
   selfcheck's band of the card's render; `python -m gea_torch.serve
   --d_filter 1` in its own process on the `--use_ema` artifact (wall time,
   files); `gea_torch.serve_http` on 127.0.0.1 with 16 client threads of 8
   `{"count": 4}` requests and one `{"count": 16, "oversample": 4}` each,
   every response checked, requests/s, p50/p99 latency and the realized
   batch sizes from /stats;
14. `--steps_per_dispatch` as CUDA graphs (`gea_torch.train.dispatch`),
   at flagship width in bf16 with batch 64 and BCE, for each trainer
   (R-iterative at `--r_chain_length 2`, R-separate against a frozen G and
   D from seeded params): (a) 16 eager steps against 2 replays of a K = 8
   graph, warm-up and capture off the clock: wall a step, images/s, device
   busy and idle share (torch.profiler over 8 eager steps and over one
   replay), warm-up and capture seconds, the graph pool's peak MB, and the
   launch counts, which must equal 16 times phases 7, 9 and 10's per-step
   counts (replays counted; a replay launches 8 steps'); (b) in fp32
   without TF32, a graphed K = 2 chunk against 2 eager steps from the same
   params and draws (metrics within 2e-2, at most 2% of each parameter's
   elements more than lr / 5 apart), beside a second eager run: G-LIS on
   the recipe of the step golden written from `gea`
   (`tests/torch_port_step_golden.json` and its draws, batch 4) with both
   held against it (metrics and every parameter's norm, atol 2e-2 + rtol
   2%), the R trainers at batch 64; (c) the CLIs at `--steps_per_dispatch 8` with exact
   launches: `train_glis` 40 steps (checkpoints and grids at the chunk ends
   24 and 40, a bitwise round trip), 43 steps (a ragged tail of 3) and its
   relaunch resuming at 43 to 60, `train_r_separate` against the K = 8 run
   and `train_r_iterative`, 40 steps each, each meter rate beside its K = 1
   rate of phases 8-10; (d) short G-LIS runs: `--debug_checks` with K = 2
   clean, and with a NaN in iter 3's input, which must raise naming the op
   and the step; `--profile_dir` (its trace and kernel events);
   `--tensorboard` (tb/ or the disabled line) ([dispatch] lines);
15. print one JSON line of the serving results, one of the training
   results, one of the trainer's, one of the R trainers', one of the
   evaluation's, one of the samplers', one of export and serving, one of
   phase 14's, one of phase 16's, one of phase 17's, one of phase 18's,
   one of per-kernel results (six: the three forwards and their
   backwards; per train step; `launches` counts phase 7's timed steps,
   `launches_trainer` the trainer's first run,
   `launches_r_separate` and `launches_r_iterative` the R trainers' first
   runs, `launches_eval` phase 11's tracked runs and evaluators,
   `launches_samplers` phase 12's runs, `launches_serving` phase 6's live
   `sample_filtered` and one call of each of phase 13's artifacts,
   `launches_graphed` phase 14(a)'s 2 replays of the G-LIS graph,
   `launches_dp` phase 16(a)'s 10 DP steps, `launches_batch` phase 17(a)'s
   10 batch-norm steps, `launches_tp` phase 18(a)'s step a rank;
   `step_profile_ms` the kernel's time in phase 7's profiled step, by
   name), the card's name and power
   limit, and last `{"ok": true, "device": {...}}`;
16. (run before the lines of 15 are printed) data parallelism at `gea`'s
   fifth milestone shape, G-LIS-3 at 160x160 with spatial_code 4, bf16,
   BCE, batch 64, in a process group of world size 1 on NCCL (a localhost
   TCP store; the script runs on one card): (a) under deterministic
   algorithms, 10 eager DP steps against 10 single-process steps from the
   same seeded params, parameters, Adam's state and metrics
   equal bit for bit, with exact launches (`launches_dp`); then, in turns,
   wall a step, images/s, device busy and idle share and the NCCL kernels
   of both, and the seed kernel at this shape (c0 = c1 = 512) against its
   plain version; (b) 2 replays of a K = 8 graph with the all-reduces
   captured against 16 eager DP steps (wall, busy, idle, warm-up and
   capture s, pool MB), the port kernels' calls from the graph's own
   kernel nodes equal to 8 eager steps' counters and the NCCL kernel nodes
   counted, and the fp32 graphed K = 2 chunk against 2 eager DP steps
   (phase 14(b)'s gates); (c) `train_glis --num_devices 1`, `train_glis
   --multihost` under torchrun's environment of world size 1 (a bitwise
   round trip, a relaunch resuming at 40 to 60), `train_r_separate` and
   `train_r_iterative --multihost`, 40 steps each, exact launches; (d)
   `ServingModel.sharded()` over the visible cards against the single
   card, bit for bit in bf16 at batches 1, 3 and 64, and `serve_http
   --data_parallel` answering 16 requests ([dp] lines);
17. (run before the lines of 15 are printed) `--norm batch` (`gea`'s
   BatchNorm + LeakyReLU(0.2) in G, D and the reverter's trunk, with no
   fused seed): (a) the flagship G-LIS step with `--norm batch`, bf16,
   BCE, batch 64: 2 fp32 steps with kernels against 2 with plain versions
   under deterministic algorithms (metrics, step 1's gradients, the
   parameters, and the running statistics within STATS_TOL), exact
   launches (LIS 6, its backward 3, TPReLU 17, its backward 13 without da
   and db, seed 0 a step: G runs twice), 10 timed
   eager steps (wall, images/s, device busy, idle share, by category;
   `launches_batch` in the `kernels` line counts them), the K = 8
   dispatcher's warm-up putting G and D back bit for bit, 16 eager steps
   against 2 replays of a K = 8 graph (as phase 14(a): the graph's kernel
   nodes equal 8 eager steps' counters) and an fp32 graphed chunk against
   2 eager steps (phase 14(b)'s gates, and the running statistics); (b)
   `train_glis --norm batch` on phase 12's demo JPEGs with `--data_backend
   auto`, streamed and with `--data_cache` (40 steps, exact launches; the
   decode `auto` chose), `train_r_separate` against the streamed run and
   `train_r_iterative --r_chain_length 2`, 20 steps each; (c) whether g++
   and libjpeg built the native loader on this host and in how many
   seconds, its images/s against PIL threads on the demo JPEGs at crop 160,
   and `auto`'s stream against an explicit `native` one, byte for byte
   (where it cannot build, said so, and (b) decoded with PIL as `gea`'s
   `auto` does); (d) `sample` on (b)'s run with exact launches, its
   `export_model --with_scores 1` artifact against the live eval-mode G
   and D (images bit for bit, equal launches), and one evaluation leaving
   the running statistics bit for bit and every module's mode as it was
   ([batch] lines, one {"batch_norm": ...} JSON line);
18. tensor parallelism, LSUN and grain: (a) the flagship G-LIS step (bf16,
   BCE, batch 64, --g_ema 0.999) with --model_shards 2 on two spawned
   ranks, data 1 x model 2, both on cuda:0 in a gloo group (NCCL refuses
   two ranks on one card; where gloo refuses CUDA tensors the collectives
   are staged through host copies, and the phase says so): each rank's
   launches a step equal phase 7's (`launches_tp`), its bytes of
   parameters, EMA and Adam against the single process's, wall and
   device ms a step (two processes sharing one card: not a speed), and 2
   fp32 steps under deterministic algorithms against 2 single-process
   steps (phase 16's gates); in both, every kernel's inputs at the rank's
   own shapes (TPReLU's backward too) held against its plain version;
   (b) `train_glis --model_shards 2` on the one
   card raises `gea`'s "needs multiple devices" SystemExit; (c) phase 12's
   demo JPEGs as two LSUN class folders, `train_glis --dataset lsun
   --lsun_classes tower,church_outdoor` for 10 steps with exact launches,
   and an LMDB-only class raising `gea`'s lmdb message where lmdb is
   missing; (d) whether grain imports: if it does, `train_glis
   --data_backend grain` for 10 steps and its first epoch equal to the
   PIL stream's as a multiset; if not, `--data_backend grain` raises ([tp]
   lines, one {"tensor_parallel": ...} JSON line).

Phases 3-5 also hold each kernel against its plain version (forward and
gradients) at the shapes only the R trainers give it: TPReLU on R's head,
(64, 512), and the seed at R-iterative's batch of 64.

Without CUDA the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gea_torch import FLAGSHIP, ops, serve, serve_http
from gea_torch.cli import (
    compute_fid,
    convert_checkpoint,
    eval_chain,
    eval_stages,
    export_model,
    info,
    make_demo_data,
    sample,
    sample_interpolations,
    sample_r_iterative,
    sample_r_separate,
    train_glis,
    train_r_iterative,
    train_r_separate,
)
from gea_torch.cli.sample import load_discriminator, load_generator
from gea_torch.config import (
    TrainGLISConfig,
    TrainRIterativeConfig,
    TrainRSeparateConfig,
    generator_plan,
)
from gea_torch.data import native_build
from gea_torch.data.native_loader import NativeFolderLoader
from gea_torch.data.pipeline import FolderDataset, SyntheticDataset, list_images, make_dataset
from gea_torch.eval import fid
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.ops import build
from gea_torch.parallel import DataParallel, join
from gea_torch.parallel.mesh import Launch, free_port
from gea_torch.parallel.tp import Collectives, TensorParallel, resident_bytes
from gea_torch.serve import ServingModel
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.dispatch import StepDispatcher
from gea_torch.ops.layers import eval_mode
from gea_torch.train.runner import input_iterator, make_input_fn, state_modules
from gea_torch.train.state import generator_config
from gea_torch.utils.checkpoint import (
    best_record,
    record_best_step,
    restore_checkpoint,
    save_checkpoint,
    state_dict,
    wait_for_checkpoints,
)
from gea_torch.utils.grids import save_stage_grids

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 tensor cores; fp32 CUDA cores
COUNT, OVERSAMPLE, BATCH = 64, 4, 64
R_HIDDEN = 512  # the reverser's head width (`gea`'s r_hidden default)
REPS, WARMUP = 20, 3
SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's clock: longer than any call's enqueue
RENDER_SPIN_CYCLES = 60_000_000  # about 30 ms: longer than a whole render's enqueue
TRAIN_WARMUP, TRAIN_STEPS = 2, 10

# Tolerance |kernel - plain| <= atol + rtol * |plain|, per dtype. fp32: the
# two differ only in the order of fp32 sums. bf16: a different sum order can
# flip a rounding to bf16 (one step is 2^-8 relative); a flipped hidden or
# seed-map value moves the output by about one more such step.
TOL = {
    "fused_tprelu": {torch.float32: (1e-6, 1e-6), torch.bfloat16: (1e-5, 8e-3)},
    "lis_residual_mlp": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)},
    "fused_seed": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)},
}
SOURCES = {
    "fused_tprelu": ("triton", "gea_torch/ops/tprelu.py", "gea/ops/pallas/tprelu.py:50"),
    "fused_tprelu_backward": ("triton", "gea_torch/ops/tprelu.py", "gea/ops/pallas/tprelu.py:80"),
    "lis_residual_mlp": ("cuda", "gea_torch/csrc/lis.cu", "gea/ops/pallas/lis.py:89"),
    "lis_residual_mlp_backward": ("cuda", "gea_torch/csrc/lis_bwd.cu", "gea/ops/pallas/lis.py:122"),
    "fused_seed": ("cuda", "gea_torch/csrc/seed.cu", "gea/ops/pallas/seed.py:129"),
    "fused_seed_backward": ("cuda", "gea_torch/csrc/seed_bwd.cu", "gea/ops/pallas/seed.py:203"),
}


@contextlib.contextmanager
def cudnn_tf32():
    """PyTorch's default for cuDNN (TF32 allowed in fp32 convolutions),
    under which the train step is timed; elsewhere the script turns TF32
    off so that fp32 comparisons hold fp32 arithmetic."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, spin_cycles: int = SPIN_CYCLES) -> float:
    """Median of REPS single-call device times, CUDA events, after WARMUP
    calls. Before each call the stream is held busy by a spin kernel while
    the host enqueues the call, so the events time the device's work and
    not the host's launch overhead."""
    for _ in range(WARMUP):
        fn()
    pairs = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def empty_launch_ms() -> float:
    """Device time of one launch of a kernel that does nothing (a spin of 0
    cycles) under `time_ms`: the floor under any kernel's time."""
    return time_ms(lambda: torch.cuda._sleep(0))


def device_profile(fn) -> tuple:
    """torch.profiler over one call of `fn`: (device ms summed over kernels
    and copies, [(name, ms, count)] by descending time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


# Kernel names by what they do, for the render + score breakdown; the
# first rule that matches wins.
CATEGORIES = (
    ("port kernels", ("seed_tap_gemm", "seed_kernel_f32", "lis_kernel", "tprelu_kernel",
                      "tprelu_grad_", "seed_bwd_", "lis_bwd_")),
    ("library convs (cuDNN)", ("xmma", "cudnn", "cutlass", "nhwc", "implicit_gemm")),
    ("library matmuls (cuBLAS)", ("gemm", "gemv")),
    ("eager elementwise and reductions", ("at::native",)),
    ("copies", ("Memcpy", "Memset")),
)


def kernel_category(name: str) -> str:
    return next((c for c, keys in CATEGORIES if any(k in name for k in keys)), "other")


def by_category(rows) -> dict:
    out = {}
    for name, ms, _ in rows:
        cat = kernel_category(name)
        out[cat] = out.get(cat, 0.0) + ms
    return out


def bound(nbytes: float, nops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(shape, gen, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)


# ------------------------------------------------------------- kernel cases


def cases(cfg):
    """(kernel name, label, launches per scored render, launches per train
    step, make(dtype) -> (args, nbytes, nops)). A train step renders S*B
    fakes once, runs D over B real + S*B fakes (the D step) and over the S*B
    fakes (the G step); a scored render scores B final images."""
    s0, d = generator_plan(cfg.image_size)
    stages = cfg.n_stages
    n, code = stages * BATCH, cfg.code_size
    nf, cap = cfg.num_features, cfg.max_features
    hidden = code * cfg.lis_hidden_mult
    c0 = min(nf * 2 ** (d - 1), cap)
    c1 = min(nf * 2 ** (d - 2), cap)
    gen = torch.Generator().manual_seed(0)
    out = []

    def tprelu_case(m, c):
        def make(dt):
            e = torch.tensor([], dtype=dt).element_size()
            args = (randn((m, c), gen, 1.0, dt), torch.rand(c, generator=gen).cuda() * 0.5,
                    randn(c, gen, 0.1))
            return args, 2 * m * c * e + 2 * c * e, 6 * m * c
        return make

    acts = {}  # (rows, channels) -> [labels, per render, per step]

    def act(label, images, side, ch, per_render, per_step):
        row = acts.setdefault((images * side * side, ch), [[], 0, 0])
        row[0].append(label)
        row[1] += per_render
        row[2] += per_step

    for i in range(1, d):  # G: up{i}_act on the S*B stacked batch
        act(f"G up{i}_act", n, s0 * 2**i, min(nf * 2 ** (d - 1 - i), cap), 1, 1)
    for i in range(1, d):  # D: down{i}_act
        side, ci = cfg.image_size // 2 ** (i + 1), min(nf * 2**i, cap)
        act(f"D down{i}_act (score)", BATCH, side, ci, 1, 0)
        act(f"D down{i}_act (D step)", (1 + stages) * BATCH, side, ci, 0, 1)
        act(f"D down{i}_act (G step)", n, side, ci, 0, 1)
    for (m, c), (labels, per_render, per_step) in acts.items():
        out.append(("fused_tprelu", f"{', '.join(labels)} ({m}, {c})", per_render, per_step,
                    tprelu_case(m, c)))

    def lis_make(dt):
        e = torch.tensor([], dtype=dt).element_size()
        args = (randn((BATCH, code), gen, 1.0, dt), randn((code, hidden), gen, code**-0.5, dt),
                randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
                randn(hidden, gen, 0.1), randn((hidden, code), gen, hidden**-0.5, dt),
                randn(code, gen, 0.1))
        nbytes = e * (2 * BATCH * code + 2 * code * hidden) + 4 * (3 * hidden + code)
        return args, nbytes, 4 * BATCH * code * hidden

    out.append(("lis_residual_mlp", f"LIS link ({BATCH}, {code}) x ({code}, {hidden})",
                cfg.r_iterations, cfg.r_iterations, lis_make))

    def seed_case(n):
        def make(dt):
            e = torch.tensor([], dtype=dt).element_size()
            p = s0 * s0 * c0
            args = (randn((n, code), gen, 1.0, dt), randn((code, p), gen, code**-0.5, dt),
                    randn(p, gen, 0.1), torch.rand(c0, generator=gen).cuda() * 0.5,
                    randn(c0, gen, 0.1), randn((4, 4, c0, c1), gen, (16 * c0) ** -0.5, dt),
                    randn(c1, gen, 0.1), s0)
            nbytes = (e * (n * code + code * p + 16 * c0 * c1 + n * (2 * s0) ** 2 * c1)
                      + 4 * (p + 2 * c0 + c1))
            nops = 2 * n * code * p + 2 * n * (2 * s0) ** 2 * 4 * c0 * c1
            return args, nbytes, nops
        return make

    out.append(("fused_seed", f"seed ({n}, {code}) -> ({n}, {2 * s0}, {2 * s0}, {c1})",
                1, 1, seed_case(n)))
    # Shapes only the R trainers give the kernels (no G-LIS launch): R's
    # head activation, and R-iterative's single-stage render of a batch.
    out.append(("fused_tprelu", f"R head act ({BATCH}, {R_HIDDEN})", 0, 0,
                tprelu_case(BATCH, R_HIDDEN)))
    out.append(("fused_seed", f"R-iterative seed ({BATCH}, {code}) -> ({BATCH}, {2 * s0}, "
                f"{2 * s0}, {c1})", 0, 0, seed_case(BATCH)))
    return out


def seed_composite(z, wp, bp, slope, trans, wc_iohw, bc, s0):
    """The seed segment as library calls in z's dtype: cuBLAS GEMM with bias,
    TPReLU in eager ops, cuDNN transposed conv on a channels-last map. The
    weight is given in the library's (in, out, kh, kw) layout, prepared once
    outside the timed call."""
    h = torch.addmm(bp.to(z.dtype), z, wp).view(z.shape[0], s0, s0, -1)
    a, t = slope.to(z.dtype), trans.to(z.dtype)
    s = h - t
    h = s.clamp_min(0) + a * s.clamp_max(0) + t
    y = torch.nn.functional.conv_transpose2d(
        h.permute(0, 3, 1, 2), wc_iohw, bc.to(z.dtype), stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


PLAIN = {
    "fused_tprelu": ops.fused_tprelu_plain,
    "lis_residual_mlp": ops.lis_residual_mlp_plain,
    "fused_seed": ops.fused_seed_plain,
}
KERNEL = {
    "fused_tprelu": ops.fused_tprelu,
    "lis_residual_mlp": ops.lis_residual_mlp,
    "fused_seed": ops.fused_seed,
}


def compare(name, label, dt, got, want) -> float:
    """Hold a kernel's output against its plain version within TOL; return
    the largest |difference|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {label}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[name][dt]
    excess = (err - (atol + rtol * want.float().abs())).max().item()
    max_err = err.max().item()
    if not torch.isfinite(got).all() or excess > 0:
        raise AssertionError(
            f"{name} {label} {dt}: max |err| {max_err:.3e} beyond atol {atol} + rtol {rtol}")
    return max_err


def check_kernels(cfg) -> dict:
    floor_ms = empty_launch_ms()
    print(f"[floor] empty kernel launch {floor_ms:.4f} ms (device time under the same "
          f"harness)", flush=True)
    results = {}
    for name, label, per_render, per_step, make in cases(cfg):
        row = results.setdefault(name, {
            "name": name, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_parts": {"bytes": 0.0, "operations": 0.0},
            "render_ms": 0.0, "render_plain_ms": 0.0, "render_bound_ms": 0.0,
            "max_abs_err": 0.0, "max_abs_err_fp32": 0.0, "shapes": [],
            "composite_ms": None, "empty_launch_ms": floor_ms,
        })
        for dt in (torch.float32, torch.bfloat16):
            args, nbytes, nops = make(dt)
            max_err = compare(name, label, dt, KERNEL[name](*args), PLAIN[name](*args))
            atol, rtol = TOL[name][dt]
            k_ms = time_ms(lambda: KERNEL[name](*args))
            p_ms = time_ms(lambda: PLAIN[name](*args))
            b_ms, b_by = bound(nbytes, nops, dt)
            extra = ""
            c_ms = None
            if name == "fused_seed" and dt == torch.bfloat16:
                lib_args = list(args)
                lib_args[5] = args[5].permute(2, 3, 0, 1).contiguous()
                c_ms = time_ms(lambda: seed_composite(*lib_args))
                extra = f"  composite {c_ms:.4f} ms"
            print(f"[kernel] {name:16s} {label:44s} {str(dt)[6:]:8s} max|err| "
                  f"{max_err:.3e} (atol {atol}, rtol {rtol})  kernel {k_ms:.4f} ms  "
                  f"plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  empty launch "
                  f"{floor_ms:.4f} ms{extra}  x{per_render}/render x{per_step}/step", flush=True)
            if dt == torch.float32:
                row["max_abs_err_fp32"] = max(row["max_abs_err_fp32"], max_err)
                continue
            # bf16 is the main path's dtype: its times per train step make
            # the line; the times per scored render stay beside them.
            row["max_abs_err"] = max(row["max_abs_err"], max_err)
            row["ms"] += per_step * k_ms
            row["plain_ms"] += per_step * p_ms
            row["bound_ms"] += per_step * b_ms
            row["bound_parts"][b_by] += per_step * b_ms
            row["render_ms"] += per_render * k_ms
            row["render_plain_ms"] += per_render * p_ms
            row["render_bound_ms"] += per_render * b_ms
            if c_ms is not None:
                row["composite_ms"] = (row["composite_ms"] or 0.0) + per_step * c_ms
            row["shapes"].append({"shape": label, "per_render": per_render, "per_step": per_step,
                                  "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms})
            del args
    for row in results.values():
        row["bound_by"] = max(row["bound_parts"], key=row["bound_parts"].get)
        del row["bound_parts"]
    return results


def backward_cases(cfg):
    """(label, launches per train step, make(dtype) -> x, a, b, g) of
    TPReLU's backward at every TPReLU case's shape: each TPReLU of the
    step is differentiated, with da and db. g comes in x's dtype, as the
    bf16 step hands it on."""
    gen = torch.Generator().manual_seed(3)
    out = []
    for name, label, _, per_step, make in cases(cfg):
        if name == "fused_tprelu":
            def make_bwd(dt, make=make):
                (x, a, b), _, _ = make(dt)
                return x, a, b, randn(x.shape, gen, 0.1, dt)
            out.append((label, per_step, make_bwd))
    return out


def backward_cost(x, need_ab: bool) -> tuple:
    """(bytes, operations) of one TPReLU backward: x and g read and dx
    written once, a and b read and da and db written in fp32; about 4
    operations an element for dx, 6 more for the two products and sums."""
    m_c, c = x.numel(), x.shape[-1]
    return 3 * m_c * x.element_size() + 16 * c, (10 if need_ab else 4) * m_c


def function_backward_cost(name: str, args) -> tuple:
    """(bytes, operations) of one backward of `name`'s Function, every
    gradient asked for, from `gea`'s `_bwd`: each saved input it needs and
    the cotangent read once, each gradient written once (the small vectors
    in fp32); LIS recomputes the hidden row and runs four more products,
    the seed recomputes the projection, then takes its two gradients and
    the transposed conv's two."""
    if name == "fused_tprelu":
        return backward_cost(args[0], True)
    z = args[0]
    e = z.element_size()
    if name == "lis_residual_mlp":
        (b, c), h = z.shape, args[1].shape[1]
        return e * (3 * b * c + 4 * c * h) + 4 * (6 * h + c), 10 * b * c * h
    wp, wc, s0 = args[1], args[5], args[7]
    (n, code), p = z.shape, wp.shape[1]
    c0, c1, out = wc.shape[2], wc.shape[3], n * (2 * s0) ** 2 * wc.shape[3]
    conv = 2 * n * (2 * s0) ** 2 * 4 * c0 * c1
    return (e * (2 * n * code + 2 * code * p + 32 * c0 * c1 + out) + 4 * (2 * p + 4 * c0 + 2 * c1),
            6 * n * code * p + 2 * conv)


# TPReLU's backward: the kernel and its plain version round the same
# products to the same type and sum them in fp32, in another order, in both
# dtypes. Sound runs read about 5e-7 of the largest da and db; a kernel
# that left a bf16 rounding out reads about 1e-3 (`check_backward` prints
# what each left-out rounding would read).
BWD_SUM_TOL = 1e-5


def compare_backward(label: str, dt, args) -> tuple:
    """TPReLU's backward kernel against its plain version on `args` (x, a,
    b, g, need_ab): dx equal bit for bit (the same roundings, no sum), da
    and db within BWD_SUM_TOL of their largest magnitude (sums in another
    order). (largest relative da/db error, largest |error|)."""
    got, want = ops.fused_tprelu_backward(*args), ops.fused_tprelu_backward_plain(*args)
    torch.cuda.synchronize()
    if got[0].dtype != want[0].dtype or not torch.equal(got[0], want[0]):
        bad = (got[0].float() != want[0].float()).sum().item()
        raise AssertionError(f"fused_tprelu_backward {label} {dt}: dx differs from the plain "
                             f"version at {bad} elements ({got[0].dtype} vs {want[0].dtype})")
    rel, abs_err = 0.0, 0.0
    for what, k, p in (("da", got[1], want[1]), ("db", got[2], want[2])):
        if (k is None) != (p is None):
            raise AssertionError(f"fused_tprelu_backward {label}: {what} {k} vs {p}")
        if p is None:
            continue
        if k.dtype != p.dtype or not torch.isfinite(k).all():
            raise AssertionError(f"fused_tprelu_backward {label} {dt}: {what} {k.dtype} vs "
                                 f"{p.dtype}, finite {torch.isfinite(k).all().item()}")
        err = (k.float() - p.float()).abs().max().item()
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(p.float().abs().max().item(), 1e-30))
    if not rel <= BWD_SUM_TOL:
        raise AssertionError(f"fused_tprelu_backward {label} {dt}: da/db differ by {rel:.3e} "
                             f"of their max > {BWD_SUM_TOL}")
    return rel, abs_err


def left_out_roundings(x, a, b, g) -> dict:
    """What `compare_backward` would read (relative da/db error) from a
    kernel that left out one of the plain version's bf16 roundings: the
    products g*s and g*(1 - fprime) kept in fp32, or 1 - fprime kept in
    fp32 (products still rounded). Eager ops on the plain version's
    inputs; bf16 x and g."""
    _, da, db = ops.fused_tprelu_backward_plain(x, a, b, g)
    s = x - b.to(x.dtype)
    neg = s < 0
    q = 1 - torch.where(neg, a.to(x.dtype), torch.ones_like(x))  # 1 - fprime, in bf16
    q32 = 1 - torch.where(neg, a.to(x.dtype), torch.ones_like(x)).float()
    axes = tuple(range(x.dim() - 1))
    gf, zero = g.float(), torch.zeros((), device=x.device)
    variants = {
        "products in fp32": (torch.where(neg, gf * s.float(), zero).sum(axes),
                             (gf * q.float()).sum(axes)),
        "1 - fprime in fp32": (da, (gf * q32).to(torch.bfloat16).float().sum(axes)),
    }
    out = {}
    for what, (va, vb) in variants.items():
        out[what] = max(((v.float() - w.float()).abs().max() / w.float().abs().max()).item()
                        for v, w in ((va, da), (vb, db)))
    return out


def check_backward(cfg, rows: dict) -> None:
    """Phase 3 for TPReLU's backward kernel at every TPReLU case's shape,
    in fp32 and bf16, with da and db and without them: `compare_backward`,
    and the kernel's time beside the plain version's, the bound and the
    empty launch. The bf16 calls with da and db (the G-LIS step's) make
    its row, summed per train step."""
    floor_ms = rows["fused_tprelu"]["empty_launch_ms"]
    row = rows["fused_tprelu_backward"] = {
        "name": "fused_tprelu_backward", "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": "bytes", "render_ms": 0.0, "render_plain_ms": 0.0, "render_bound_ms": 0.0,
        "max_abs_err": 0.0, "max_abs_err_fp32": 0.0, "shapes": [], "composite_ms": None,
        "empty_launch_ms": floor_ms, "backward_ms": None, "backward_step_ms": None,
        "max_rel_err_da_db": 0.0, "left_out": {},
    }
    for label, per_step, make in backward_cases(cfg):
        for dt in (torch.float32, torch.bfloat16):
            x, a, b, g = make(dt)
            if dt == torch.bfloat16 and per_step:
                for what, r in left_out_roundings(x, a, b, g).items():
                    row["left_out"][what] = min(row["left_out"].get(what, 1.0), r)
                    print(f"[kernel] fused_tprelu_backward {label:44s} bf16 a kernel with "
                          f"{what} would read da/db max|err|/max {r:.3e} (tol {BWD_SUM_TOL})",
                          flush=True)
            for need in (True, False):
                args = (x, a, b, g, need)
                rel, abs_err = compare_backward(label, dt, args)
                k_ms = time_ms(lambda: ops.fused_tprelu_backward(*args))
                p_ms = time_ms(lambda: ops.fused_tprelu_backward_plain(*args))
                b_ms, b_by = bound(*backward_cost(x, need), dt)
                print(f"[kernel] fused_tprelu_backward {label:44s} {str(dt)[6:]:8s} "
                      f"{'dx, da, db' if need else 'dx only':10s} dx bit for bit; da/db "
                      f"max|err|/max {rel:.3e} (tol {BWD_SUM_TOL})  kernel {k_ms:.4f} ms  "
                      f"plain {p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  empty launch "
                      f"{floor_ms:.4f} ms  x{per_step if need else 0}/step", flush=True)
                row["max_rel_err_da_db"] = max(row["max_rel_err_da_db"], rel)
                key = "max_abs_err" if dt == torch.bfloat16 else "max_abs_err_fp32"
                row[key] = max(row[key], abs_err)
                if dt == torch.bfloat16 and need:
                    row["ms"] += per_step * k_ms
                    row["plain_ms"] += per_step * p_ms
                    row["bound_ms"] += per_step * b_ms
                    row["shapes"].append({"shape": label, "per_step": per_step, "ms": k_ms,
                                          "plain_ms": p_ms, "bound_ms": b_ms})
            del x, a, b, g
    print(f"[kernel] fused_tprelu_backward per G-LIS step (bf16, with da and db): kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms",
          flush=True)
    missed = row["left_out"]["products in fp32"]
    print(f"[kernel] fused_tprelu_backward: sound runs read at most {row['max_rel_err_da_db']:.3e}"
          f" of da/db's max; a kernel with a rounding left out at least {row['left_out']} (tol "
          f"{BWD_SUM_TOL})", flush=True)
    if not missed > BWD_SUM_TOL:
        raise AssertionError(f"BWD_SUM_TOL {BWD_SUM_TOL} would pass a kernel that left the bf16 "
                             f"product rounding out ({missed:.3e})")


# The seed's backward: the kernels and the plain version round dh and ds to
# z's dtype and sum in fp32, in other orders. fp32: each gradient within
# SEED_BWD_TOL of its max. bf16: another order of the fp32 sum behind dh can
# round an element of dh (so of ds) to the neighbouring bf16 value, and dz,
# dwp and dwc are rounded to bf16 themselves, so single elements move by a
# step of 2^-8 of their size: the max is held at 2e-2 of the gradient's max
# (as GRAD_TOL). A rounding left out moves every element instead: the mean
# |error| over the mean |gradient| of dwp, dbp and dwc (sums over the batch,
# short enough that the order of their fp32 sums leaves them nearly exact;
# sound runs read up to 4.6e-5 in bf16) is held at SEED_BWD_MEAN_TOL, and
# `check_seed_backward` prints what a kernel that left the ds rounding out
# would read (4.0e-4 on the H100). dz, dslope and dtrans sum over thousands
# of terms that cancel: there the order alone moves the mean by up to
# 1.2e-4.
SEED_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SEED_BWD_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.5e-4}
SEED_MEAN_CHECKED = ("dwp", "dbp", "dwc")
SEED_GRADS = ("dz", "dwp", "dbp", "dslope", "dtrans", "dwc", "dbc")
ALL_GRADS, DZ_ONLY = (True,) * 7, (True,) + (False,) * 6
WEIGHTS_ONLY = (False,) + (True,) * 6
SEED_NEEDS = {"every gradient": ALL_GRADS, "dz alone": DZ_ONLY, "weights alone": WEIGHTS_ONLY}


def seed_backward_cases(cfg):
    """(label, launches per G-LIS step, make(dtype) -> (z, wp, bp, slope,
    trans, wc, bc, g, s0)) at every seed case's shape, g in z's dtype."""
    gen = torch.Generator().manual_seed(4)
    out = []
    for name, label, _, per_step, make in cases(cfg):
        if name == "fused_seed":
            def make_bwd(dt, make=make):
                args, _, _ = make(dt)
                z, wc, s0 = args[0], args[5], args[7]
                return (*args[:7], randn((z.shape[0], 2 * s0, 2 * s0, wc.shape[3]), gen, 0.1, dt),
                        s0)
            out.append((label, per_step, make_bwd))
    return out


def seed_backward_cost(args, need) -> tuple:
    """(bytes, operations) of one seed backward: `function_backward_cost`
    with every gradient; else z, wp, wc, g, bp, slope and trans read and
    the gradients asked for written, and the projection recomputed, the
    conv's data gradient (for any of dz .. dtrans), dz's and dwp's products
    and dWc's as asked."""
    if all(need):
        return function_backward_cost("fused_seed", (*args[:7], args[8]))
    z, wp, wc, s0 = args[0], args[1], args[5], args[8]
    (n, code), p = z.shape, wp.shape[1]
    c0, c1 = wc.shape[2], wc.shape[3]
    out = n * (2 * s0) ** 2 * c1
    conv = 2 * out * 4 * c0
    e = z.element_size()
    return (e * (n * code * (1 + need[0]) + code * p * (1 + need[1]) + 16 * c0 * c1 * (1 + need[5])
                 + out) + 4 * (p * (1 + need[2]) + c0 * (2 + need[3] + need[4]) + 2 * c1 * need[6]),
            2 * n * code * p * (1 + need[0] + need[1]) + conv * (any(need[:5]) + need[5]))


def grad_errors(got, want, names=SEED_GRADS) -> dict:
    """{gradient: (max |err| / max |want|, mean |err| / mean |want|, max |err|)}."""
    out = {}
    for what, k, w in zip(names, got, want):
        if w is None:
            continue
        err = (k.float() - w.float()).abs()
        out[what] = ((err.max() / w.float().abs().max().clamp_min(1e-30)).item(),
                     (err.mean() / w.float().abs().mean().clamp_min(1e-30)).item(),
                     err.max().item())
    return out


def compare_seed_backward(label: str, dt, args, need) -> tuple:
    """The seed's backward kernels against the plain version on `args` (z,
    wp, bp, slope, trans, wc, bc, g, s0): gradients not asked for None,
    each asked for in its input's dtype, finite, within SEED_BWD_TOL of its
    max, and dwp, dbp and dwc within SEED_BWD_MEAN_TOL of their mean.
    (largest max-relative error, largest mean-relative error of those three,
    largest |error|)."""
    got = ops.fused_seed_backward(*args, need)
    want = ops.fused_seed_backward_plain(*args, need)
    torch.cuda.synchronize()
    for what, k, w, x in zip(SEED_GRADS, got, want, args):
        if (k is None) != (w is None):
            raise AssertionError(f"fused_seed_backward {label}: {what} {k} vs {w}")
        if w is not None and (k.dtype != w.dtype or k.dtype != x.dtype
                              or not torch.isfinite(k).all()):
            raise AssertionError(f"fused_seed_backward {label} {dt}: {what} {k.dtype} vs "
                                 f"{w.dtype}, finite {torch.isfinite(k).all().item()}")
    errs = grad_errors(got, want)
    for what, (rel, mean_rel, _) in errs.items():
        if not (rel <= SEED_BWD_TOL[dt] and (what not in SEED_MEAN_CHECKED
                                             or mean_rel <= SEED_BWD_MEAN_TOL[dt])):
            raise AssertionError(
                f"fused_seed_backward {label} {dt}: {what} differs by {rel:.3e} of its max "
                f"(tol {SEED_BWD_TOL[dt]}), {mean_rel:.3e} of its mean (tol "
                f"{SEED_BWD_MEAN_TOL[dt]} for {SEED_MEAN_CHECKED})")
    return (max(v[0] for v in errs.values()),
            max([v[1] for k, v in errs.items() if k in SEED_MEAN_CHECKED], default=0.0),
            max(v[2] for v in errs.values()))


def seed_left_out_rounding(args) -> float:
    """What `compare_seed_backward` would read (the larger mean-relative
    error of dwp and dbp) from a kernel that left out the plain
    version's rounding of ds to bf16: eager ops on the same inputs, dh from
    cuDNN rounded to bf16 as the plain version rounds it."""
    z, wp, bp, slope, trans, wc, bc, g, s0 = args
    n, c0 = z.shape[0], wc.shape[2]
    s = (z.double() @ wp.double()).float().add(bp.float()).view(n, s0, s0, c0) - trans.float()
    dh = torch.nn.functional.conv2d(g.float().permute(0, 3, 1, 2), wc.float().permute(2, 3, 0, 1),
                                    stride=2, padding=1).permute(0, 2, 3, 1)
    dh = dh.to(z.dtype).float()
    ds = torch.where(s < 0, slope.float() * dh, dh).reshape(n, -1)
    variant = [None, (z.float().t() @ ds).to(wp.dtype), ds.sum(0)]
    want = ops.fused_seed_backward_plain(*args, (False, True, True) + (False,) * 4)[:3]
    return max(v[1] for v in grad_errors(variant, want).values())


def check_seed_backward(cfg, rows: dict) -> None:
    """Phase 3 for the seed's backward kernels at both seed shapes (the
    G-LIS step's stacked codes and R-iterative's batch), in fp32 and bf16,
    with every gradient, with dz alone (a frozen G's) and with the weights
    alone: `compare_seed_backward`, a second call equal to the first bit
    for bit (the kernels sum in a fixed order), and the time beside the
    plain version's, the
    bound and the empty launch; in bf16 with every gradient also the
    backward of the bf16 library composite (`seed_composite` under
    autograd: cuBLAS and cuDNN, a yardstick the port never calls) and what a
    kernel that left the ds rounding out would read. The bf16 calls with
    every gradient (the G-LIS step's) make its row, summed per train
    step."""
    floor_ms = rows["fused_seed"]["empty_launch_ms"]
    row = rows["fused_seed_backward"] = {
        "name": "fused_seed_backward", "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": "operations", "render_ms": 0.0, "render_plain_ms": 0.0,
        "render_bound_ms": 0.0, "max_abs_err": 0.0, "max_abs_err_fp32": 0.0, "shapes": [],
        "composite_ms": None, "empty_launch_ms": floor_ms, "backward_ms": None,
        "backward_step_ms": None, "max_rel_err": {}, "max_mean_rel_err": {},
        "left_out_ds_rounding": None,
    }
    for label, per_step, make in seed_backward_cases(cfg):
        for dt in (torch.float32, torch.bfloat16):
            args = make(dt)
            for what, need in SEED_NEEDS.items():
                rel, mean_rel, abs_err = compare_seed_backward(label, dt, args, need)
                first = ops.fused_seed_backward(*args, need)
                again = ops.fused_seed_backward(*args, need)
                if not all(a is None or torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"fused_seed_backward {label} {dt} {what}: two calls on "
                                         f"the same inputs differ")
                del first, again
                k_ms = time_ms(lambda: ops.fused_seed_backward(*args, need))
                p_ms = time_ms(lambda: ops.fused_seed_backward_plain(*args, need))
                b_ms, b_by = bound(*seed_backward_cost(args, need), dt)
                key = f"{str(dt)[6:]} {what}"
                row["max_rel_err"][key] = max(row["max_rel_err"].get(key, 0.0), rel)
                row["max_mean_rel_err"][key] = max(row["max_mean_rel_err"].get(key, 0.0), mean_rel)
                err_key = "max_abs_err" if dt == torch.bfloat16 else "max_abs_err_fp32"
                row[err_key] = max(row[err_key], abs_err)
                extra = ""
                if dt == torch.bfloat16 and need == ALL_GRADS:
                    leaves = [a.detach().clone().requires_grad_(True) for a in args[:7]]
                    lib = list(leaves) + [args[8]]
                    lib[5] = leaves[5].permute(2, 3, 0, 1)
                    out = seed_composite(*lib)
                    c_ms = time_ms(lambda: torch.autograd.grad(out, leaves, args[7],
                                                               retain_graph=True))
                    missed = seed_left_out_rounding(args)
                    row["left_out_ds_rounding"] = min(row["left_out_ds_rounding"] or 1.0, missed)
                    extra = (f"  composite backward {c_ms:.4f} ms; a kernel without the ds "
                             f"rounding would read {missed:.3e} of the mean")
                    if per_step:
                        row["ms"] += per_step * k_ms
                        row["plain_ms"] += per_step * p_ms
                        row["bound_ms"] += per_step * b_ms
                        row["composite_ms"] = (row["composite_ms"] or 0.0) + per_step * c_ms
                    row["shapes"].append({"shape": label, "per_step": per_step, "ms": k_ms,
                                          "plain_ms": p_ms, "bound_ms": b_ms,
                                          "composite_ms": c_ms})
                    del out, leaves, lib
                print(f"[kernel] fused_seed_backward {label:44s} {str(dt)[6:]:8s} {what:14s} "
                      f"max|err|/max {rel:.3e} (tol {SEED_BWD_TOL[dt]}), mean|err|/mean "
                      f"{mean_rel:.3e} (tol {SEED_BWD_MEAN_TOL[dt]})  kernel {k_ms:.4f} ms  plain "
                      f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  empty launch "
                      f"{floor_ms:.4f} ms{extra}  two calls bit for bit  "
                      f"x{per_step if need == ALL_GRADS else 0}/step", flush=True)
            del args
    print(f"[kernel] fused_seed_backward per G-LIS step (bf16, every gradient): kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, composite backward "
          f"{row['composite_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms", flush=True)
    missed = row["left_out_ds_rounding"]
    print(f"[kernel] fused_seed_backward: sound runs read at most {row['max_mean_rel_err']} of "
          f"the mean; a kernel without the ds rounding at least {missed:.3e} (tol "
          f"{SEED_BWD_MEAN_TOL[torch.bfloat16]})", flush=True)
    if not missed > SEED_BWD_MEAN_TOL[torch.bfloat16]:
        raise AssertionError(f"SEED_BWD_MEAN_TOL {SEED_BWD_MEAN_TOL[torch.bfloat16]} would pass a "
                             f"kernel that left the ds rounding out ({missed:.3e})")


# LIS's backward: the kernel and the plain version compute pre exactly, round
# h and dh_pre to z's dtype before the products that take them, and sum in
# fp32, in other orders. fp32: each gradient within LIS_BWD_TOL of its max.
# bf16: another order of the fp32 sum behind dh can round an element of
# dh_pre to the neighbouring bf16 value, and dz, dw1 and dw2 are rounded to
# bf16 themselves, so single elements move by a step of 2^-8 of their size:
# the max is held at 2e-2 of the gradient's max (as GRAD_TOL). A rounding
# left out moves every element instead: the mean |error| over the mean
# |gradient| of dz, dw1 and dw2 is held at LIS_BWD_MEAN_TOL, and
# `check_lis_backward` prints what a kernel that left the roundings of h
# and dh_pre out would read, which must exceed it.
LIS_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LIS_BWD_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.5e-4}
LIS_MEAN_CHECKED = ("dz", "dw1", "dw2")
LIS_GRADS = ("dz", "dw1", "db1", "dslope", "dtrans", "dw2", "db2")
LIS_NEEDS = {"every gradient": ALL_GRADS, "dz alone": DZ_ONLY, "weights alone": WEIGHTS_ONLY}


def lis_backward_args(batch, code, hidden, dt, gen) -> tuple:
    """(z, w1, b1, slope, trans, w2, g) of one link, g in z's dtype."""
    return (randn((batch, code), gen, 1.0, dt), randn((code, hidden), gen, code**-0.5, dt),
            randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
            randn(hidden, gen, 0.1), randn((hidden, code), gen, hidden**-0.5, dt),
            randn((batch, code), gen, 0.1, dt))


def lis_near_zero(args) -> tuple:
    """`args` with every even row of z a copy of row 0 and b1 = trans -
    pre of that row (pre exact: fp64, rounded once to fp32), so that those
    rows' s = pre - trans lies within rounding of 0 in every hidden column.
    Also the number of elements whose branch an fp32 product z @ w1 would
    take the other way (the case bites where it is not 0)."""
    z, w1, _, slope, trans, w2, g = args
    z = z.clone()
    z[::2] = z[0]
    b1 = trans - (z[0].double() @ w1.double()).float()
    exact = (z.double() @ w1.double()).float() + b1 - trans < 0
    fp32 = z.float() @ w1.float() + b1 - trans < 0
    return (z, w1, b1, slope, trans, w2, g), int((exact != fp32).sum().item())


def lis_backward_cost(args, need) -> tuple:
    """(bytes, operations) of one LIS backward: `function_backward_cost`
    with every gradient; with dz alone z, w1, w2, b1, slope, trans and g
    read, dz written, and pre, dh and dz's products; with the weights alone
    z, g, the weights and vectors read, every gradient but dz written, and
    pre, dh and the two weight products."""
    z, w1 = args[0], args[1]
    (b, c), h = z.shape, w1.shape[1]
    e = z.element_size()
    if all(need):
        return function_backward_cost("lis_residual_mlp", args)
    if need == DZ_ONLY:
        return e * (3 * b * c + 2 * c * h) + 4 * 3 * h, 6 * b * c * h
    return e * (2 * b * c + 4 * c * h) + 4 * (6 * h + c), 8 * b * c * h


def compare_lis_backward(label: str, dt, args, need) -> tuple:
    """LIS's backward kernel against its plain version on `args` (z, w1,
    b1, slope, trans, w2, g): gradients not asked for None, each asked for
    in its input's dtype (db2 fp32), finite, within LIS_BWD_TOL of its max,
    and dz, dw1 and dw2 within LIS_BWD_MEAN_TOL of their mean. (largest
    max-relative error, largest mean-relative error of those three,
    largest |error|)."""
    got = ops.lis_residual_mlp_backward(*args, need)
    want = ops.lis_residual_mlp_backward_plain(*args, need)
    torch.cuda.synchronize()
    likes = (*args[:6], torch.zeros((), device="cuda"))
    for what, k, w, x in zip(LIS_GRADS, got, want, likes):
        if (k is None) != (w is None):
            raise AssertionError(f"lis_residual_mlp_backward {label}: {what} {k} vs {w}")
        if w is not None and (k.dtype != w.dtype or k.dtype != x.dtype or k.shape != w.shape
                              or not torch.isfinite(k).all()):
            raise AssertionError(f"lis_residual_mlp_backward {label} {dt}: {what} {k.dtype} "
                                 f"{tuple(k.shape)} vs {w.dtype} {tuple(w.shape)}, finite "
                                 f"{torch.isfinite(k).all().item()}")
    errs = grad_errors(got, want, LIS_GRADS)
    for what, (rel, mean_rel, _) in errs.items():
        if not (rel <= LIS_BWD_TOL[dt] and (what not in LIS_MEAN_CHECKED
                                            or mean_rel <= LIS_BWD_MEAN_TOL[dt])):
            raise AssertionError(
                f"lis_residual_mlp_backward {label} {dt}: {what} differs by {rel:.3e} of its "
                f"max (tol {LIS_BWD_TOL[dt]}), {mean_rel:.3e} of its mean (tol "
                f"{LIS_BWD_MEAN_TOL[dt]} for {LIS_MEAN_CHECKED})")
    return (max(v[0] for v in errs.values()),
            max([v[1] for k, v in errs.items() if k in LIS_MEAN_CHECKED], default=0.0),
            max(v[2] for v in errs.values()))


def lis_left_out_rounding(args) -> float:
    """What `compare_lis_backward` would read (the largest mean-relative
    error of dz, dw1 and dw2) from a kernel that left out the plain
    version's roundings of h and dh_pre to bf16: eager ops on the same
    inputs, pre exact."""
    z, w1, b1, slope, trans, w2, g = args
    s = (z.double() @ w1.double()).float() + b1 - trans
    neg = s < 0
    gf = g.float()
    h = torch.where(neg, slope * s, s) + trans
    dh_pre = (gf @ w2.float().t()) * torch.where(neg, slope, 1.0)
    variant = [(gf + dh_pre @ w1.float().t()).to(z.dtype), (z.float().t() @ dh_pre).to(w1.dtype),
               None, None, None, (h.t() @ gf).to(w2.dtype), None]
    want = ops.lis_residual_mlp_backward_plain(*args, (True, True, False, False, False, True,
                                                       False))
    return max(v[1] for v in grad_errors(variant, want, LIS_GRADS).values())


def check_lis_backward(cfg, rows: dict) -> None:
    """Phase 3 for LIS's backward kernel at the G-LIS step's link shape and
    at its near-zero case (`lis_near_zero`), in fp32 and bf16, with every
    gradient, dz alone (a frozen link's) and the weights alone (a first
    link's, whose z is drawn): `compare_lis_backward`, and the time beside
    the plain version's, the bound and the empty launch; in bf16 also what
    a kernel that left the roundings of h and dh_pre out would read. The
    bf16 calls make its row, summed per train step: every gradient for all
    links but the first, the weights alone for the first."""
    floor_ms = rows["lis_residual_mlp"]["empty_launch_ms"]
    row = rows["lis_residual_mlp_backward"] = {
        "name": "lis_residual_mlp_backward", "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": "bytes", "render_ms": 0.0, "render_plain_ms": 0.0, "render_bound_ms": 0.0,
        "max_abs_err": 0.0, "max_abs_err_fp32": 0.0, "shapes": [], "composite_ms": None,
        "empty_launch_ms": floor_ms, "backward_ms": None, "backward_step_ms": None,
        "max_rel_err": {}, "max_mean_rel_err": {}, "left_out_roundings": None,
        "near_zero_fp32_flips": {},
    }
    gen = torch.Generator().manual_seed(5)
    code, hidden = cfg.code_size, cfg.code_size * cfg.lis_hidden_mult
    links = cfg.r_iterations
    per_step = {"every gradient": links - 1, "dz alone": 0, "weights alone": 1}
    for case in ("flagship", "near zero"):
        for dt in (torch.float32, torch.bfloat16):
            args = lis_backward_args(BATCH, code, hidden, dt, gen)
            label = f"LIS link ({BATCH}, {code}) x ({code}, {hidden})"
            if case == "near zero":
                args, flips = lis_near_zero(args)
                row["near_zero_fp32_flips"][str(dt)[6:]] = flips
                label += f" near zero ({flips} fp32 flips)"
            for what, need in LIS_NEEDS.items():
                rel, mean_rel, abs_err = compare_lis_backward(label, dt, args, need)
                key = f"{str(dt)[6:]} {what}"
                row["max_rel_err"][key] = max(row["max_rel_err"].get(key, 0.0), rel)
                row["max_mean_rel_err"][key] = max(row["max_mean_rel_err"].get(key, 0.0), mean_rel)
                err_key = "max_abs_err" if dt == torch.bfloat16 else "max_abs_err_fp32"
                row[err_key] = max(row[err_key], abs_err)
                times = ""
                if case == "flagship":
                    k_ms = time_ms(lambda: ops.lis_residual_mlp_backward(*args, need))
                    p_ms = time_ms(lambda: ops.lis_residual_mlp_backward_plain(*args, need))
                    b_ms, b_by = bound(*lis_backward_cost(args, need), dt)
                    times = (f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound {b_ms:.4f} ms "
                             f"({b_by})  empty launch {floor_ms:.4f} ms  x{per_step[what]}/step")
                    if dt == torch.bfloat16:
                        row["ms"] += per_step[what] * k_ms
                        row["plain_ms"] += per_step[what] * p_ms
                        row["bound_ms"] += per_step[what] * b_ms
                        row["shapes"].append({"shape": f"{label} {what}",
                                              "per_step": per_step[what], "ms": k_ms,
                                              "plain_ms": p_ms, "bound_ms": b_ms})
                print(f"[kernel] lis_residual_mlp_backward {label:44s} {str(dt)[6:]:8s} "
                      f"{what:14s} max|err|/max {rel:.3e} (tol {LIS_BWD_TOL[dt]}), mean|err|/mean "
                      f"{mean_rel:.3e} (tol {LIS_BWD_MEAN_TOL[dt]}){times}", flush=True)
            if dt == torch.bfloat16:
                missed = lis_left_out_rounding(args)
                row["left_out_roundings"] = min(row["left_out_roundings"] or 1.0, missed)
                print(f"[kernel] lis_residual_mlp_backward {label:44s} bf16 a kernel without "
                      f"the roundings of h and dh_pre would read {missed:.3e} of the mean (tol "
                      f"{LIS_BWD_MEAN_TOL[dt]})", flush=True)
            del args
    print(f"[kernel] lis_residual_mlp_backward per G-LIS step (bf16, {links - 1} with every "
          f"gradient, 1 with the weights alone): kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, empty launch "
          f"{floor_ms:.4f} ms", flush=True)
    missed = row["left_out_roundings"]
    print(f"[kernel] lis_residual_mlp_backward: sound runs read at most {row['max_mean_rel_err']} "
          f"of the mean; a kernel without the roundings at least {missed:.3e} (tol "
          f"{LIS_BWD_MEAN_TOL[torch.bfloat16]}); fp32 products would flip "
          f"{row['near_zero_fp32_flips']} branches of the near-zero case", flush=True)
    if not missed > LIS_BWD_MEAN_TOL[torch.bfloat16]:
        raise AssertionError(f"LIS_BWD_MEAN_TOL {LIS_BWD_MEAN_TOL[torch.bfloat16]} would pass a "
                             f"kernel that left the roundings of h and dh_pre out ({missed:.3e})")


def check_edges() -> dict:
    """Shapes the flagship never reaches, which exercise the kernels' masks:
    a ragged batch, the smallest and largest s0, widths that are not tile
    multiples. Each kernel against its plain version at the stated TOL."""
    gen = torch.Generator().manual_seed(1)
    errs = {}
    seed_shapes = [  # (batch, code, s0, c0, c1)
        (33, 256, 4, 256, 96),
        (33, 40, 7, 256, 96),
        (7, 256, 5, 512, 256),
        (9, 256, 5, 512, 512),  # config 5's widths (the DP step's)
    ]
    # (batch, code, hidden): batches that are not a multiple of the
    # forward's row tile or the backward's chunk, widths below one tile, one
    # row, and lis_hidden_mult 2 (the backward then walks the batch in smaller chunks).
    lis_shapes = [(30, 256, 256), (30, 40, 48), (1, 256, 512), (17, 256, 256), (33, 256, 256),
                  (128, 256, 256), (64, 256, 512)]
    # (rows, channels): C not a power of two, one row, rows that are not a
    # multiple of the backward's tile (32 rows at C = 64) nor of the forward's;
    # the backward with da and db at each, and at each one more case: dx
    # only, or an fp32 cotangent into bf16 x (eager promotion: the products
    # in fp32; with fp32 x that is the first case again).
    tprelu_shapes = [((777, 3), "dx only"), ((130, 5), "fp32 g"), ((333, 96), "dx only"),
                     ((45, 1000), "fp32 g"), ((1, 64), "dx only"), ((4097, 64), "fp32 g"),
                     ((3, 2, 7, 96), "dx only")]
    for dt in (torch.float32, torch.bfloat16):
        for shape, extra in tprelu_shapes:
            c = shape[-1]
            x, g = randn(shape, gen, 1.0, dt), randn(shape, gen, 0.1, dt)
            a, b = torch.rand(c, generator=gen).cuda() * 0.5, randn(c, gen, 0.1)
            label = f"TPReLU {shape}"
            errs[f"{label} {str(dt)[6:]}"] = compare("fused_tprelu", label, dt, ops.fused_tprelu(
                x, a, b), ops.fused_tprelu_plain(x, a, b))
            variants = [(g, True)]
            if extra == "dx only":
                variants.append((g, False))
            elif dt == torch.bfloat16:
                variants.append((g.float(), True))
            for g_, need in variants:
                what = (f"backward {label} g {str(g_.dtype)[6:]} "
                        f"{'dx, da, db' if need else 'dx only'}")
                errs[f"{what} {str(dt)[6:]}"] = compare_backward(what, dt, (x, a, b, g_, need))[0]
    for dt in (torch.float32, torch.bfloat16):
        for batch, code, s0, c0, c1 in seed_shapes:
            p = s0 * s0 * c0
            args = (randn((batch, code), gen, 1.0, dt), randn((code, p), gen, code**-0.5, dt),
                    randn(p, gen, 0.1), torch.rand(c0, generator=gen).cuda() * 0.5,
                    randn(c0, gen, 0.1), randn((4, 4, c0, c1), gen, (16 * c0) ** -0.5, dt),
                    randn(c1, gen, 0.1), s0)
            label = f"seed batch {batch} code {code} s0 {s0} c0 {c0} c1 {c1}"
            errs[f"{label} {str(dt)[6:]}"] = compare(
                "fused_seed", label, dt, ops.fused_seed(*args), ops.fused_seed_plain(*args))
            g = randn((batch, 2 * s0, 2 * s0, c1), gen, 0.1, dt)
            for need in (ALL_GRADS, DZ_ONLY):
                what = f"backward {label} {'every gradient' if need == ALL_GRADS else 'dz alone'}"
                errs[f"{what} {str(dt)[6:]}"] = compare_seed_backward(
                    what, dt, (*args[:7], g, s0), need)[0]
        for batch, code, hidden in lis_shapes:
            args = (randn((batch, code), gen, 1.0, dt), randn((code, hidden), gen, code**-0.5, dt),
                    randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
                    randn(hidden, gen, 0.1), randn((hidden, code), gen, hidden**-0.5, dt),
                    randn(code, gen, 0.1))
            label = f"LIS batch {batch} code {code} hidden {hidden}"
            errs[f"{label} {str(dt)[6:]}"] = compare(
                "lis_residual_mlp", label, dt, ops.lis_residual_mlp(*args),
                ops.lis_residual_mlp_plain(*args))
            g = randn((batch, code), gen, 0.1, dt)
            for what, need in LIS_NEEDS.items():
                errs[f"backward {label} {what} {str(dt)[6:]}"] = compare_lis_backward(
                    f"backward {label} {what}", dt, (*args[:6], g), need)[0]
    for k, v in errs.items():
        print(f"[edge] {k:52s} max|err| {v:.3e}", flush=True)
    return errs


# ------------------------------------------------------- kernel gradients

# Tolerance on max |Function grad - plain grad| / max |plain grad|, per input
# and dtype. fp32: the same arithmetic in another order. bf16: autograd
# through the plain version rounds intermediate gradients to bf16 where the
# explicit backwards keep fp32 (the TPReLU's per-channel sums, LIS's hidden
# gradient), a few steps of 2^-8 relative.
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def check_grads(cfg, kernel_rows: dict) -> dict:
    """Each kernel's Function (kernel forward; the backwards of TPReLU and
    the seed kernels too, LIS's eager) against autograd through its plain
    version at every case's shape (the R
    trainers differentiate through the scoring and R-only shapes too), for
    one random cotangent; the device time of each Function's backward in
    bf16 at the train step's shapes, summed per train step into the
    kernel's row, under the train step's TF32 settings."""
    gen = torch.Generator().manual_seed(2)
    errs = {}
    for name, label, _, per_step, make in cases(cfg):
        row = kernel_rows[name]
        row.setdefault("backward_ms", 0.0)
        row.setdefault("backward_bound_ms", 0.0)
        for dt in (torch.float32, torch.bfloat16):
            args, _, _ = make(dt)
            grads, backward, cot = [], None, None
            for fn in (KERNEL[name], PLAIN[name]):
                leaves = [a.detach().clone().requires_grad_(True) if torch.is_tensor(a) else a
                          for a in args]
                out = fn(*leaves)
                if cot is None:
                    cot = (torch.randn(out.shape, generator=gen) * 0.1).to("cuda", out.dtype)
                inputs = [t for t in leaves if torch.is_tensor(t)]
                grads.append(torch.autograd.grad(out, inputs, cot, retain_graph=True))
                if backward is None:  # the Function's, timed below
                    backward = lambda out=out, inputs=inputs: torch.autograd.grad(  # noqa: E731
                        out, inputs, cot, retain_graph=True)
            torch.cuda.synchronize()
            rel = 0.0
            for i, (gk, gp) in enumerate(zip(*grads)):
                if gk.dtype != gp.dtype or not torch.isfinite(gk).all():
                    raise AssertionError(f"{name} {label} {dt} grad {i}: {gk.dtype} vs {gp.dtype}")
                scale = gp.float().abs().max().item()
                rel = max(rel, (gk.float() - gp.float()).abs().max().item() / max(scale, 1e-30))
            if not rel <= GRAD_TOL[dt]:
                raise AssertionError(f"{name} {label} {dt}: gradients differ by {rel:.3e} of "
                                     f"their max > {GRAD_TOL[dt]}")
            extra = ""
            if dt == torch.bfloat16 and per_step:
                with cudnn_tf32():  # as the train step is timed
                    bwd_ms = time_ms(backward)
                b_ms, b_by = bound(*function_backward_cost(name, args), dt)
                row["backward_ms"] += per_step * bwd_ms
                row["backward_bound_ms"] += per_step * b_ms
                extra = (f"  backward {bwd_ms:.4f} ms (bound {b_ms:.4f} ms, {b_by}) "
                         f"x{per_step}/step")
            errs[f"{name} {label} {str(dt)[6:]}"] = rel
            print(f"[grad] {name:16s} {label:60s} {str(dt)[6:]:8s} kernel forward, "
                  f"{BACKWARD_KIND[name]}: max|err|/max|grad| {rel:.3e} (tol "
                  f"{GRAD_TOL[dt]}){extra}", flush=True)
            del args, grads, backward
    for name in PORT_BACKWARD.values():
        row = kernel_rows[name]
        print(f"[grad] {name} backward ({BACKWARD_KIND[name]}) per G-LIS step, bf16: "
              f"{row['backward_ms']:.4f} ms, bound {row['backward_bound_ms']:.4f} ms", flush=True)
    return errs


# ------------------------------------------------------------- serving path


def serving(cfg, kernel_rows: dict) -> dict:
    g_params = init_generator_params(cfg, seed=0)
    d_params = init_discriminator_params(cfg, seed=1)
    model = ServingModel.from_modules(generator_from_jax_params(g_params, cfg),
                                      discriminator_from_jax_params(d_params, cfg))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = model.sample_filtered(COUNT, seed=0, oversample=OVERSAMPLE, batch_size=BATCH)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    renders = COUNT * OVERSAMPLE // BATCH
    n_act = 2 * (generator_plan(cfg.image_size)[1] - 1)
    want = {"fused_tprelu": n_act * renders, "fused_tprelu_backward": 0,
            "lis_residual_mlp": cfg.r_iterations * renders, "lis_residual_mlp_backward": 0,
            "fused_seed": renders, "fused_seed_backward": 0}
    print(f"[serve] launch counts over {renders} renders: {counts} (want {want})", flush=True)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for name, n in counts.items():
        kernel_rows[name]["launches_serving"] = {"sample_filtered, live modules": n}

    s = cfg.image_size
    expect = {"images": ((COUNT, s, s, 3), np.uint8),
              "stages": ((cfg.r_iterations + 1, COUNT, s, s, 3), np.uint8),
              "scores": ((COUNT,), np.float32)}
    for k, (shape, dt) in expect.items():
        if best[k].shape != shape or best[k].dtype != dt:
            raise AssertionError(f"{k}: {best[k].shape} {best[k].dtype}, want {shape} {dt}")
    sc = best["scores"]
    if not (np.isfinite(sc).all() and (sc >= 0).all() and (sc <= 1).all()):
        raise AssertionError(f"scores outside [0, 1]: {sc}")
    if not (np.diff(sc) <= 0).all():
        raise AssertionError("scores are not sorted by descending score")
    if np.array_equal(best["images"].min(), best["images"].max()):
        raise AssertionError("every pixel of every image is the same")
    print(f"[serve] sample_filtered ok: images {best['images'].shape}, scores "
          f"[{sc.min():.6f}, {sc.max():.6f}], first call {first_s:.3f} s", flush=True)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample_filtered(COUNT, seed=1, oversample=OVERSAMPLE, batch_size=BATCH)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    # Device time of one render + score of a batch, kernels vs plain versions.
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, cfg.code_size)).astype(np.float32)).cuda()
    plain = ServingModel.from_modules(
        generator_from_jax_params(g_params, cfg, use_kernels=False),
        discriminator_from_jax_params(d_params, cfg, use_kernels=False))

    def render_fn(m):
        g, d = m.exported.generator, m.exported.discriminator

        def run():
            imgs, _ = g.render(z)
            return d(imgs[-1])
        return run

    # Device busy share of one call, and where one render + score spends it.
    busy_ms, _ = device_profile(
        lambda: model.sample_filtered(COUNT, seed=1, oversample=OVERSAMPLE, batch_size=BATCH))
    with torch.inference_mode():
        render_profiled_ms, top = device_profile(render_fn(model))
        render_ms = time_ms(render_fn(model), RENDER_SPIN_CYCLES)
        render_plain_ms = time_ms(render_fn(plain), RENDER_SPIN_CYCLES)
        bf16_k, _ = model.exported.generator.render(z)
        bf16_p, _ = plain.exported.generator.render(z)
        bf16_diff = (bf16_k - bf16_p).abs().max().item()

    result = {
        "sample_filtered_s": wall,
        "candidates_per_s": COUNT * OVERSAMPLE / wall,
        "delivered_per_s": COUNT / wall,
        "render_score_ms": render_ms,
        "render_score_plain_ms": render_plain_ms,
        "rendered_images_per_s_device": cfg.n_stages * BATCH / render_ms * 1e3,
        "bf16_render_kernel_vs_plain_max_abs": bf16_diff,
        "sample_filtered_device_busy_ms": busy_ms,
        "sample_filtered_device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "render_score_profiled_ms": render_profiled_ms,
        "render_score_by_category": by_category(top),
        "render_score_by_kernel": [{"name": n[:90], "ms": t, "count": c} for n, t, c in top[:14]],
    }
    print(f"[serve] sample_filtered({COUNT}, oversample={OVERSAMPLE}, batch_size={BATCH}) "
          f"median of 3: {wall:.4f} s = {result['candidates_per_s']:.1f} candidates/s, "
          f"{result['delivered_per_s']:.1f} delivered/s", flush=True)
    print(f"[serve] sample_filtered device busy {busy_ms:.3f} ms of {wall * 1e3:.3f} ms wall: "
          f"idle share {result['sample_filtered_device_idle_share']:.3f} (torch.profiler)",
          flush=True)
    print(f"[serve] one render+score under torch.profiler: {render_profiled_ms:.4f} ms of device "
          f"time in {sum(c for _, _, c in top)} kernels and copies; the largest:", flush=True)
    for n, t, c in top[:14]:
        print(f"[serve] render+score by kernel: {t:8.4f} ms x{c:<3d} {n[:90]}", flush=True)
    for cat, t in sorted(result["render_score_by_category"].items(), key=lambda kv: -kv[1]):
        print(f"[serve] render+score by category: {t:8.4f} ms {cat}", flush=True)
    print(f"[serve] one render+score of {BATCH} codes ({cfg.n_stages * BATCH} images): "
          f"kernels {render_ms:.3f} ms, plain versions {render_plain_ms:.3f} ms; bf16 "
          f"render kernel-vs-plain max |diff| {bf16_diff:.3e} (information only)", flush=True)
    del model, plain
    return result


def fp32_agreement(cfg) -> dict:
    """The same fp32 render + score with kernels and with plain versions."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g_params = init_generator_params(cfg32, seed=0)
    d_params = init_discriminator_params(cfg32, seed=1)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, cfg.code_size)).astype(np.float32)).cuda()
    outs = []
    with torch.inference_mode():
        for use_kernels in (True, False):
            g = generator_from_jax_params(g_params, cfg32, use_kernels=use_kernels)
            d = discriminator_from_jax_params(d_params, cfg32, use_kernels=use_kernels)
            imgs, zs = g.render(z)
            outs.append((imgs, zs, torch.sigmoid(d(imgs[-1]))))
            del g, d
    (ik, zk, sk), (ip, zp, sp) = outs
    errs = {
        "images": (ik - ip).abs().max().item(),
        "zs": (zk - zp).abs().max().item(),
        "scores": (sk - sp).abs().max().item(),
    }
    # fp32 sums in another order through 4 conv layers: ~1e-6 relative per
    # layer; 2e-4 is a wide margin over that and far below one uint8 level.
    tol = {"images": 2e-4, "zs": 1e-4, "scores": 1e-5}
    print(f"[fp32] render with kernels vs plain versions: max |diff| {errs} (tol {tol})",
          flush=True)
    for k in errs:
        if not errs[k] <= tol[k]:
            raise AssertionError(f"fp32 {k} differ by {errs[k]:.3e} > {tol[k]}")
    if not torch.isfinite(ik).all():
        raise AssertionError("non-finite fp32 images")
    return errs


# --------------------------------------------------------------- train step

# Device kernels under these autograd nodes are the backward of a port
# kernel's Function: eager ops, except where they are a port kernel by name
# (the backwards of TPReLU, LIS and the seed are kernels of their own,
# `fused_tprelu_backward`, `lis_residual_mlp_backward` and
# `fused_seed_backward`).
PORT_BACKWARD = {"FusedTPReLUBackward": "fused_tprelu",
                 "LISResidualMLPBackward": "lis_residual_mlp",
                 "FusedSeedBackward": "fused_seed"}
# How each Function's backward runs.
BACKWARD_KIND = {"fused_tprelu": "kernel backward, fused_tprelu_backward",
                 "lis_residual_mlp": "kernel backward, lis_residual_mlp_backward",
                 "fused_seed": "kernel backward, fused_seed_backward"}
# Device kernels of the port, by name: the forwards, TPReLU's backward (its
# two kernels, tprelu_grad_kernel and tprelu_grad_reduce), LIS's
# (lis_bwd_kernel) and the seed's (seed_bwd_project, seed_bwd_gemm,
# seed_bwd_f32, seed_bwd_reduce).
PORT_KERNELS = {"tprelu_kernel": "fused_tprelu", "lis_kernel": "lis_residual_mlp",
                "seed_tap_gemm": "fused_seed", "seed_kernel_f32": "fused_seed",
                "tprelu_grad_": "fused_tprelu_backward", "seed_bwd_": "fused_seed_backward",
                "lis_bwd_": "lis_residual_mlp_backward"}
LIBRARY_CATS = ("library convs (cuDNN)", "library matmuls (cuBLAS)")
BACKWARD_CAT, OPTIMIZER_CAT = "eager backward of port kernels", "optimizer (Adam)"


def step_profile(fn) -> dict:
    """torch.profiler (CPU and CUDA) over one call of `fn`: the device time
    of its kernels and copies by category and by kernel. A kernel launched
    under the autograd node of a port kernel's backward, or under Adam's
    step, counts in those categories instead of the one its name gives,
    unless it is a port kernel by name; one launched under any autograd
    node counts as backward. `port_kernel_ms` holds each port kernel's
    time by name (TPReLU's backward kernels as `fused_tprelu_backward`,
    LIS's as `lis_residual_mlp_backward`, the seed's as
    `fused_seed_backward`), `port_backward_ms` each Function's backward,
    kernel or eager, `port_backward_library` the cuBLAS and cuDNN kernels
    launched under each, and `port_backward_in_op` the kernels other than
    the port's launched inside the backward's custom op (`gea_torch::...`);
    the others under the node are the engine's sums of the gradients it
    hands on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    by_kernel = {}
    for e in events:
        # Ranges of record_function (Adam's step is one) also show on the
        # device's timeline; they are spans, not work.
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, count = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    rows = sorted(((n, ms, c) for n, (ms, c) in by_kernel.items()), key=lambda r: -r[1])
    cats = by_category(rows)
    backward = dict.fromkeys(PORT_BACKWARD.values(), 0.0)
    library = {k: [] for k in PORT_BACKWARD.values()}
    in_op = {k: [] for k in PORT_BACKWARD.values()}
    backward_ms = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        names, parent = [], e
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        port = next((k for key, k in PORT_BACKWARD.items() if any(key in n for n in names)), None)
        optim = any(n.startswith("Optimizer.step") for n in names)
        in_backward = any(n.startswith("autograd::engine::evaluate_function") for n in names)
        op = any(n.startswith("gea_torch::") for n in names)
        for k in e.kernels:
            ms = k.duration / 1e3
            backward_ms += ms if in_backward else 0.0
            if port is None and not optim:
                continue
            if port is not None and kernel_category(k.name) == "port kernels":
                backward[port] += ms
                continue
            if port is not None and kernel_category(k.name) in LIBRARY_CATS:
                library[port].append(k.name[:90])
            if port is not None and op:
                in_op[port].append(k.name[:90])
            cats[kernel_category(k.name)] -= ms
            cat = BACKWARD_CAT if port is not None else OPTIMIZER_CAT
            cats[cat] = cats.get(cat, 0.0) + ms
            if port is not None:
                backward[port] += ms
    by_port = dict.fromkeys(PORT_KERNELS.values(), 0.0)
    for name, ms, _ in rows:
        port = next((k for key, k in PORT_KERNELS.items() if key in name), None)
        if port is not None:
            by_port[port] += ms
    return {"device_ms": sum(r[1] for r in rows), "backward_device_ms": backward_ms,
            "launches": sum(r[2] for r in rows), "by_category": cats,
            "port_kernel_ms": by_port, "port_backward_ms": backward,
            "port_backward_library": library, "port_backward_in_op": in_op, "by_kernel": rows}


def cycles_per_ms() -> float:
    """The spin kernel's clock, from CUDA events around one long spin."""
    cycles = 50_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def step_device_ms(fn, host_ms: float, reps: int = 5) -> dict:
    """Device time of one call of `fn` (CUDA events), with the stream held
    by a spin for about 3x the call's host time while the host enqueues
    it, so the events time the device's work and not the enqueue. Checked:
    the host must finish enqueueing before the spin ends. When the call
    enqueues more launches than the launch queue holds, the host blocks in
    the spin and enqueues the rest while the device works, and the span
    may hold waits on the host: it is then an upper bound of the device
    time, and the profiler's busy time a lower one."""
    cycles = int(3 * host_ms * cycles_per_ms())
    spans, covered = [], []
    for _ in range(reps):
        spin0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
        covered.append((enqueue_ms, spin0.elapsed_time(start)))
    return {"ms": statistics.median(spans), "spans_ms": spans,
            "enqueue_vs_spin_ms": covered,
            "covered": all(enq < spin for enq, spin in covered)}


def train_config(cfg, **kw) -> TrainGLISConfig:
    return TrainGLISConfig(**{**dataclasses.asdict(cfg), "batch_size": BATCH,
                              "gan_loss": "bce", **kw})


def real_batch(cfg) -> torch.Tensor:
    """The real batch every `gea` probe times against (benchmarks/common.py)."""
    s = cfg.image_size
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (BATCH, s, s, 3)).astype(np.float32)).cuda()


def named_params(state) -> dict:
    """The trained parameters of a train state, by module and name."""
    return {f"{name}.{n}": p for name, _ in state.PLAYERS
            for n, p in getattr(state, name).named_parameters()}


def training(cfg, kernel_rows: dict, smi: str) -> dict:
    """The main path: flagship bf16 train steps through the kernels, timed
    with PyTorch's default TF32 settings (cuDNN may use TF32 for the fp32
    convolutions of the seed's backward; fp32 matmuls stay fp32)."""
    with cudnn_tf32():
        return _training(cfg, kernel_rows, smi)


def _training(cfg, kernel_rows: dict, smi: str) -> dict:
    tcfg = train_config(cfg)
    state = create_glis_state(tcfg, init_generator_params(cfg, 0), init_discriminator_params(cfg, 1))
    step = build_glis_train_step(tcfg)
    real = real_batch(cfg)
    params = named_params(state)
    before = {n: p.detach().clone() for n, p in params.items()}
    per_step = glis_launches(tcfg)[0]

    # Warm-up step 1: launches per step, and a gradient for every parameter.
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(state, real)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[train] step 1 launches {counts} (want {per_step}), {first_s:.3f} s", flush=True)
    if counts != per_step:
        raise AssertionError(f"launches per train step {counts} != {per_step}")
    norms = {n: p.grad.float().norm().item() if p.grad is not None else float("nan")
             for n, p in params.items()}
    bad = [n for n, v in norms.items() if not (np.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"no finite non-zero gradient on step 1 for {bad}")
    print(f"[train] step 1: all {len(norms)} parameters of G and D have finite non-zero "
          f"gradients (norms {min(norms.values()):.3e} .. {max(norms.values()):.3e})", flush=True)
    for _ in range(TRAIN_WARMUP - 1):
        step(state, real)

    # The counted, timed run.
    ops.reset_launch_counts()
    walls, history = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, real)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        history.append({k: v.item() for k, v in metrics.items()})
    counts = ops.launch_counts()
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    print(f"[train] launch counts over {TRAIN_STEPS} timed steps: {counts} (want {want})",
          flush=True)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for name, n in counts.items():
        kernel_rows[name]["launches"] = n
        kernel_rows[name]["launches_per_step"] = per_step[name]
    if not all(np.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"non-finite metrics: {history}")
    still = [n for n, p in params.items() if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"parameters that never moved: {still}")
    if state.step != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError(f"state.step {state.step}")
    wall = statistics.median(walls)

    device = step_device_ms(lambda: step(state, real), wall * 1e3)
    profiled = step_profile(lambda: step(state, real))
    idle = 1.0 - profiled["device_ms"] / (wall * 1e3)
    result = {
        "config": {k: getattr(tcfg, k) for k in ("image_size", "code_size", "r_iterations",
                                                 "norm", "num_features", "max_features",
                                                 "dtype", "batch_size", "gan_loss", "lr")},
        "step_wall_ms_median": wall * 1e3,
        "step_wall_ms": [w * 1e3 for w in walls],
        "images_per_s": BATCH / wall,
        "step_device_ms": device["ms"],
        "step_device": device,
        "step_device_busy_ms": profiled["device_ms"],
        "step_device_span_minus_busy_ms": device["ms"] - profiled["device_ms"],
        "step_device_idle_share": idle,
        "step_backward_device_ms": profiled["backward_device_ms"],
        "step_device_launches": profiled["launches"],
        "step_by_category": profiled["by_category"],
        "port_backward_ms": profiled["port_backward_ms"],
        "step_by_kernel": [{"name": n[:90], "ms": t, "count": c}
                           for n, t, c in profiled["by_kernel"][:16]],
        "metrics_first": history[0],
        "metrics_last": history[-1],
        "first_step_s": first_s,
        "card": smi,
    }
    print(f"[train] flagship bf16 step, batch {BATCH}: median wall {wall * 1e3:.3f} ms of "
          f"{TRAIN_STEPS} = {BATCH / wall:.1f} images/s on {smi}", flush=True)
    print(f"[train] device time of one step {device['ms']:.3f} ms (CUDA events; "
          f"{device['ms'] - profiled['device_ms']:.3f} ms above the profiler's busy time; spin "
          f"covered the enqueue: {device['covered']}, enqueue vs spin ms "
          f"{[(round(a, 3), round(b, 3)) for a, b in device['enqueue_vs_spin_ms']]})",
          flush=True)
    print(f"[train] torch.profiler: {profiled['device_ms']:.3f} ms of device time in "
          f"{profiled['launches']} kernels and copies ({profiled['backward_device_ms']:.3f} ms "
          f"under autograd); idle share {idle:.3f} of the median wall", flush=True)
    for cat, t in sorted(profiled["by_category"].items(), key=lambda kv: -kv[1]):
        print(f"[train] step by category: {t:8.4f} ms {cat}", flush=True)
    for name, t in profiled["port_backward_ms"].items():
        print(f"[train] backward of {name} ({BACKWARD_KIND[name]}): {t:.4f} ms a step; "
              f"library kernels under it: {profiled['port_backward_library'][name]}; other "
              f"kernels inside its op: {profiled['port_backward_in_op'][name]}", flush=True)
        kernel_rows[name]["backward_step_ms"] = t
    if profiled["port_backward_library"]["fused_seed"]:
        raise AssertionError(f"cuBLAS or cuDNN kernels under FusedSeedBackward: "
                             f"{profiled['port_backward_library']['fused_seed']}")
    if profiled["port_backward_library"]["lis_residual_mlp"] or profiled[
            "port_backward_in_op"]["lis_residual_mlp"]:
        raise AssertionError(f"library or eager kernels under LISResidualMLPBackward: "
                             f"{profiled['port_backward_library']['lis_residual_mlp']}, "
                             f"{profiled['port_backward_in_op']['lis_residual_mlp']}")
    for name, t in profiled["port_kernel_ms"].items():  # each port kernel, by name
        kernel_rows[name]["step_profile_ms"] = t
        print(f"[train] {name}'s kernels in the step profile: {t:.4f} ms a step (bound "
              f"{kernel_rows[name]['bound_ms']:.4f} ms)", flush=True)
    for n, t, c in profiled["by_kernel"][:16]:
        print(f"[train] step by kernel: {t:8.4f} ms x{c:<4d} {n[:90]}", flush=True)
    print(f"[train] metrics, first and last timed step: {history[0]} {history[-1]}", flush=True)
    del state, step
    return result


FP32_TOL = {"metrics_rel": 1e-4, "grad_rel_to_max": 2e-2, "params_apart_share": 2e-2}


def fp32_agreement_of(label: str, two_steps, lr: float, tol: Optional[dict] = None) -> dict:
    """`two_steps(use_kernels)` -> (metrics of 2 fp32 steps, step 1's
    gradients, parameters after step 2), by name: with kernels against
    plain versions, beside a second run of the plain versions (the card's
    own spread from run to run).

    On the card the plain versions run twice already give gradients about
    1e-3 of each tensor's largest apart (fp32 sums in another order, the
    atomics of library kernels), and Adam's first update, about
    lr * sign(g), turns a gradient at that noise level into a flip of 2 lr.
    Tolerances (FP32_TOL): metrics rtol 1e-4, relative to at least 1e-2
    (R-iterative's loss_r_sim, the mean square of R's outputs, starts near
    7e-5, where Adam's flips in step 1 move it by 1e-4 of itself); step
    1's gradient of every parameter within 2e-2 of the tensor's largest;
    after 2 steps, at most 2% of each tensor's elements more than lr / 5
    apart (a wrong backward moves them all). Measured on an H100 for the
    G-LIS step: kernels vs plain 3.9e-3 and 0.6%, plain vs itself 1.3e-3
    and 0.4%. `tol` replaces FP32_TOL."""
    tol = tol or FP32_TOL

    def compare(a, b) -> dict:
        (ma, ga, pa), (mb, gb, pb) = a, b
        shares = {n: ((pa[n] - pb[n]).abs() > lr / 5).float().mean().item() for n in pb}
        grads = {n: (ga[n] - gb[n]).abs().max().item() / max(gb[n].abs().max().item(), 1e-30)
                 for n in gb}
        return {
            "metrics_rel": max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-2)
                               for x, y in zip(ma, mb) for k in x),
            "grad_rel_to_max": max(grads.values()),
            "params_apart_share": max(shares.values()),
            "params_abs": max((pa[n] - pb[n]).abs().max().item() for n in pb),
            "worst": [max(grads, key=grads.get), max(shares, key=shares.get)],
        }

    kernels, plain, again = two_steps(True), two_steps(False), two_steps(False)
    errs, spread = compare(kernels, plain), compare(again, plain)
    print(f"[{label} fp32] 2 steps with kernels vs plain versions: {errs} (tol {tol}); "
          f"plain vs plain again: {spread}; metrics {kernels[0][-1]}", flush=True)
    for k in tol:
        if not errs[k] <= tol[k]:
            raise AssertionError(f"{label} fp32 step {k} {errs[k]:.3e} > {tol[k]}")
    return {"kernels_vs_plain": errs, "plain_vs_plain": spread, "tol": tol}


def two_fp32_steps(make_state, step, named, batches):
    """(metrics of each step, step 1's gradients, parameters after the
    last) of `step` over `batches` (argument tuples) from `make_state()`."""
    state = make_state()
    metrics, grads = [], None
    for args in batches:
        metrics.append({k: v.item() for k, v in step(state, *args).items()})
        if grads is None:
            grads = {n: p.grad.detach().clone() for n, p in named(state).items()}
    return metrics, grads, {n: p.detach() for n, p in named(state).items()}


def train_fp32_agreement(cfg) -> dict:
    """2 fp32 G-LIS steps with kernels against 2 with plain versions, from
    the same params on the same real batch and z (`fp32_agreement_of`)."""
    tcfg = train_config(cfg, dtype="float32")
    g_params = init_generator_params(cfg, 0)
    d_params = init_discriminator_params(cfg, 1)
    real = real_batch(cfg)
    rng = np.random.default_rng(3)
    zs = [torch.from_numpy(rng.standard_normal((BATCH, cfg.code_size)).astype(np.float32)).cuda()
          for _ in range(2)]
    return fp32_agreement_of("train", lambda use_kernels: two_fp32_steps(
        lambda: create_glis_state(tcfg, g_params, d_params, use_kernels=use_kernels),
        build_glis_train_step(tcfg), named_params, [(real, z) for z in zs]), tcfg.lr)


# ------------------------------------------------------------------ trainer

TRAINER_ARGS = [
    "--dataset", "synthetic", "--synthetic_on_device", "true", "--image_size", "80",
    "--crop_size", "160", "--code_size", "256", "--r_iterations", "3", "--norm", "weight",
    "--num_features", "64", "--max_features", "512", "--dtype", "bfloat16",
    "--batch_size", str(BATCH), "--log_interval", "10",
]
TRAINER_STEPS, TRAINER_VIS, RESUME_TO, IDLE_STEPS = 40, 20, 60, 10
JPEGS = 256  # a folder of 218 x 178 JPEGs, CelebA's aligned size


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_cli(args, cli=train_glis) -> tuple:
    """`python -m gea_torch.cli.<cli>` in-process: (state, stats, printed
    text)."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        state, stats = cli.main(args)
    return state, stats, tee.buf.getvalue()


def counted_run(tag: str, label: str, cli, args, want: dict) -> tuple:
    """One CLI run with the launch counters zeroed just before it and read
    just after; they must equal `want`. (state, stats, text, counts)."""
    ops.reset_launch_counts()
    state, stats, text = run_cli(args, cli)
    counts = ops.launch_counts()
    print(f"[{tag}] {label}: launch counts {counts} (want {want})", flush=True)
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    return state, stats, text, counts


def launches(per_step: dict, steps: int, per_render: dict, renders: int) -> dict:
    return {k: steps * per_step[k] + renders * per_render[k] for k in per_step}


def same(a, b, path="") -> list:
    """The paths at which two nests of tensors and values differ."""
    if torch.is_tensor(a):
        same_t = torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same_t else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [p for k in a for p in same(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in same(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def round_trip(run_dir: str, step: int, state, fresh) -> dict:
    """The checkpoint of `step` restored into `fresh`, a new state of the
    same trainer, equals `state` bit for bit: parameters, Adam's moments and
    steps, the schedulers, the generator's state, the EMA shadow (G-LIS)
    and the step."""
    want = state_dict(state)
    restored = restore_checkpoint(run_dir, fresh, step=step)
    diff = same(state_dict(restored), want)
    if diff:
        raise AssertionError(f"restored checkpoint {step} differs at {diff[:8]}")
    tags = [tag for _, tag in state.PLAYERS]
    return {"tensors_compared": sum(1 for _ in _tensors(want)),
            "adam_params": sum(len(want[f"opt_{t}"]["state"]) for t in tags),
            "schedulers": [want[f"sched_{t}"] is not None for t in tags],
            "ema_tensors": len(want.get("g_ema", {}))}


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def write_jpegs(root: str) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:218, 0:178].astype(np.float32)
    for i in range(JPEGS):
        f = rng.uniform(0.01, 0.1, 3)
        img = 127.5 + 100 * np.sin(yy[..., None] * f + xx[..., None] * f[::-1])
        img += rng.normal(0, 10, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"{i:06d}.jpg"), quality=90)


def loop_idle(cfg: TrainGLISConfig, state) -> dict:
    """The device's idle share over IDLE_STEPS loop iterations of a run's
    input path and step (after 3 warm-up iterations), under torch.profiler:
    1 - device busy / host wall."""
    dev = state.device
    data = input_iterator(cfg, dev, cfg.seed, start_step=state.step)
    make_real, step = make_input_fn(cfg, dev), build_glis_train_step(cfg)
    walls = []

    def steps(n):
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, make_real(next(data), state.step))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    steps(3)
    busy_ms, _ = device_profile(lambda: steps(IDLE_STEPS))
    data.close()
    return {"busy_ms": busy_ms, "wall_ms": walls[-1], "idle_share": 1.0 - busy_ms / walls[-1]}


def trainer(tmp: str, kernel_rows: dict, bare_images_per_s: float, smi: str) -> dict:
    """The trainer at flagship width under PyTorch's default TF32 settings,
    as the bare step of phase 7 is timed. Its main run directory,
    `<tmp>/run`, is the frozen G of phase 9."""
    with cudnn_tf32():
        return _trainer(tmp, kernel_rows, bare_images_per_s, smi)


def glis_launches(cfg) -> tuple:
    """(launches of a G-LIS train step, of a render of every stage): a
    render has one seed call, a LIS link per module and a TPReLU per
    upsampling block after the seed's; the step renders once, and D's trunk
    (as many TPReLUs) runs on the reals and fakes and again for G's loss.
    All three are differentiated, so each TPReLU of the step has its
    backward, and so have each LIS link and the seed (the render); a render
    has none."""
    acts = generator_plan(cfg.image_size)[1] - 1
    return ({"fused_tprelu": 3 * acts, "fused_tprelu_backward": 3 * acts,
             "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": cfg.r_iterations,
             "fused_seed": 1, "fused_seed_backward": 1},
            {"fused_tprelu": acts, "fused_tprelu_backward": 0,
             "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0,
             "fused_seed": 1, "fused_seed_backward": 0})


def _trainer(tmp: str, kernel_rows: dict, bare_images_per_s: float, smi: str) -> dict:
    run = os.path.join(tmp, "run")
    args = TRAINER_ARGS + ["--save_path", run, "--vis_interval", str(TRAINER_VIS),
                           "--save_interval", str(TRAINER_VIS)]
    cfg = TrainGLISConfig.from_args(args)
    runs, counted = {}, {}
    per_step, per_render = glis_launches(cfg)

    def counted_cli(label, run_args, steps, renders):
        """One CLI run: exactly `steps` train steps' and `renders` sample
        renders' launches."""
        state, stats, text, counts = counted_run(
            "trainer", f"{label}, {steps} steps and {renders} renders", train_glis, run_args,
            launches(per_step, steps, per_render, renders))
        counted[label] = counts
        return state, stats, text

    def record(label, stats, run_cfg, state):
        runs[label] = {k: stats[k] for k in ("images_per_sec", "step_wall_s_median",
                                             "input_wait_s_median")}
        runs[label]["metrics"] = stats["metrics"]
        runs[label]["launches"] = counted[label]
        runs[label]["idle"] = loop_idle(run_cfg, state)
        r = runs[label]
        print(f"[trainer] {label}: {r['images_per_sec']:.1f} img/s (meter), loop iteration "
              f"{r['step_wall_s_median'] * 1e3:.3f} ms, input wait "
              f"{r['input_wait_s_median'] * 1e3:.3f} ms (host medians); device idle "
              f"{r['idle']['idle_share']:.3f} over {IDLE_STEPS} steps (busy "
              f"{r['idle']['busy_ms']:.3f} of {r['idle']['wall_ms']:.3f} ms); launches "
              f"{r['launches']}; {smi}", flush=True)

    # The CLI run, its launches and its artifacts.
    state, stats, _ = counted_cli("synthetic on device", args + ["--niter", str(TRAINER_STEPS)],
                                  TRAINER_STEPS, TRAINER_STEPS // TRAINER_VIS)
    for name, n in counted["synthetic on device"].items():
        kernel_rows[name]["launches_trainer"] = n
    artifacts = ["config.json"] + [f"checkpoints/{s}/state.pt" for s in (20, 40)] + [
        f"samples/samples_{s:08d}_stage{i}.png" for s in (20, 40) for i in range(cfg.n_stages)]
    missing = [a for a in artifacts if not os.path.isfile(os.path.join(run, a))]
    if missing or state.step != TRAINER_STEPS:
        raise AssertionError(f"missing artifacts {missing}, step {state.step}")
    print(f"[trainer] artifacts present: {artifacts}; plots/loss.png "
          f"{'present' if os.path.isfile(os.path.join(run, 'plots', 'loss.png')) else 'absent'}",
          flush=True)

    # The checkpoint round trip (before any further step), and the two parts
    # of a save and a restore.
    trip = round_trip(run, TRAINER_STEPS, state, create_glis_state(cfg))
    ckpt_dir = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(ckpt_dir, state.step, state, async_save=True)
    t1 = time.perf_counter()
    wait_for_checkpoints()
    t2 = time.perf_counter()
    target = create_glis_state(cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    restore_checkpoint(ckpt_dir, target)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    ckpt = {"save_sync_s": t1 - t0, "save_async_s": t2 - t1, "restore_s": t4 - t3,
            "bytes": os.path.getsize(os.path.join(ckpt_dir, "checkpoints", str(state.step),
                                                  "state.pt"))}
    del target
    record("synthetic on device", stats, cfg, state)
    ema_cfg = cfg.replace(g_ema=0.999, lr_schedule="cosine", niter=100)
    ema_state = create_glis_state(ema_cfg)
    ema_step = build_glis_train_step(ema_cfg)
    for _ in range(2):
        ema_step(ema_state, real_batch(ema_cfg))
    save_checkpoint(os.path.join(tmp, "ema"), ema_state.step, ema_state)
    trip_ema = round_trip(os.path.join(tmp, "ema"), ema_state.step, ema_state,
                          create_glis_state(ema_cfg))
    del ema_state, ema_step
    print(f"[trainer] checkpoint round trip bitwise: step 40 {trip}; EMA + cosine after 2 "
          f"steps {trip_ema}; save {ckpt['save_sync_s'] * 1e3:.1f} ms on the loop thread + "
          f"{ckpt['save_async_s'] * 1e3:.1f} ms written in the background, restore "
          f"{ckpt['restore_s'] * 1e3:.1f} ms, {ckpt['bytes']} bytes", flush=True)

    # One sample render with its grids, as the loop makes at each vis_interval.
    vis = train_glis.make_vis_fn(cfg, state.generator, os.path.join(tmp, "vis"))
    vis_s = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vis(state, i)
        vis_s.append(time.perf_counter() - t0)
    z = torch.randn((cfg.vis_rows ** 2, cfg.code_size), device=state.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        images = state.generator.render(z)[0].cpu().numpy()
    t1 = time.perf_counter()
    save_stage_grids(images, os.path.join(tmp, "vis"), 0, rows=cfg.vis_rows)
    t2 = time.perf_counter()
    vis_parts = {"render_to_host_s": t1 - t0, "png_grids_s": t2 - t1}
    print(f"[trainer] one sample render of {cfg.vis_rows ** 2} codes and {cfg.n_stages} PNG grids: "
          f"{[round(s * 1e3, 3) for s in vis_s]} ms (first call first); of a fourth, the render "
          f"to host memory {vis_parts['render_to_host_s'] * 1e3:.3f} ms and the PNG grids "
          f"{vis_parts['png_grids_s'] * 1e3:.3f} ms", flush=True)

    # The relaunch resumes at step 40 and reaches 60.
    del state
    # Steps 41-60, and the render at 60.
    state, stats, text = counted_cli(
        "relaunch", args + ["--niter", str(RESUME_TO)], RESUME_TO - TRAINER_STEPS,
        RESUME_TO // TRAINER_VIS - TRAINER_STEPS // TRAINER_VIS)
    line = f"resumed from {run} at step {TRAINER_STEPS}"
    if line not in text or state.step != RESUME_TO:
        raise AssertionError(f"resume: {line!r} printed: {line in text}, step {state.step}")
    if not all(np.isfinite(v) for v in stats["metrics"].values()):
        raise AssertionError(f"non-finite metrics after the resume: {stats['metrics']}")
    print(f"[trainer] relaunch printed {line!r} and reached step {state.step}; metrics "
          f"{stats['metrics']}", flush=True)
    del state

    # The other input paths, 40 steps each.
    jpegs = os.path.join(tmp, "jpegs")
    os.makedirs(jpegs)
    write_jpegs(jpegs)
    other = {
        "synthetic on device, no renders or saves before the end": [],
        "synthetic streamed from the host": ["--synthetic_on_device", "false"],
        "synthetic, host preprocess": ["--synthetic_on_device", "false",
                                       "--on_device_pipeline", "false"],
        "JPEG folder, --data_cache": ["--dataset", "folder", "--dataroot", jpegs,
                                      "--data_cache", "true"],
        "JPEG folder, --device_data_cache": ["--dataset", "folder", "--dataroot", jpegs,
                                             "--device_data_cache", "true"],
    }
    for i, (label, extra) in enumerate(other.items()):
        path_args = TRAINER_ARGS + extra + [
            "--save_path", os.path.join(tmp, f"path{i}"), "--niter", str(TRAINER_STEPS),
            "--vis_interval", "0", "--save_interval", "0"]
        state, stats, _ = counted_cli(label, path_args, TRAINER_STEPS, 0)
        record(label, stats, TrainGLISConfig.from_args(path_args), state)
        del state

    side = max(cfg.crop_size, cfg.image_size)
    ds = SyntheticDataset(BATCH, side, seed=0).batches()
    batch_s = []
    for _ in range(6):
        t0 = time.perf_counter()
        next(ds)
        batch_s.append(time.perf_counter() - t0)
    synth_ms = statistics.median(batch_s[1:]) * 1e3
    ratio = runs["synthetic on device"]["images_per_sec"] / bare_images_per_s
    ratio_plain = (runs["synthetic on device, no renders or saves before the end"]
                   ["images_per_sec"] / bare_images_per_s)
    print(f"[trainer] host time of one synthetic batch ({BATCH} x {side} x {side} x 3 uint8): "
          f"{synth_ms:.3f} ms (median of 5); CLI on-device synthetic rate / phase 7 bare "
          f"step rate {ratio:.3f}, without renders and saves {ratio_plain:.3f} "
          f"({bare_images_per_s:.1f} img/s); {smi}", flush=True)
    return {"runs": runs, "checkpoint": ckpt, "vis_s": vis_s, "vis_parts": vis_parts,
            "round_trip": trip, "round_trip_ema": trip_ema, "run_dir": run,
            "synthetic_batch_host_ms": synth_ms, "bare_step_images_per_s": bare_images_per_s,
            "cli_over_bare": ratio, "cli_without_side_effects_over_bare": ratio_plain,
            "launches": counted, "card": smi}


# ------------------------------------------------------------- R trainers


def timed_steps(tag: str, run_step, smi: str) -> dict:
    """The bare step `run_step()` -> metrics, as phase 7 times G-LIS's: 2
    warm-up steps, then TRAIN_STEPS synced steps on the host clock (finite
    metrics), the device time of one step (CUDA events behind a spin), the
    device's idle share and a torch.profiler breakdown by category, with
    each port kernel's forward and backward on their own."""
    for _ in range(2):
        run_step()
    walls, history = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        history.append({k: v.item() for k, v in metrics.items()})
    if not all(np.isfinite(v) for m in history for v in m.values()):
        raise AssertionError(f"{tag}: non-finite metrics {history}")
    wall = statistics.median(walls)
    device = step_device_ms(run_step, wall * 1e3)
    profiled = step_profile(run_step)
    idle = 1.0 - profiled["device_ms"] / (wall * 1e3)
    result = {
        "step_wall_ms_median": wall * 1e3, "step_wall_ms": [w * 1e3 for w in walls],
        "images_per_s": BATCH / wall, "step_device_ms": device["ms"], "step_device": device,
        "step_device_busy_ms": profiled["device_ms"], "step_device_idle_share": idle,
        "step_backward_device_ms": profiled["backward_device_ms"],
        "step_device_launches": profiled["launches"], "step_by_category": profiled["by_category"],
        "port_kernel_ms": profiled["port_kernel_ms"],
        "port_backward_ms": profiled["port_backward_ms"],
        "step_by_kernel": [{"name": n[:90], "ms": t, "count": c}
                           for n, t, c in profiled["by_kernel"][:16]],
        "metrics_first": history[0], "metrics_last": history[-1], "card": smi,
    }
    print(f"[{tag}] bare bf16 step, batch {BATCH}: median wall {wall * 1e3:.3f} ms of "
          f"{TRAIN_STEPS} = {BATCH / wall:.1f} images/s; device time of one step "
          f"{device['ms']:.3f} ms (CUDA events; spin covered the enqueue: {device['covered']}); "
          f"torch.profiler: {profiled['device_ms']:.3f} ms busy in {profiled['launches']} "
          f"kernels and copies, idle share {idle:.3f}; {smi}", flush=True)
    for cat, t in sorted(profiled["by_category"].items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] step by category: {t:8.4f} ms {cat}", flush=True)
    for name in PORT_BACKWARD.values():
        print(f"[{tag}] {name}: forward {profiled['port_kernel_ms'][name]:.4f} ms, "
              f"{BACKWARD_KIND[name]} {profiled['port_backward_ms'][name]:.4f} ms a step",
              flush=True)
    print(f"[{tag}] the backward kernels by name: " + "; ".join(
        f"{k} {profiled['port_kernel_ms'][k]:.4f} ms" for k in (
            "fused_tprelu_backward", "lis_residual_mlp_backward", "fused_seed_backward"))
        + " a step", flush=True)
    for n, t, c in profiled["by_kernel"][:12]:
        print(f"[{tag}] step by kernel: {t:8.4f} ms x{c:<4d} {n[:90]}", flush=True)
    return result


def variant_launches(tag: str, variants: dict) -> dict:
    """One step of each option that changes the launches per step: label
    -> (run_step, want), counters zeroed just before and read just
    after."""
    out = {}
    for label, (run_step, want) in variants.items():
        out[label] = counted(f"{tag} {label}", run_step, want)
        print(f"[{tag}] one step with {label}: launch counts {out[label]} (want {want})",
              flush=True)
    return out


def counted(label: str, fn, want: dict) -> dict:
    """`fn()` with the launch counters zeroed just before and read just
    after; they must equal `want`."""
    ops.reset_launch_counts()
    fn()
    counts = ops.launch_counts()
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    return counts


def check_trained(tag: str, state, init: dict) -> dict:
    """Every trained parameter has a finite, non-zero gradient from the
    last step and has moved from its initial value `init`."""
    params = named_params(state)
    norms = {n: p.grad.float().norm().item() if p.grad is not None else float("nan")
             for n, p in params.items()}
    bad = [n for n, v in norms.items() if not (np.isfinite(v) and v > 0)]
    still = [n for n, p in params.items() if torch.equal(p.detach(), init[n])]
    if bad or still:
        raise AssertionError(f"{tag}: no finite non-zero gradient for {bad}; never moved: {still}")
    print(f"[{tag}] all {len(params)} trained parameters ({[m for m, _ in state.PLAYERS]}) have "
          f"finite non-zero gradients (norms {min(norms.values()):.3e} .. "
          f"{max(norms.values()):.3e}) and moved", flush=True)
    return {"parameters": len(params), "grad_norm_min": min(norms.values()),
            "grad_norm_max": max(norms.values())}


def check_artifacts(tag: str, run: str, stages: int) -> list:
    artifacts = ["config.json"] + [f"checkpoints/{s}/state.pt" for s in (20, 40)] + [
        f"samples/samples_{s:08d}_stage{i}.png" for s in (20, 40) for i in range(stages)]
    missing = [a for a in artifacts if not os.path.isfile(os.path.join(run, a))]
    if missing:
        raise AssertionError(f"{tag}: missing artifacts {missing}")
    return artifacts


def relaunch(tag: str, cli, args, run: str, per_step: dict, per_render: dict) -> dict:
    """The same CLI with --niter RESUME_TO resumes at TRAINER_STEPS and
    reaches RESUME_TO with finite metrics and exact launches."""
    renders = RESUME_TO // TRAINER_VIS - TRAINER_STEPS // TRAINER_VIS
    state, stats, text, counts = counted_run(
        tag, f"relaunch, {RESUME_TO - TRAINER_STEPS} steps and {renders} render", cli,
        args + ["--niter", str(RESUME_TO)],
        launches(per_step, RESUME_TO - TRAINER_STEPS, per_render, renders))
    line = f"resumed from {run} at step {TRAINER_STEPS}"
    if line not in text or state.step != RESUME_TO:
        raise AssertionError(f"{tag} resume: {line!r} printed: {line in text}, step {state.step}")
    if not all(np.isfinite(v) for v in stats["metrics"].values()):
        raise AssertionError(f"{tag}: non-finite metrics after the resume: {stats['metrics']}")
    print(f"[{tag}] relaunch printed {line!r} and reached step {state.step}; metrics "
          f"{stats['metrics']}", flush=True)
    return {"launches": counts, "metrics": stats["metrics"], "images_per_sec": stats["images_per_sec"]}


def cli_summary(stats: dict, counts: dict) -> dict:
    return {**{k: stats[k] for k in ("images_per_sec", "step_wall_s_median",
                                     "input_wait_s_median")},
            "metrics": stats["metrics"], "launches": counts}


def r_separate(tmp: str, g_run: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 9: the trainer under the train step's TF32 settings, then the
    fp32 check without TF32, as phase 7's."""
    with cudnn_tf32():
        result, cfg = _r_separate(tmp, g_run, kernel_rows, smi)
    cfg32 = cfg.replace(dtype="float32")
    params = (init_generator_params(cfg32, 0), init_discriminator_params(cfg32, 1),
              init_reverter_params(cfg32, 2))
    rng = np.random.default_rng(4)
    zs = [torch.from_numpy(rng.standard_normal((BATCH, cfg.code_size)).astype(np.float32)).cuda()
          for _ in range(2)]

    def make(use_kernels):
        g = generator_from_jax_params(params[0], cfg32, use_kernels=use_kernels)
        d = discriminator_from_jax_params(params[1], cfg32, use_kernels=use_kernels)
        return create_r_state(cfg32, g, d, params[2], use_kernels=use_kernels)

    result["fp32"] = fp32_agreement_of("r-separate", lambda use_kernels: two_fp32_steps(
        lambda: make(use_kernels), build_r_separate_step(cfg32), named_params,
        [(None, z) for z in zs]), cfg32.lr)
    return result


def r_separate_launches(cfg) -> tuple:
    """(launches of an R-separate step, of a corrected render)."""
    acts = generator_plan(cfg.image_size)[1] - 1  # TPReLUs of one G render, of D's trunk
    # A render: before, R (trunk + head), after; a step adds D on it and
    # differentiates D, the after render (its LIS links and seed for dz
    # alone) and R (the before render is not).
    per_render = {"fused_tprelu": acts + (acts + 1) + acts, "fused_tprelu_backward": 0,
                  "lis_residual_mlp": 2 * cfg.r_iterations, "lis_residual_mlp_backward": 0,
                  "fused_seed": 2, "fused_seed_backward": 0}
    return {**per_render, "fused_tprelu": per_render["fused_tprelu"] + acts,
            "fused_tprelu_backward": 3 * acts + 1, "lis_residual_mlp_backward": cfg.r_iterations,
            "fused_seed_backward": 1}, per_render


def r_separate_config(g_run: str, args: list) -> TrainRSeparateConfig:
    g_cfg = TrainGLISConfig.load(os.path.join(g_run, "config.json"))
    return train_r_separate.architecture_from_g(TrainRSeparateConfig.from_args(args), g_cfg)


def _r_separate(tmp: str, g_run: str, kernel_rows: dict, smi: str) -> dict:
    tag = "r-separate"
    run = os.path.join(tmp, "rsep")
    args = ["--g_path", g_run, "--batch_size", str(BATCH), "--log_interval", "10",
            "--save_path", run, "--vis_interval", str(TRAINER_VIS),
            "--save_interval", str(TRAINER_VIS)]
    cfg = r_separate_config(g_run, args)
    acts = generator_plan(cfg.image_size)[1] - 1
    per_step, per_render = r_separate_launches(cfg)
    renders = TRAINER_STEPS // TRAINER_VIS
    state, stats, _, counts = counted_run(
        tag, f"CLI, {TRAINER_STEPS} steps and {renders} renders", train_r_separate,
        args + ["--niter", str(TRAINER_STEPS)],
        launches(per_step, TRAINER_STEPS, per_render, renders))
    for name, n in counts.items():
        kernel_rows[name]["launches_r_separate"] = n
        kernel_rows[name]["launches_per_r_separate_step"] = per_step[name]
    artifacts = check_artifacts(tag, run, 2)
    if state.step != TRAINER_STEPS or state.discriminator is None:
        raise AssertionError(f"{tag}: step {state.step}, frozen D {state.discriminator}")

    # R trained; the frozen G and D unchanged bit for bit, without gradients.
    fresh_g, _ = load_generator(g_run)
    fresh_d = load_discriminator(g_run)
    fresh = create_r_state(cfg, fresh_g, fresh_d)
    trained = check_trained(tag, state, {n: p.detach().clone()
                                         for n, p in named_params(fresh).items()})
    changed = [f"{i}.{k}" for i, (live, ref) in
               enumerate(((state.generator, fresh_g), (state.discriminator, fresh_d)))
               for k, v in live.state_dict().items() if not torch.equal(v, ref.state_dict()[k])]
    with_grad = [n for m in (state.generator, state.discriminator)
                 for n, p in m.named_parameters() if p.requires_grad or p.grad is not None]
    if changed or with_grad:
        raise AssertionError(f"{tag}: frozen G/D changed at {changed}, with gradients {with_grad}")
    n_frozen = len(fresh_g.state_dict()) + len(fresh_d.state_dict())
    print(f"[{tag}] frozen G and D: all {n_frozen} tensors unchanged bit for bit, no "
          f"gradients; artifacts present: {artifacts}", flush=True)
    trip = round_trip(run, TRAINER_STEPS, state, fresh)
    print(f"[{tag}] checkpoint round trip bitwise: step {TRAINER_STEPS} {trip}", flush=True)
    del fresh

    step = build_r_separate_step(cfg)
    timed = timed_steps(tag, lambda: step(state), smi)
    # --remat renders the corrected code and scores it again in the
    # backward; mining scores the frozen render with D.
    remat = {**per_step, "fused_tprelu": per_step["fused_tprelu"] + 2 * acts,
             "lis_residual_mlp": 3 * cfg.r_iterations, "fused_seed": 3}
    mining = {**per_step, "fused_tprelu": per_step["fused_tprelu"] + acts}
    variants = variant_launches(tag, {
        "--remat": ((lambda: build_r_separate_step(cfg.replace(remat=True))(state)), remat),
        "--r_mine_weight 0.5": (
            (lambda: build_r_separate_step(cfg.replace(r_mine_weight=0.5))(state)), mining)})
    del state, step
    resumed = relaunch(tag, train_r_separate, args, run, per_step, per_render)
    return {"cli": cli_summary(stats, counts), "per_step": per_step, "per_render": per_render,
            "artifacts": artifacts, "trained": trained, "frozen_tensors_unchanged": n_frozen,
            "round_trip": trip, "bare_step": timed, "variants": variants, "relaunch": resumed,
            "card": smi}, cfg


def r_iterative_launches(cfg) -> tuple:
    """(launches of an R-iterative step, of one unroll of the chain)."""
    acts, links = generator_plan(cfg.image_size)[1] - 1, cfg.r_chain_length
    chain = (links + 1) * acts + links * (acts + 1)  # renders and R's of one unroll
    # A step: the D step's unroll, D on real and on fakes, the joint
    # unroll and D on its images; all but the D step's unroll (no grad)
    # are differentiated, so each of the joint unroll's links + 1 renders
    # has a seed backward.
    return ({"fused_tprelu": 2 * chain + 3 * acts, "fused_tprelu_backward": chain + 3 * acts,
             "lis_residual_mlp": 0, "lis_residual_mlp_backward": 0, "fused_seed": 2 * (links + 1),
             "fused_seed_backward": links + 1},
            {"fused_tprelu": chain, "fused_tprelu_backward": 0, "lis_residual_mlp": 0,
             "lis_residual_mlp_backward": 0, "fused_seed": links + 1, "fused_seed_backward": 0})


def r_iterative(tmp: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 10: the trainer under the train step's TF32 settings, then the
    fp32 check without TF32, as phase 7's."""
    with cudnn_tf32():
        result, cfg = _r_iterative(tmp, kernel_rows, smi)
    cfg32 = cfg.replace(dtype="float32")
    params = (init_generator_params(generator_config(cfg32), 0),
              init_discriminator_params(cfg32, 1), init_reverter_params(cfg32, 2))
    rng = np.random.default_rng(5)
    zs = [torch.from_numpy(rng.standard_normal((BATCH, cfg.code_size)).astype(np.float32)).cuda()
          for _ in range(2)]
    real = real_batch(cfg)
    result["fp32"] = fp32_agreement_of("r-iterative", lambda use_kernels: two_fp32_steps(
        lambda: create_r_iterative_state(cfg32, *params, use_kernels=use_kernels),
        build_r_iterative_step(cfg32), named_params, [(real, z) for z in zs]), cfg32.lr)
    return result


def _r_iterative(tmp: str, kernel_rows: dict, smi: str) -> dict:
    tag = "r-iterative"
    run = os.path.join(tmp, "riter")
    args = TRAINER_ARGS + ["--r_chain_length", "2", "--lambda_r", "0.9", "--save_path", run,
                           "--vis_interval", str(TRAINER_VIS), "--save_interval", str(TRAINER_VIS)]
    cfg = TrainRIterativeConfig.from_args(args)
    links = cfg.r_chain_length
    per_step, per_render = r_iterative_launches(cfg)
    chain = per_render["fused_tprelu"]
    renders = TRAINER_STEPS // TRAINER_VIS
    state, stats, _, counts = counted_run(
        tag, f"CLI, {TRAINER_STEPS} steps and {renders} renders", train_r_iterative,
        args + ["--niter", str(TRAINER_STEPS)],
        launches(per_step, TRAINER_STEPS, per_render, renders))
    for name, n in counts.items():
        kernel_rows[name]["launches_r_iterative"] = n
        kernel_rows[name]["launches_per_r_iterative_step"] = per_step[name]
    artifacts = check_artifacts(tag, run, links + 1)
    if state.step != TRAINER_STEPS or state.generator.lis:
        raise AssertionError(f"{tag}: step {state.step}, LIS modules {len(state.generator.lis)}")
    print(f"[{tag}] artifacts present: {artifacts}", flush=True)

    fresh = create_r_iterative_state(cfg)
    trained = check_trained(tag, state, {n: p.detach().clone()
                                         for n, p in named_params(fresh).items()})
    trip = round_trip(run, TRAINER_STEPS, state, fresh)
    print(f"[{tag}] checkpoint round trip bitwise: step {TRAINER_STEPS} {trip}", flush=True)
    del fresh

    step, real = build_r_iterative_step(cfg), real_batch(cfg)
    timed = timed_steps(tag, lambda: step(state, real), smi)
    # --remat runs the joint unroll's first render and its links again in
    # the backward.
    remat = {**per_step, "fused_tprelu": per_step["fused_tprelu"] + chain,
             "fused_seed": per_step["fused_seed"] + links + 1}
    variants = variant_launches(tag, {"--remat": (
        (lambda: build_r_iterative_step(cfg.replace(remat=True))(state, real)), remat)})
    del state, step
    resumed = relaunch(tag, train_r_iterative, args, run, per_step, per_render)
    return {"cli": cli_summary(stats, counts), "per_step": per_step, "per_render": per_render,
            "artifacts": artifacts, "trained": trained, "round_trip": trip, "bare_step": timed,
            "variants": variants, "relaunch": resumed, "card": smi}, cfg


# --------------------------------------------------------------- evaluation

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "torch_port_fid_golden.json")
FID_STEPS, FID_INTERVAL, FID_SAMPLES, EVAL_SAMPLES = 20, 10, 1024, 2048
FEATURE_BATCH = 64


def golden_halves(recipe: dict) -> list:
    """The golden's images, on the card: per half, np.clip(default_rng(seed)
    .normal(shift, scale, (count, size, size, 3)), -1, 1) in float32."""
    size = recipe["size"]
    return [torch.from_numpy(np.clip(np.random.default_rng(h["seed"]).normal(
        h["shift"], h["scale"], (h["count"], size, size, 3)), -1, 1).astype(np.float32)).cuda()
        for h in recipe["halves"]]


def check_extractor(smi: str) -> dict:
    """Both feature networks on the card against the golden written from
    `gea` (`tests/test_torch_port_fid.py --write`): feature means and
    covariance trace within rtol 1e-4 (on the mean, of the largest
    magnitude), the proxy-FID between the two halves within rtol 1e-3.
    Run with TF32 allowed, as the trainers run: the extractor must turn it
    off itself."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    halves = golden_halves(golden["images"])
    out = {}
    with cudnn_tf32():
        for name in fid.EXTRACTORS:
            extract, label = fid.make_feature_extractor(golden["images"]["size"], name)
            feats = [torch.cat([extract(x[i:i + FEATURE_BATCH])
                                for i in range(0, len(x), FEATURE_BATCH)]).double().cpu().numpy()
                     for x in halves]
            stats = [fid.FIDStats.empty(feats[0].shape[1]) for _ in range(3)]
            stats[0].update(np.concatenate(feats))
            stats[1].update(feats[0])
            stats[2].update(feats[1])
            want = golden[name]
            mean_err = float(np.abs(stats[0].mean - want["mean"]).max()
                             / np.abs(want["mean"]).max())
            trace = float(np.trace(stats[0].cov))
            fid_halves = fid.frechet_distance(stats[1].mean, stats[1].cov, stats[2].mean,
                                              stats[2].cov)
            trace_err = abs(trace / want["cov_trace"] - 1)
            fid_err = abs(fid_halves / want["fid_halves"] - 1)
            batch = halves[0][:FEATURE_BATCH]
            ms = time_ms(lambda: extract(batch))
            out[name] = {"label": label, "mean_rel_err": mean_err, "cov_trace": trace,
                         "cov_trace_rel_err": trace_err, "fid_halves": fid_halves,
                         "fid_rel_err": fid_err, "ms_per_batch": ms,
                         "batch": list(batch.shape), "card": smi}
            print(f"[eval] {label} on the card vs gea's golden: feature means {mean_err:.2e} "
                  f"of the largest (tol 1e-4), covariance trace {trace_err:.2e} (tol 1e-4), "
                  f"proxy-FID of the halves {fid_halves:.6f} vs {want['fid_halves']:.6f} "
                  f"({fid_err:.2e}, tol 1e-3); {ms:.4f} ms a batch of {FEATURE_BATCH} "
                  f"(fp32, no TF32); {smi}", flush=True)
            if mean_err > 1e-4 or trace_err > 1e-4 or fid_err > 1e-3:
                raise AssertionError(f"{name} features disagree with gea's golden: {out[name]}")
    return out


def fid_rows(run: str) -> list:
    with open(os.path.join(run, "fid.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_tracking(tag: str, run: str, fresh) -> dict:
    """fid.jsonl has an evaluation at FID_INTERVAL and at FID_STEPS, both
    finite, and best.json names the best one's checkpoint, which restores
    into `fresh`."""
    rows = fid_rows(run)
    best = best_record(run)
    if ([r["step"] for r in rows] != [FID_INTERVAL, FID_STEPS]
            or not all(np.isfinite(r["fid"]) for r in rows)
            or best is None or best["metric"] != min(r["fid"] for r in rows)):
        raise AssertionError(f"{tag}: fid.jsonl {rows}, best.json {best}")
    restored = restore_checkpoint(run, fresh, step=-1)
    if restored.step != best["step"]:
        raise AssertionError(f"{tag}: best.json {best}, restored step {restored.step}")
    print(f"[eval] {tag}: fid.jsonl {rows}; best.json {best} restores", flush=True)
    return {"fid_jsonl": rows, "best": best}


def timed_evaluation(tag: str, make_fid_fn, state, per_eval: dict, smi: str) -> dict:
    """The tracker outside the loop: the wall time of its real-side set-up,
    then one evaluation (after one warm-up) with its launches, its wall
    time and the device's idle share under torch.profiler."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fid_fn = make_fid_fn()
    setup_s = time.perf_counter() - t0
    fid_fn(state)
    # The host's share of the wall: the Frechet distance (scipy's sqrtm).
    frechet_s, frechet_distance = [], fid.frechet_distance

    def timed_frechet(*args):
        t = time.perf_counter()
        try:
            return frechet_distance(*args)
        finally:
            frechet_s.append(time.perf_counter() - t)

    fid.frechet_distance = timed_frechet
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        value = fid_fn(state)
        torch.cuda.synchronize()
    finally:
        fid.frechet_distance = frechet_distance
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    if counts != per_eval or not np.isfinite(value):
        raise AssertionError(f"{tag}: one evaluation launched {counts} != {per_eval}, "
                             f"fid {value}")
    walls = []

    def profiled():
        t = time.perf_counter()
        fid_fn(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)

    busy_ms, rows = device_profile(profiled)
    out = {"real_setup_s": setup_s, "eval_wall_ms": wall_ms, "frechet_ms": 1e3 * sum(frechet_s),
           "fid": value, "launches_per_eval": counts, "profiled_wall_ms": walls[0],
           "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / walls[0],
           "by_category": by_category(rows), "card": smi}
    print(f"[eval] {tag}: real side {setup_s:.3f} s ({FID_SAMPLES} samples); one evaluation "
          f"{wall_ms:.1f} ms ({out['frechet_ms']:.1f} ms of it in frechet_distance), fid "
          f"{value:.4f}, launches {counts}; under torch.profiler "
          f"{walls[0]:.1f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{out['idle_share']:.3f}; {smi}", flush=True)
    return out


def tracked_trainers(tmp: str, g_run: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 11, the trainers: each runs FID_STEPS steps without and with
    --fid_interval FID_INTERVAL --fid_samples FID_SAMPLES, under the train
    step's TF32 settings, with exact launches (the steps' and the 2
    evaluations' renders)."""
    renders = -(-FID_SAMPLES // BATCH)  # per evaluation
    r_args = ["--g_path", g_run, "--batch_size", str(BATCH), "--log_interval", "10"]
    track_args = ["--fid_interval", str(FID_INTERVAL), "--fid_samples", str(FID_SAMPLES)]
    glis_cfg = TrainGLISConfig.from_args(TRAINER_ARGS + track_args)
    rsep_cfg = r_separate_config(g_run, r_args + track_args)
    it_args = TRAINER_ARGS + ["--r_chain_length", "2", "--lambda_r", "0.9"]
    it_cfg = TrainRIterativeConfig.from_args(it_args + track_args)
    g_cfg = TrainGLISConfig.load(os.path.join(g_run, "config.json"))
    # name -> (CLI, its arguments, its launches, a fresh state for the
    # restore, the tracker of a trained state)
    trainers = {
        "train_glis": (train_glis, TRAINER_ARGS, glis_launches(glis_cfg),
                       lambda s: create_glis_state(glis_cfg),
                       lambda s: (lambda: train_glis.make_fid_fn(glis_cfg, s.device))),
        "train_r_separate": (train_r_separate, r_args, r_separate_launches(rsep_cfg),
                             lambda s: create_r_state(rsep_cfg, s.generator, s.discriminator),
                             lambda s: (lambda: train_r_separate.make_fid_fn(
                                 rsep_cfg, g_cfg, s.generator))),
        "train_r_iterative": (train_r_iterative, it_args, r_iterative_launches(it_cfg),
                              lambda s: create_r_iterative_state(it_cfg),
                              lambda s: (lambda: train_r_iterative.make_fid_fn(it_cfg, s.device))),
    }
    out = {}
    with cudnn_tf32():
        for name, (cli, args, (per_step, per_render), fresh, make) in trainers.items():
            tag = f"eval {name}"
            common = args + ["--niter", str(FID_STEPS), "--vis_interval", "0",
                             "--save_interval", str(FID_STEPS)]
            _, plain, _, _ = counted_run(
                tag, f"{FID_STEPS} steps without --fid_interval", cli,
                common + ["--save_path", os.path.join(tmp, f"{name}_plain")],
                launches(per_step, FID_STEPS, per_render, 0))
            run = os.path.join(tmp, f"{name}_fid")
            state, tracked, text, counts = counted_run(
                tag, f"{FID_STEPS} steps with --fid_interval {FID_INTERVAL}, 2 evaluations of "
                f"{renders} renders", cli,
                common + ["--save_path", run] + track_args,
                launches(per_step, FID_STEPS, per_render, 2 * renders))
            for k, n in counts.items():
                kernel_rows[k].setdefault("launches_eval", {})[f"{name} --fid_interval"] = n
            tracking = check_tracking(tag, run, fresh(state))
            ratio = tracked["images_per_sec"] / plain["images_per_sec"]
            print(f"[eval] {name}: {tracked['images_per_sec']:.1f} img/s with --fid_interval "
                  f"{FID_INTERVAL} against {plain['images_per_sec']:.1f} without ({ratio:.3f}); "
                  f"{smi}", flush=True)
            per_eval = {k: renders * v for k, v in per_render.items()}
            out[name] = {"run_dir": run, "images_per_sec": tracked["images_per_sec"],
                         "images_per_sec_without": plain["images_per_sec"],
                         "rate_ratio": ratio, "launches": counts, **tracking,
                         "evaluation": timed_evaluation(name, make(state), state, per_eval, smi),
                         "card": smi}
            del state
    return out


def finite_numbers(obj) -> bool:
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or np.isfinite(obj)


def eval_clis(tmp: str, tracked: dict, kernel_rows: dict, smi: str) -> dict:
    """Phase 11, the offline evaluators on phases 8-10's run directories
    (and the tracked G-LIS run for --step -1), EVAL_SAMPLES samples in
    batches of BATCH, each with exact launches and finite values."""
    g_run, r_run, it_run = (os.path.join(tmp, d) for d in ("run", "rsep", "riter"))
    glis_cfg = TrainGLISConfig.load(os.path.join(g_run, "config.json"))
    rsep_cfg = TrainRSeparateConfig.load(os.path.join(r_run, "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(it_run, "config.json"))
    acts = generator_plan(glis_cfg.image_size)[1] - 1  # TPReLUs of D's trunk
    _, render = glis_launches(glis_cfg)
    _, pair = r_separate_launches(rsep_cfg)
    _, chain = r_iterative_launches(it_cfg)
    scored = {**render, "fused_tprelu": render["fused_tprelu"] + acts}
    batches = -(-EVAL_SAMPLES // BATCH)
    fid_args = ["--load_path", g_run, "--dataset", "synthetic"]
    runs = {
        "compute_fid": (compute_fid, fid_args, render),
        "compute_fid --d_filter": (compute_fid, fid_args + ["--d_filter"], scored),
        "compute_fid --r_path": (compute_fid, fid_args + ["--r_path", r_run], pair),
        "compute_fid --second_opinion": (compute_fid, fid_args + ["--second_opinion"], render),
        "compute_fid --step -1": (compute_fid, ["--load_path", tracked["train_glis"]["run_dir"],
                                                "--dataset", "synthetic", "--step", "-1"],
                                  render),
        "eval_stages": (eval_stages, ["--load_path", g_run], scored),
        "eval_chain": (eval_chain, ["--load_path", it_run],
                       {**chain, "fused_tprelu": chain["fused_tprelu"] + acts}),
    }
    out = {}
    for label, (cli, args, per_batch) in runs.items():
        want = {k: batches * v for k, v in per_batch.items()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(args + ["--num_samples", str(EVAL_SAMPLES), "--batch_size", str(BATCH)])
        wall_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        print(f"[eval] {label}: launch counts {counts} (want {want}), {wall_s:.3f} s; {smi}",
              flush=True)
        if counts != want or not finite_numbers(result):
            raise AssertionError(f"{label}: launches {counts} != {want} or non-finite {result}")
        for k, n in counts.items():
            kernel_rows[k].setdefault("launches_eval", {})[label] = n
        out[label] = {"result": result, "wall_s": wall_s, "launches": counts}
    return out


def evaluation(tmp: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 11."""
    extractor = check_extractor(smi)
    tracked = tracked_trainers(tmp, os.path.join(tmp, "run"), kernel_rows, smi)
    return {"extractor": extractor, "trainers": tracked,
            "clis": eval_clis(tmp, tracked, kernel_rows, smi), "card": smi}


# ---------------------------------------------------------------- samplers

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO_MANIFEST = os.path.join(REPO, "data", "demo20k", "MANIFEST.json")
RENDER_GOLDEN = os.path.join(REPO, "tests", "torch_port_render_golden.json")
# demo20k's first images, which hold its spot hashes img00000 and img01250.
DEMO_COUNT, DEMO_SPOTS = 1251, ("img00000.jpg", "img01250.jpg")
DEMO_ARGS = ["--size", "200", "--seed", "0", "--quality", "92", "--style", "diverse"]
IMAGE_STEPS, IMAGE_FID_INTERVAL = 40, 20
WRITERS = ("save_stage_grids", "save_stage_gif", "write_png")
GOLDEN_TOL = 1e-4  # fp32 without TF32, with the kernels; the CPU holds 1e-5


def demo_data(tmp: str, smi: str) -> dict:
    """Phase 12(a): the port's make_demo_data writes demo20k's first
    DEMO_COUNT images; their spot hashes must be the manifest's wherever
    pillow and libjpeg are the manifest's."""
    folder = os.path.join(tmp, "demo20k")
    t0 = time.perf_counter()
    make_demo_data.main(["--out", folder, "--count", str(DEMO_COUNT)] + DEMO_ARGS)
    seconds = time.perf_counter() - t0
    with open(DEMO_MANIFEST) as f:
        manifest = json.load(f)
    versions = make_demo_data.library_versions()
    same_libs = all(versions[k] == manifest["versions"][k] for k in ("pillow", "libjpeg"))
    equal = {}
    for name in DEMO_SPOTS:
        with open(os.path.join(folder, name), "rb") as f:
            equal[name] = hashlib.sha256(f.read()).hexdigest() == manifest["sha256_spot_check"][name]
    print(f"[samplers] make_demo_data: {DEMO_COUNT} images in {seconds:.3f} s "
          f"({DEMO_COUNT / seconds:.1f} images/s, one host thread); pillow/libjpeg here "
          f"{versions['pillow']}/{versions['libjpeg']}, the manifest's "
          f"{manifest['versions']['pillow']}/{manifest['versions']['libjpeg']}", flush=True)
    if same_libs:
        print(f"[samplers] spot hashes against data/demo20k/MANIFEST.json: {equal}", flush=True)
        if not all(equal.values()):
            raise AssertionError(f"demo images differ from the manifest's hashes: {equal}")
    else:
        print(f"[samplers] the hash check did NOT run: pillow/libjpeg {versions} differ from the "
              f"manifest's {manifest['versions']} (equal anyway: {equal})", flush=True)
    return {"folder": folder, "count": DEMO_COUNT, "seconds": seconds,
            "images_per_s": DEMO_COUNT / seconds, "versions": versions,
            "manifest_versions": manifest["versions"], "hash_check_ran": same_libs,
            "spot_hashes_equal": equal, "card": smi}


def image_run(tmp: str, folder: str, kernel_rows: dict, smi: str) -> tuple:
    """Phase 12(b): train_glis in-process on the demo images, flagship,
    batch 64, --data_cache --g_ema 0.999 --fid_interval 20, 40 steps and a
    save at 40, with exact launches (the steps' and 2 evaluations' renders),
    under the train step's TF32 settings. (run directory, summary)."""
    run = os.path.join(tmp, "demo_run")
    args = TRAINER_ARGS + [
        "--dataset", "folder", "--dataroot", folder, "--synthetic_on_device", "false",
        "--data_cache", "true", "--g_ema", "0.999", "--fid_interval", str(IMAGE_FID_INTERVAL),
        "--niter", str(IMAGE_STEPS), "--vis_interval", "0", "--save_interval", str(IMAGE_STEPS),
        "--save_path", run]
    cfg = TrainGLISConfig.from_args(args)
    per_step, per_render = glis_launches(cfg)
    renders = 2 * -(-cfg.fid_samples // BATCH)
    with cudnn_tf32():
        _, stats, _, counts = counted_run(
            "samplers", f"train_glis on the demo images, {IMAGE_STEPS} steps and 2 evaluations",
            train_glis, args, launches(per_step, IMAGE_STEPS, per_render, renders))
    for k, n in counts.items():
        kernel_rows[k].setdefault("launches_samplers", {})["train_glis on demo images"] = n
    rows = fid_rows(run)
    if ([r["step"] for r in rows] != [IMAGE_FID_INTERVAL, IMAGE_STEPS]
            or not all(np.isfinite(r["fid"]) for r in rows)
            or not all(np.isfinite(v) for v in stats["metrics"].values())):
        raise AssertionError(f"image run: fid.jsonl {rows}, metrics {stats['metrics']}")
    print(f"[samplers] image run: {stats['images_per_sec']:.1f} img/s (meter), fid.jsonl {rows}, "
          f"best.json {best_record(run)}; {smi}", flush=True)
    return run, {"images_per_sec": stats["images_per_sec"], "metrics": stats["metrics"],
                 "fid_jsonl": rows, "best": best_record(run), "launches": counts, "card": smi}


def timed_cli(module, args: list) -> tuple:
    """`module.main(args)` with the launch counters zeroed just before and
    read just after, and the time spent in its grid and GIF writers summed:
    (wall s, write s, launch counts, printed text)."""
    write_s = [0.0]
    originals = {n: getattr(module, n) for n in WRITERS if hasattr(module, n)}

    def timed(fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                write_s[0] += time.perf_counter() - t
        return call

    for name, fn in originals.items():
        setattr(module, name, timed(fn))
    tee = Tee(sys.stdout)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            module.main(args)
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)
    return time.perf_counter() - t0, write_s[0], ops.launch_counts(), tee.buf.getvalue()


def rendered(module, args: list) -> list:
    """The stage images each save_stage_grids call of `module.main(args)`
    is handed; nothing is written."""
    grids, original = [], module.save_stage_grids
    module.save_stage_grids = lambda images, *a, **k: grids.append(images)
    try:
        module.main(args)
    finally:
        module.save_stage_grids = original
    return grids


def sampler_clis(tmp: str, demo_run: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 12(c): every sampler on the image run (b) and on phases
    8-10's run directories, each with exact launches and its images/s with
    and without the PNG/GIF writes (the wall of the CLI call, the load of
    the run included); info on the four runs; the convert round trip."""
    g_run, r_run, it_run = (os.path.join(tmp, d) for d in ("run", "rsep", "riter"))
    cfg = TrainGLISConfig.load(os.path.join(demo_run, "config.json"))
    rsep_cfg = TrainRSeparateConfig.load(os.path.join(r_run, "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(it_run, "config.json"))
    acts = generator_plan(cfg.image_size)[1] - 1  # TPReLUs of a render, of D's trunk
    _, render = glis_launches(cfg)
    scored = {**render, "fused_tprelu": render["fused_tprelu"] + acts}

    def times(per: dict, n: int) -> dict:
        return {k: n * v for k, v in per.items()}

    def correction(steps: int) -> dict:
        # steps + 1 renders and steps R calls (trunk + head) a batch.
        return {"fused_tprelu": (steps + 1) * acts + steps * (acts + 1),
                "fused_tprelu_backward": 0,
                "lis_residual_mlp": (steps + 1) * rsep_cfg.r_iterations,
                "lis_residual_mlp_backward": 0, "fused_seed": steps + 1, "fused_seed_backward": 0}

    def chain(links: int) -> dict:
        return r_iterative_launches(it_cfg.replace(r_chain_length=links))[1]

    demo = ["--load_path", demo_run]
    threshold = ["--d_filter", "--d_threshold", "0.9999"]
    # label -> (CLI, arguments, images, launches)
    calls = {
        "sample": (sample, demo + ["--count", "256"], 256, times(render, 4)),
        "sample --d_filter": (sample, demo + ["--count", "256", "--d_filter"], 256,
                              times(scored, 4)),
        "sample --d_threshold 0.9999 (fill)": (
            sample, demo + ["--count", "64"] + threshold, 64,
            times(scored, sample.THRESHOLD_ROUNDS)),
        "sample --save_gif": (sample, demo + ["--save_gif"], 64, render),
        "sample --use_ema": (sample, demo + ["--use_ema"], 64, render),
        "sample --step -1": (sample, demo + ["--step", "-1"], 64, render),
        "sample --d_filter --d_filter_step -1": (
            sample, demo + ["--d_filter", "--d_filter_step", "-1"], 64, scored),
        "sample_interpolations slerp": (sample_interpolations, demo, 64, render),
        "sample_interpolations lerp": (sample_interpolations, demo + ["--interp_mode", "lerp"],
                                       64, render),
        "sample_r_separate": (sample_r_separate, ["--load_path", r_run], 64, correction(2)),
        "sample_r_iterative": (sample_r_iterative, ["--load_path", it_run], 64,
                               chain(it_cfg.r_chain_length)),
        "sample_r_iterative --chain_length 3": (
            sample_r_iterative, ["--load_path", it_run, "--chain_length", "3"], 64, chain(3)),
    }
    out = {}
    for i, (label, (cli, args, n, want)) in enumerate(calls.items()):
        wall, write_s, counts, text = timed_cli(
            cli, args + ["--save_path_samples", os.path.join(tmp, "samples", str(i))])
        fill = "filling" in text
        print(f"[samplers] {label}: launch counts {counts} (want {want}); {n} images in "
              f"{wall:.3f} s = {n / wall:.1f} images/s with the writes ({write_s:.3f} s of "
              f"them), {n / (wall - write_s):.1f} without; {smi}", flush=True)
        if counts != want or fill != ("fill" in label):
            raise AssertionError(f"{label}: launches {counts} != {want}, fill notice {fill}")
        for k, c in counts.items():
            kernel_rows[k].setdefault("launches_samplers", {})[label] = c
        out[label] = {"images": n, "wall_s": wall, "write_s": write_s,
                      "images_per_s": n / wall, "images_per_s_without_writes": n / (wall - write_s),
                      "launches": counts}

    # info on the four runs: parameter counts of the modules each holds.
    def n_params(*modules):
        return sum(p.numel() for m in modules for p in m.parameters())

    it_g = generator_config(it_cfg)
    want_params = {
        demo_run: (n_params(GeneratorLIS(cfg)), n_params(Discriminator(cfg)), 0),
        g_run: (n_params(GeneratorLIS(cfg)), n_params(Discriminator(cfg)), 0),
        r_run: (0, 0, n_params(Reverter(rsep_cfg))),
        it_run: (n_params(GeneratorLIS(it_g)), n_params(Discriminator(it_cfg)),
                 n_params(Reverter(it_cfg))),
    }
    infos = {}
    for run, want in want_params.items():
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = info.main(["--load_path", run])
        got = tuple(summary["params"][k] for k in ("params_g", "params_d", "params_r"))
        if got != want or any(ops.launch_counts().values()):
            raise AssertionError(f"info {run}: params {got} != {want}")
        infos[os.path.basename(run)] = {k: summary.get(k) for k in ("params", "step", "best")}
    print(f"[samplers] info: {infos}", flush=True)

    # The bridge: export, re-import, and the same images bit for bit.
    trips = {}
    for name, run, cli in (("demo_run", demo_run, sample), ("riter", it_run, sample_r_iterative)):
        pt, back = os.path.join(tmp, f"{name}.pt"), os.path.join(tmp, f"{name}_imported")
        convert_checkpoint.main(["--load_path", run, "--out", pt])
        convert_checkpoint.main(["--from_torch", pt, "--out_run", back])
        a, b = (rendered(cli, ["--load_path", r, "--save_path_samples",
                               os.path.join(tmp, "trip")]) for r in (run, back))
        if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: the re-imported run renders other images")
        trips[name] = {"bytes": os.path.getsize(pt), "batches": len(a), "bitwise": True}
    print(f"[samplers] convert_checkpoint export -> --from_torch: the same images bit for bit "
          f"{trips}", flush=True)
    return {"clis": out, "info": infos, "convert": trips, "card": smi}


def render_golden(smi: str) -> dict:
    """Phase 12(d): the flagship fp32 render and D's logits on the card,
    without TF32 and with the kernels, against the golden written from
    `gea` (`tests/test_torch_port_samplers.py --write`) within GOLDEN_TOL."""
    with open(RENDER_GOLDEN) as f:
        golden = json.load(f)
    recipe = golden["recipe"]
    cfg = FLAGSHIP.replace(dtype="float32")
    z = np.random.default_rng(7).standard_normal((recipe["batch"], cfg.code_size))
    pixels = np.random.default_rng(5).integers(0, (80, 80, 3), size=(24, 3))
    g = generator_from_jax_params(init_generator_params(cfg, recipe["g_seed"]), cfg)
    d = discriminator_from_jax_params(init_discriminator_params(cfg, recipe["d_seed"]), cfg)
    ops.reset_launch_counts()
    with torch.no_grad():
        images = g.render(torch.from_numpy(z.astype(np.float32)).cuda())[0]
        s, b = images.shape[:2]
        logits = d(images.reshape(s * b, *images.shape[2:])).reshape(s, b)
    counts = ops.launch_counts()
    images = images.cpu().double().numpy()
    y, x, c = pixels.T
    got = {"mean": images.mean(axis=(2, 3, 4)), "std": images.std(axis=(2, 3, 4)),
           "pixels": images[:, :, y, x, c], "d_logits": logits.cpu().double().numpy()}
    errs = {k: float(np.abs(v - np.asarray(golden[k])).max()) for k, v in got.items()}
    acts = generator_plan(cfg.image_size)[1] - 1
    want = {"fused_tprelu": 2 * acts, "fused_tprelu_backward": 0,
            "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0, "fused_seed": 1,
            "fused_seed_backward": 0}
    print(f"[samplers] flagship fp32 render + D vs gea's golden: max |err| {errs} (tol "
          f"{GOLDEN_TOL}); launches {counts} (want {want}); {smi}", flush=True)
    if max(errs.values()) > GOLDEN_TOL or counts != want:
        raise AssertionError(f"render golden: errors {errs}, launches {counts}")
    return {"max_abs_err": errs, "tol": GOLDEN_TOL, "launches": counts, "card": smi}


def samplers(tmp: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 12."""
    t0 = time.perf_counter()
    data = demo_data(tmp, smi)
    run, trained = image_run(tmp, data["folder"], kernel_rows, smi)
    clis = sampler_clis(tmp, run, kernel_rows, smi)
    golden = render_golden(smi)
    seconds = time.perf_counter() - t0
    print(f"[samplers] phase 12 in {seconds:.1f} s", flush=True)
    return {"demo_data": data, "image_run": trained, **clis, "render_golden": golden,
            "seconds": seconds, "card": smi}


# ------------------------------------------------------- export and serving

SERVE_DEVICE = "cuda"  # the device phase 13's artifacts are exported and served on
STREAM_BATCHES = 32
HTTP_CLIENTS, HTTP_REQUESTS = 16, 8


def fp32_copy(src: str, dst: str, config_cls, **overrides) -> str:
    """A run directory that reads `src`'s checkpoints (a symlink) under its
    config in float32 (and `overrides`), with its best.json."""
    os.makedirs(dst)
    cfg = config_cls.load(os.path.join(src, "config.json"))
    cfg.replace(dtype="float32", **overrides).save(os.path.join(dst, "config.json"))
    os.symlink(os.path.join(src, "checkpoints"), os.path.join(dst, "checkpoints"))
    record = best_record(src)
    if record is not None:
        record_best_step(dst, record["step"], record["metric"], record["label"])
    return dst


def artifact_launches(kind: str, cfg, links: int = 0) -> dict:
    """Launches of one scored render of an artifact of `kind`: the stages'
    renders (and R's calls) and D's trunk on the final stage."""
    acts = generator_plan(cfg.image_size)[1] - 1
    if kind == "glis":
        per = glis_launches(cfg)[1]
    elif kind == "r_path":
        per = r_separate_launches(cfg)[1]  # one correction step
    else:
        per = r_iterative_launches(cfg.replace(r_chain_length=links))[1]
    return {**per, "fused_tprelu": per["fused_tprelu"] + acts}


def export_variant(tmp: str, label: str, args: list, want: dict, bf16: bool,
                   kernel_rows: dict, smi: str) -> dict:
    """export_model (with its selfcheck) timed, the artifact's size and load
    time, its render of 64 codes against the live render of the same
    options, and the launches of one call of each, counted apart."""
    out = os.path.join(tmp, "exports", label.replace(" ", "_"))
    argv = args + ["--out", out, "--device", SERVE_DEVICE]
    t0 = time.perf_counter()
    manifest = export_model.main(argv)
    export_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(out, serve.ARTIFACT))
    t0 = time.perf_counter()
    model = serve.load(out, device=SERVE_DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live = export_model.live_model(export_model.parse(argv))[0]
    z = np.random.default_rng(0).standard_normal((BATCH, model.code_size)).astype(np.float32)
    counts = {}
    for who, m in (("live", live), ("artifact", model)):
        m(z)  # warm: the first call of a program pays its set-up
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        counts[who] = (m(z), ops.launch_counts())
    (want_out, live_counts), (got, art_counts) = counts["live"], counts["artifact"]
    if not (art_counts == live_counts == want):
        raise AssertionError(f"{label}: launches artifact {art_counts}, live {live_counts}, "
                             f"want {want}")
    for k, n in art_counts.items():
        kernel_rows[k]["launches_serving"][f"artifact {label}"] = n
    diff = np.abs(got["images"].astype(int) - want_out["images"].astype(int))
    frac = float((diff > 1).mean())
    score_err = float(np.abs(got["scores"] - want_out["scores"]).max()) if "scores" in got else 0.0
    ok = (diff.max() <= 3 and frac <= 0.01) if bf16 else (diff.max() <= 1 and score_err <= 1e-5)
    print(f"[export] {label}: export + selfcheck {export_s:.3f} s, {nbytes / 1e6:.3f} MB, load "
          f"{load_s:.3f} s; vs live at batch {BATCH}: max uint8 diff {diff.max()}, "
          f"{frac:.4%} beyond 1 level, scores max |diff| {score_err:.3e}; launches {art_counts} "
          f"(live {live_counts}); {smi}", flush=True)
    if not ok or not np.isfinite(got.get("scores", np.zeros(1))).all():
        raise AssertionError(f"{label}: the artifact's render differs from the live one")
    return {"dir": out, "model": model, "live": live, "summary": {
        "export_s": export_s, "mb": nbytes / 1e6, "load_s": load_s,
        "max_uint8_diff": int(diff.max()), "frac_beyond_1": frac, "scores_max_abs": score_err,
        "launches": art_counts, "outputs": manifest["outputs"]}}


def export_variants(tmp: str, kernel_rows: dict, smi: str) -> dict:
    """Every export of phase 13, in bf16 (the runs as trained) and in fp32
    (the same checkpoints under a float32 config)."""
    demo, rsep, riter = (os.path.join(tmp, d) for d in ("demo_run", "rsep", "riter"))
    r_cfg = TrainRSeparateConfig.load(os.path.join(rsep, "config.json"))
    r_g_cfg = TrainGLISConfig.load(os.path.join(r_cfg.g_path, "config.json"))
    g_fp32 = fp32_copy(r_cfg.g_path, os.path.join(tmp, "fp32_run"), TrainGLISConfig)
    runs = {"bf16": (demo, rsep, riter), "fp32": (
        fp32_copy(demo, os.path.join(tmp, "fp32_demo_run"), TrainGLISConfig),
        fp32_copy(rsep, os.path.join(tmp, "fp32_rsep"), TrainRSeparateConfig, g_path=g_fp32),
        fp32_copy(riter, os.path.join(tmp, "fp32_riter"), TrainRIterativeConfig))}
    g_cfg = TrainGLISConfig.load(os.path.join(demo, "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(riter, "config.json"))
    links = it_cfg.r_chain_length
    out = {}
    for dt, (d, r, i) in runs.items():
        variants = {
            "all_stages with_scores": (["--load_path", d, "--all_stages", "1",
                                        "--with_scores", "1"], artifact_launches("glis", g_cfg)),
            "step -1 use_ema": (["--load_path", d, "--step", "-1", "--use_ema"],
                                artifact_launches("glis", g_cfg)),
            "batch 64": (["--load_path", d, "--batch", str(BATCH)],
                         artifact_launches("glis", g_cfg)),
            "r_path": (["--r_path", r], artifact_launches("r_path", r_g_cfg)),
            f"ri_path {links} links": (["--ri_path", i],
                                       artifact_launches("ri_path", it_cfg, links)),
            "ri_path 3 links": (["--ri_path", i, "--chain_links", "3"],
                                artifact_launches("ri_path", it_cfg, 3)),
        }
        for label, (args, want) in variants.items():
            out[f"{label} {dt}"] = export_variant(tmp, f"{label} {dt}", args, want,
                                                  dt == "bf16", kernel_rows, smi)
    return out


def filtered_s(model) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.sample_filtered(COUNT, seed=1, oversample=OVERSAMPLE, batch_size=BATCH)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def serving_times(art: dict, live_serve: dict, smi: str) -> dict:
    """The bf16 scored artifact with every stage: one render + score's device
    time beside the live ServeFunction's, sample_filtered's rate and idle
    share beside the live function's (in turns, the host drifts between
    phases) and phase 6's, and stream at depth 1 and 8."""
    model, live = art["model"], art["live"]
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, model.code_size)).astype(np.float32)).cuda()
    with torch.inference_mode():
        times = {}
        for who, fn in (("artifact", model._fn), ("live", live._fn), ("artifact again", model._fn),
                        ("live again", live._fn)):
            times[who] = time_ms(lambda: fn(z), RENDER_SPIN_CYCLES)
        profiled_ms, top = device_profile(lambda: model._fn(z))
        # Host time to enqueue one render (synchronized after each), in turns.
        enqueue = {"artifact": [], "live": []}
        for who, fn in (("artifact", model._fn), ("live", live._fn)) * 2:
            spans = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(z)
                spans.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            enqueue[who].append(statistics.median(spans) * 1e3)
    walls = {"artifact": [], "live": []}
    for who in ("artifact", "live", "live", "artifact") * 2:
        walls[who].append(filtered_s(model if who == "artifact" else live))
    wall = statistics.median(walls["artifact"])
    live_wall = statistics.median(walls["live"])
    busy_ms, _ = device_profile(
        lambda: model.sample_filtered(COUNT, seed=1, oversample=OVERSAMPLE, batch_size=BATCH))
    live_busy_ms, _ = device_profile(
        lambda: live.sample_filtered(COUNT, seed=1, oversample=OVERSAMPLE, batch_size=BATCH))
    rng = np.random.default_rng(1)
    zs = [rng.standard_normal((BATCH, model.code_size)).astype(np.float32)
          for _ in range(STREAM_BATCHES)]
    stream = {1: [], 8: []}
    for depth in (1, 8, 8, 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(o["images"].shape[0] for o in model.stream(iter(zs), depth=depth))
        stream[depth].append(n / (time.perf_counter() - t0))
    # Pinned host memory the caching allocator could not reuse, by depth.
    host_allocs = {}
    for depth in (1, 8):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sum(o["images"].shape[0] for o in model.stream(iter(zs), depth=depth))
        row = [e for e in prof.key_averages() if e.key == "cudaHostAlloc"]
        host_allocs[str(depth)] = {"calls": row[0].count if row else 0,
                                   "ms": row[0].self_cpu_time_total / 1e3 if row else 0.0}
    result = {
        "render_score_ms": times, "render_score_profiled_ms": profiled_ms,
        "render_enqueue_host_ms": enqueue,
        "render_score_by_category": by_category(top),
        "live_phase6_render_score_ms": live_serve["render_score_ms"],
        "sample_filtered_s": wall, "candidates_per_s": COUNT * OVERSAMPLE / wall,
        "sample_filtered_device_busy_ms": busy_ms,
        "sample_filtered_device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "live_candidates_per_s": COUNT * OVERSAMPLE / live_wall,
        "live_idle_share": 1.0 - live_busy_ms / (live_wall * 1e3),
        "sample_filtered_walls_s": walls,
        "live_phase6_candidates_per_s": live_serve["candidates_per_s"],
        "live_phase6_idle_share": live_serve["sample_filtered_device_idle_share"],
        "stream_images_per_s": {str(d): v for d, v in stream.items()},
        "stream_cuda_host_alloc": host_allocs, "card": smi}
    print(f"[serving] one render + score of {BATCH} codes (every stage, uint8): artifact "
          f"{times['artifact']:.4f} / {times['artifact again']:.4f} ms, live ServeFunction "
          f"{times['live']:.4f} / {times['live again']:.4f} ms (phase 6's G.render + D: "
          f"{live_serve['render_score_ms']:.4f} ms); profiled {profiled_ms:.4f} ms; host time to "
          f"enqueue it (median of 20, turns A L A L): {enqueue}; {smi}", flush=True)
    print(f"[serving] sample_filtered({COUNT}, oversample={OVERSAMPLE}, batch_size={BATCH}), "
          f"median of 4 in turns A L L A A L L A: artifact {wall:.4f} s = "
          f"{result['candidates_per_s']:.1f} candidates/s, idle share "
          f"{result['sample_filtered_device_idle_share']:.3f}; live ServeFunction "
          f"{live_wall:.4f} s = {result['live_candidates_per_s']:.1f} candidates/s, idle share "
          f"{result['live_idle_share']:.3f} (phase 6, live: {live_serve['candidates_per_s']:.1f} "
          f"candidates/s, idle share {live_serve['sample_filtered_device_idle_share']:.3f}); "
          f"{smi}", flush=True)
    print(f"[serving] stream of {STREAM_BATCHES} batches of {BATCH}: images/s at depth 1 "
          f"{stream[1]}, at depth 8 {stream[8]} (turns 1, 8, 8, 1); cudaHostAlloc in one more "
          f"run of each (torch.profiler, CPU): {host_allocs}; {smi}", flush=True)
    return result


def serve_cli(art_dir: str, tmp: str, smi: str) -> dict:
    """`python -m gea_torch.serve <artifact> --d_filter 1` in its own
    process: wall time, files written."""
    out = os.path.join(tmp, "serve_cli")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gea_torch.serve", art_dir, "--d_filter", "1",
                           "--count", str(COUNT), "--out", out, "--device", SERVE_DEVICE],
                          cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    print(f"[serving] python -m gea_torch.serve --d_filter 1: exit {proc.returncode}, "
          f"{wall:.3f} s (process start and load included), wrote {files}; "
          f"{proc.stdout.strip()[-200:]}; {smi}", flush=True)
    if proc.returncode != 0 or files != ["samples.png", "scores.json"]:
        raise AssertionError(f"python -m gea_torch.serve failed: {proc.stderr[-2000:]}")
    with open(os.path.join(out, "scores.json")) as f:
        scores = json.load(f)
    if len(scores) != COUNT or scores != sorted(scores, reverse=True):
        raise AssertionError(f"serve CLI scores: {scores[:8]}...")
    return {"wall_s": wall, "files": files, "card": smi}


def http_post(url: str, payload: dict) -> tuple:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def http_load(art_dir: str, smi: str) -> dict:
    """serve_http on 127.0.0.1 (port 0): HTTP_CLIENTS threads, each with
    HTTP_REQUESTS {"count": 4} requests and one {"count": 16, "oversample":
    4}; every response checked; requests/s, p50/p99 latency and the
    realized batch sizes."""
    import threading
    import urllib.request

    server, batcher = serve_http.make_server(art_dir, "127.0.0.1", 0, device=SERVE_DEVICE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results, errors = [], []
    try:
        batcher.warmup()

        def client(i):
            try:
                for j in range(HTTP_REQUESTS + 1):
                    filtered = j == HTTP_REQUESTS
                    payload = ({"count": 16, "oversample": 4, "seed": i} if filtered
                               else {"count": 4, "seed": i * 100 + j})
                    status, body, latency = http_post(base + "/render", payload)
                    n = payload["count"]
                    sc = body.get("scores", [])
                    if (status != 200 or len(body["images"]) != n or len(sc) != n
                            or not all(0 <= s <= 1 for s in sc)
                            or (filtered and (sc != sorted(sc, reverse=True)
                                              or body["filter"]["oversample"] != 4))):
                        raise AssertionError(f"bad response to {payload}: {status}")
                    results.append((filtered, latency))
            except Exception as e:  # reported after the join
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        batcher.close()
        thread.join(timeout=30)
    want = HTTP_CLIENTS * (HTTP_REQUESTS + 1)
    if errors or len(results) != want or any(t.is_alive() for t in threads):
        raise AssertionError(f"HTTP load: {len(results)}/{want} answered, errors {errors[:3]}")
    lat = np.array([r[1] for r in results]) * 1e3
    rows = HTTP_CLIENTS * (HTTP_REQUESTS * 4 + 16 * 4)  # a filtered request: one draw of 64
    if stats["rows"] != rows or stats["requests"] != want:
        raise AssertionError(f"HTTP stats {stats}, want {rows} rows")
    result = {"requests": want, "wall_s": wall, "requests_per_s": want / wall,
              "rows_per_s": rows / wall, "p50_ms": float(np.percentile(lat, 50)),
              "p99_ms": float(np.percentile(lat, 99)), "stats": stats, "card": smi}
    print(f"[serving] HTTP: {want} requests from {HTTP_CLIENTS} clients in {wall:.3f} s = "
          f"{result['requests_per_s']:.1f} requests/s ({result['rows_per_s']:.1f} rendered "
          f"rows/s), latency p50 {result['p50_ms']:.2f} ms, p99 {result['p99_ms']:.2f} ms; "
          f"realized batch sizes {stats['batch_sizes']} (mean {stats['mean_batch_rows']}); "
          f"{smi}", flush=True)
    return result


def cpu_load(art: dict, smi: str) -> dict:
    """The artifact written on the card, loaded with device="cpu": a batch
    of 3 within the selfcheck's band of the card's render."""
    model = serve.load(art["dir"], device="cpu")
    bf16 = model.manifest["dtype"] == "bfloat16"
    z = np.random.default_rng(3).standard_normal((3, model.code_size)).astype(np.float32)
    got, want = model(z), art["model"](z)
    diff = np.abs(got["images"].astype(int) - want["images"].astype(int))
    frac = float((diff > 1).mean())
    print(f"[serving] {art['dir']} on the CPU vs the card: max uint8 diff {diff.max()}, "
          f"{frac:.4%} beyond 1 level (band {3 if bf16 else 1}, 1%); {smi}", flush=True)
    if diff.max() > (3 if bf16 else 1) or frac > 0.01:
        raise AssertionError("the artifact renders otherwise on the CPU")
    return {"max_uint8_diff": int(diff.max()), "frac_beyond_1": frac}


def export_serving(tmp: str, kernel_rows: dict, live_serve: dict, smi: str) -> dict:
    """Phase 13."""
    t0 = time.perf_counter()
    arts = export_variants(tmp, kernel_rows, smi)
    scored = arts["all_stages with_scores bf16"]
    result = {
        "exports": {k: v["summary"] for k, v in arts.items()},
        "serving": serving_times(scored, live_serve, smi),
        "cpu_load": {dt: cpu_load(arts[f"all_stages with_scores {dt}"], smi)
                     for dt in ("bf16", "fp32")},
        "serve_cli": serve_cli(arts["step -1 use_ema bf16"]["dir"], tmp, smi),
        "http": http_load(arts["step -1 use_ema bf16"]["dir"], smi),
    }
    result["seconds"] = time.perf_counter() - t0
    print(f"[export] phase 13 in {result['seconds']:.1f} s", flush=True)
    return result


# ----------------------------------------------------- chunked dispatch


GRAPH_K, GRAPH_REPLAYS = 8, 2  # a K = 8 graph, replayed twice: 16 steps
STEP_GOLDEN = os.path.join(REPO, "tests", "torch_port_step_golden.json")
STEP_DRAWS = os.path.join(REPO, "tests", "torch_port_step_draws.npz")
CHUNK_TOL = 2e-2  # graphed vs eager and vs the golden: atol 2e-2, rtol 2%, 2% of elements
# Graphed vs eager metrics under deterministic algorithms, relative: the two
# differ only in the capturable Adam's fp32 arithmetic (at most 2.3e-5 on an
# H100 80GB HBM3 at 700 W).
CHUNK_METRICS_TOL = 1e-3


def graph_trainers() -> dict:
    """tag -> (cfg at K = GRAPH_K, make_state(cfg), build_step(cfg), launches
    of one step, the real batch or None) of the three trainers at flagship
    width, bf16, batch 64, BCE; R-separate against a frozen G and D made
    from seeded params."""
    rsep = TrainRSeparateConfig.from_args(TRAINER_ARGS)
    rsep_g = generator_from_jax_params(init_generator_params(rsep, 0), rsep)
    rsep_d = discriminator_from_jax_params(init_discriminator_params(rsep, 1), rsep)
    glis = TrainGLISConfig.from_args(TRAINER_ARGS)
    riter = TrainRIterativeConfig.from_args(TRAINER_ARGS + ["--r_chain_length", "2",
                                                            "--lambda_r", "0.9"])
    k = {"steps_per_dispatch": GRAPH_K}
    return {
        "g-lis": (glis.replace(**k), create_glis_state, build_glis_train_step,
                  glis_launches(glis)[0], real_batch(glis)),
        "r-separate": (rsep.replace(**k), lambda c: create_r_state(c, rsep_g, rsep_d),
                       build_r_separate_step, r_separate_launches(rsep)[0], None),
        "r-iterative": (riter.replace(**k), create_r_iterative_state, build_r_iterative_step,
                        r_iterative_launches(riter)[0], real_batch(riter)),
    }


# Each wrapper's kernels by their names in a torch.profiler trace, with the
# launches one call makes: a bf16 seed call is two launches of seed_tap_gemm
# (the projection, then the transposed conv); every seed backward that
# computes any gradient (in either dtype) launches seed_bwd_project once.
KERNEL_EVENTS = {"fused_tprelu": (("tprelu_kernel", 1),),
                 "fused_tprelu_backward": (("tprelu_grad_kernel", 1),),
                 "lis_residual_mlp": (("lis_kernel_", 1),),
                 "lis_residual_mlp_backward": (("lis_bwd_kernel", 1),),
                 "fused_seed": (("seed_tap_gemm", 2), ("seed_kernel_f32", 1)),
                 "fused_seed_backward": (("seed_bwd_project", 1),)}


def calls_from(launches) -> dict:
    """Each wrapper's calls from `launches(kernel name) -> launches of
    kernels so named`, over the launches a call makes."""
    out = {}
    for name, kernels in KERNEL_EVENTS.items():
        out[name] = 0
        for key, per_call in kernels:
            n = launches(key)
            if n % per_call:
                raise AssertionError(f"{n} {key} launches are not whole calls of {name}")
            out[name] += n // per_call
    return out


def traced_calls(rows) -> dict:
    """Each wrapper's calls in the rows of a `device_profile` trace, from
    its kernels' events. A trace can miss records (CUPTI drops some now
    and then), never invent them."""
    return calls_from(lambda key: sum(count for k, _, count in rows if key in k))


@contextlib.contextmanager
def graphs_kept():
    """Graphs captured meanwhile keep their CUDA graph after it is
    instantiated (`keep_graph`, debug mode), so that `graph_calls` can
    read it."""
    made = torch.cuda.CUDAGraph

    def kept():
        graph = made(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    torch.cuda.CUDAGraph = kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_calls(graph, tmp: str) -> tuple:
    """(each wrapper's calls, all kernel nodes) in a graph captured under
    `graphs_kept`, read from CUDA's own dump of it
    (`cudaGraphDebugDotPrint`), which names each kernel node's function
    once: a replay launches exactly these nodes."""
    text = graph_text(graph, tmp)
    return calls_from(text.count), text.count("{KERNEL")


def graph_text(graph, tmp: str) -> str:
    """CUDA's dump of a graph captured under `graphs_kept`."""
    path = os.path.join(tmp, "graph.dot")
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    os.remove(path)
    return text


def busy_and_wall(fn) -> tuple:
    """(device busy ms from torch.profiler, host wall ms, each wrapper's
    calls counted from the trace's kernel events) of one call of `fn`,
    which ends when the device has."""
    walls = []

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    busy, rows = device_profile(timed)
    return busy, walls[0], traced_calls(rows)


def eager_vs_graphed(tag: str, entry: tuple, smi: str, tmp: str) -> dict:
    """Phase 14(a) for one trainer: GRAPH_K * GRAPH_REPLAYS eager steps
    against GRAPH_REPLAYS replays of a K-step graph, warm-up and capture
    off the clock; wall, images/s, device busy and idle share, launches.
    The launch counters after the replays are the dispatcher's (a replay
    runs no Python), so the graph's own kernel nodes are counted (CUDA's
    dump of the captured graph) and must equal GRAPH_K eager steps'
    counters; the kernels' events in a torch.profiler trace of the eager
    steps and of the replays are recorded beside them and may not exceed
    the counters."""
    cfg, make_state, build_step, per_step, real = entry
    n = GRAPH_K * GRAPH_REPLAYS
    want = {k: n * v for k, v in per_step.items()}
    out = {}
    eager_cfg = cfg.replace(steps_per_dispatch=1)
    state, step = make_state(eager_cfg), build_step(eager_cfg)
    for _ in range(2):
        step(state, real)

    def eager(steps):
        for _ in range(steps):
            step(state, real)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = counted(f"{tag} eager", lambda: eager(n), want)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    busy, pwall, traced = busy_and_wall(lambda: eager(n))
    out["eager"] = {"step_wall_ms": wall * 1e3, "images_per_s": BATCH / wall,
                    "busy_ms_per_step": busy / n, "idle_share": 1 - busy / pwall,
                    "launches": counts, "launches_traced": traced}
    del state, step
    torch.cuda.empty_cache()

    state, step = make_state(cfg), build_step(cfg)
    before = {k: p.detach().clone() for k, p in named_params(state).items()}
    dispatch = StepDispatcher(cfg, step)
    reals = [real] * GRAPH_K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graphs_kept():
        dispatch(state, reals)  # warm-up, capture, first replay (which instantiates)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    chunk = dispatch.chunks[GRAPH_K]
    nodes, kernel_nodes = graph_calls(chunk.graph, tmp)
    per_replay = {k: GRAPH_K * v for k, v in per_step.items()}
    if nodes != per_replay or chunk.launches != per_replay:
        raise AssertionError(f"{tag}: the graph's kernel nodes {nodes} and the dispatcher's "
                             f"count of a replay {chunk.launches}, not {GRAPH_K} steps' "
                             f"{per_replay}")
    history = []

    def replays():
        for _ in range(GRAPH_REPLAYS):
            history.append(dispatch(state, reals))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = counted(f"{tag} graphed", replays, want)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    busy, pwall, traced = busy_and_wall(replays)
    for mode, seen in (("graphed", traced), ("eager", out["eager"]["launches_traced"])):
        if any(seen[k] > v for k, v in want.items()):
            raise AssertionError(f"{tag}: the {mode} trace of {n} steps holds {seen} kernel "
                                 f"calls, more than the {want} launched")
    values = {k: v.tolist() for k, v in history[-1].items()}
    if not all(np.isfinite(x) for vs in values.values() for x in vs):
        raise AssertionError(f"{tag}: non-finite graphed metrics {values}")
    still = [k for k, p in named_params(state).items() if torch.equal(p, before[k])]
    if still or state.step != (1 + 2 * GRAPH_REPLAYS) * GRAPH_K:
        raise AssertionError(f"{tag}: parameters not moved by the graph {still[:8]}, "
                             f"step {state.step}")
    out["graphed"] = {"step_wall_ms": wall * 1e3, "images_per_s": BATCH / wall,
                      "busy_ms_per_step": busy / n, "idle_share": 1 - busy / pwall,
                      "launches": counts, "launches_traced": traced,
                      "launches_graph_nodes": {k: GRAPH_REPLAYS * v for k, v in nodes.items()},
                      "kernel_nodes_per_replay": kernel_nodes,
                      "launches_per_replay": chunk.launches,
                      "warm_up_s": dispatch.warm_up_s, "capture_s": chunk.capture_s,
                      "first_call_s": first_s, "pool_peak_mb": chunk.pool_peak_mb,
                      "metrics_last_chunk": values}
    for mode in ("eager", "graphed"):
        r = out[mode]
        print(f"[dispatch] {tag} {mode}: {r['step_wall_ms']:.3f} ms a step (wall, {n} steps) = "
              f"{r['images_per_s']:.1f} images/s; device busy {r['busy_ms_per_step']:.3f} ms a "
              f"step, idle share {r['idle_share']:.3f} (torch.profiler over {n} steps); "
              f"launches {r['launches']} (counters), {r['launches_traced']} (kernel events in "
              f"the trace); {smi}", flush=True)
    g = out["graphed"]
    print(f"[dispatch] {tag} K={GRAPH_K} graph: warm-up {g['warm_up_s']:.2f} s, capture "
          f"{g['capture_s']:.2f} s, pool peak {g['pool_peak_mb']:.1f} MB, a replay launches "
          f"{nodes} (the graph's kernel nodes, {kernel_nodes} in all) = the dispatcher's "
          f"count {g['launches_per_replay']}; every parameter moved", flush=True)
    del state, step, dispatch, chunk
    torch.cuda.empty_cache()
    return out


def injected(step, draws: Optional[list]):
    """`step` with `draws` (one noise dict a step) in place of its own;
    `step` itself with None."""
    if draws is not None:
        it = iter(draws)
        step.noise = lambda state: next(it)
    return step


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for every op (cuDNN's convolutions among
    them; cuBLAS through CUBLAS_WORKSPACE_CONFIG, which main sets), so
    that two runs of the same steps agree bit for bit."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def within(a: float, b: float) -> bool:
    return abs(a - b) <= CHUNK_TOL + CHUNK_TOL * abs(b)


def golden_deviations(metrics: list, state, golden: dict) -> dict:
    """Each step's metrics and the norm of every G and D tensor against
    the step golden: the entries off CHUNK_TOL and the largest deviations,
    absolute and relative."""
    pairs = [(f"step {i + 1} {k}", m[k], v) for i, m in enumerate(metrics)
             for k, v in golden["metrics"][i].items()]
    for part, module in (("g", state.generator), ("d", state.discriminator)):
        tensors = module.state_dict()
        pairs += [(f"{part} {k}", float(tensors[k].double().norm()), v)
                  for k, v in golden["norms"][part].items()]
    return {"off": [n for n, x, v in pairs if not within(x, v)],
            "max_abs": max(abs(x - v) for _, x, v in pairs),
            "max_rel": max(abs(x - v) / max(abs(v), 1e-12) for _, x, v in pairs)}


def chunk_agreement(tag: str, cfg, make_state, build_step, real, draws: Optional[list],
                    golden: Optional[dict] = None, named=None) -> dict:
    """Phase 14(b) for one trainer, fp32 without TF32, under deterministic
    algorithms: a graphed K = 2 chunk against 2 eager steps from the same
    params and draws (`draws`, or the state's own generator with None).
    Two eager runs must agree bit for bit. The graphed chunk (a capturable
    Adam with its lr read from the graph's buffer): the metrics within
    CHUNK_METRICS_TOL, and every parameter with at most CHUNK_TOL of its
    elements more than lr / 5 apart (Adam's first update is about lr * sign(g): a gradient
    near zero flips by 2 lr); the EMA shadow likewise against (1 - g_ema)
    * lr / 5. Both against the golden where there is one (metrics, the norm
    of every tensor). `named(state)` gives the parameters held to the share
    gate (all of them by default); batch norm's running statistics, where
    the models have them, are held to STATS_TOL."""
    named = named or named_params

    def eager_steps():
        st, step = make_state(cfg.replace(steps_per_dispatch=1)), build_step(cfg)
        fed = draws or [{}] * 2
        return st, [{k: v.item() for k, v in step(st, real, **d).items()} for d in fed]

    def tensors(st) -> dict:
        out = {n: (p, cfg.lr / 5) for n, p in named(st).items()}
        out.update({f"g_ema.{n}": (t, (1 - cfg.g_ema) * cfg.lr / 5)
                    for n, t in getattr(st, "g_ema", {}).items()})
        return out

    def apart(a, b) -> float:
        ta, tb = tensors(a), tensors(b)
        return max(((ta[n][0] - t).abs() > limit).float().mean().item()
                   for n, (t, limit) in tb.items())

    def rel(a, b) -> float:
        return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-2) for x, y in zip(a, b) for k in y)

    def bitwise(a, b) -> bool:
        ta, tb = tensors(a), tensors(b)
        return all(torch.equal(ta[n][0], t) for n, (t, _) in tb.items())

    with deterministic():
        eager_state, eager = eager_steps()
        again_state, again = eager_steps()
        graphed_cfg = cfg.replace(steps_per_dispatch=2)
        state = make_state(graphed_cfg)
        chunk = StepDispatcher(graphed_cfg, injected(build_step(graphed_cfg), draws))(
            state, [real] * 2)
        graphed = [{k: v[i].item() for k, v in chunk.items()} for i in range(2)]
    worst, share = rel(graphed, eager), apart(state, eager_state)
    same = again == eager and bitwise(again_state, eager_state)
    result = {"metrics_rel": worst, "params_apart_share": share, "eager": eager,
              "graphed": graphed, "eager_again_bitwise": same}
    bad = worst > CHUNK_METRICS_TOL or share > CHUNK_TOL or not same
    stats, eager_stats = running_stats(state), running_stats(eager_state)
    if stats:
        same = same and all(torch.equal(t, running_stats(again_state)[n])
                            for n, t in eager_stats.items())
        result["eager_again_bitwise"] = same
        result["stats_max_abs"] = max((t - eager_stats[n]).abs().max().item()
                                      for n, t in stats.items())
        bad = bad or not same or result["stats_max_abs"] > STATS_TOL
    if golden is not None:
        for label, metrics, st in (("eager", eager, eager_state), ("graphed", graphed, state)):
            result[f"golden_{label}"] = golden_deviations(metrics, st, golden)
            bad = bad or bool(result[f"golden_{label}"]["off"])
    print(f"[dispatch] {tag} fp32, no TF32, deterministic, batch {cfg.batch_size}: graphed "
          f"K=2 chunk vs 2 eager steps: metrics rel {worst:.3e} (tol {CHUNK_METRICS_TOL}), "
          f"largest share of a tensor's elements more than lr/5 apart {share:.6f} (tol "
          f"{CHUNK_TOL}); eager vs eager "
          f"again bit for bit: {same}" + (
              f"; running statistics max abs {result['stats_max_abs']:.3e} (tol {STATS_TOL})"
              if "stats_max_abs" in result else "") + "".join(
              f"; vs the step golden ({label}): max abs {g['max_abs']:.3e}, max rel "
              f"{g['max_rel']:.3e}, off {g['off']}" for label in ("eager", "graphed")
              if (g := result.get(f"golden_{label}")) is not None), flush=True)
    if bad:
        raise AssertionError(f"{tag}: the graphed chunk disagrees: {result}")
    return result


def fp32_chunks() -> dict:
    """Phase 14(b): G-LIS on the step golden's recipe (its config, params,
    real batch and `gea`'s draws, batch 4); then at the same width and
    phases 9-10's batch of 64, from seeded params: G-LIS under a cosine
    schedule whose second lr is half the first, with --g_ema, --grad_accum
    2 and --remat; G-LIS with WGAN-GP's double backward (both drawing
    their own noise); R-separate and R-iterative from numpy draws."""
    golden = json.loads(open(STEP_GOLDEN).read())
    cfg = TrainGLISConfig(**{**dataclasses.asdict(FLAGSHIP), "dtype": "float32",
                             "batch_size": 4, "dataset": "synthetic"})
    g_params, d_params = init_generator_params(cfg, 0), init_discriminator_params(cfg, 1)
    real = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (4, 80, 80, 3)).astype(np.float32)).cuda()
    z = torch.from_numpy(np.load(STEP_DRAWS)["z"]).cuda()
    out = {"g-lis": chunk_agreement(
        "g-lis", cfg, lambda c: create_glis_state(c, g_params, d_params), build_glis_train_step,
        real, [{"z": z[i], "spatial_noise": None, "gp_eps": None} for i in range(2)], golden)}
    wide = {**dataclasses.asdict(FLAGSHIP), "dtype": "float32", "batch_size": BATCH}
    glis = TrainGLISConfig(**{**wide, "dataset": "synthetic"})
    variants = {
        "g-lis cosine, g_ema, grad_accum 2, remat": glis.replace(
            lr_schedule="cosine", niter=2, lr_final=0.0, g_ema=0.999, grad_accum=2,
            remat=True),
        "g-lis wgan-gp": glis.replace(gan_loss="wgan-gp"),
    }
    for tag, vcfg in variants.items():
        out[tag] = chunk_agreement(
            tag, vcfg, lambda c: create_glis_state(c, g_params, d_params),
            build_glis_train_step, real_batch(vcfg), None)
    rng = np.random.default_rng(11)
    draws = [{"z": torch.from_numpy(rng.standard_normal((BATCH, cfg.code_size)).astype(
        np.float32)).cuda(), "spatial_noise": None} for _ in range(2)]
    rsep = TrainRSeparateConfig(**wide)
    g = generator_from_jax_params(g_params, rsep)
    d = discriminator_from_jax_params(d_params, rsep)
    out["r-separate"] = chunk_agreement(
        "r-separate", rsep, lambda c: create_r_state(c, g, d), build_r_separate_step, None,
        draws)
    riter = TrainRIterativeConfig(**{**wide, "r_chain_length": 2})
    out["r-iterative"] = chunk_agreement(
        "r-iterative", riter, create_r_iterative_state, build_r_iterative_step,
        real_batch(riter), draws)
    return out


def graphed_clis(tmp: str, k1_rates: dict, smi: str) -> dict:
    """Phase 14(c): the three CLIs at --steps_per_dispatch 8 with exact
    launches (replays counted): G-LIS 40 steps with saves and renders at
    the chunk ends that cross 20 and 40 (24, 40) and a bitwise round trip;
    43 steps (a ragged tail of 3) and a relaunch resuming at 43 to 60; the
    R trainers 40 steps each against / beside it; each meter rate beside
    the K = 1 rate of phases 8-10."""
    k8 = ["--steps_per_dispatch", str(GRAPH_K)]
    run = os.path.join(tmp, "run_k8")
    args = TRAINER_ARGS + k8 + ["--save_path", run, "--vis_interval", str(TRAINER_VIS),
                                "--save_interval", str(TRAINER_VIS)]
    cfg = TrainGLISConfig.from_args(args)
    per_step, per_render = glis_launches(cfg)
    out = {}

    def note(label, stats, k1):
        out[label] = {"images_per_sec": stats["images_per_sec"], "k1_images_per_sec": k1,
                      "metrics": stats["metrics"]}
        print(f"[dispatch] CLI {label} at K={GRAPH_K}: {stats['images_per_sec']:.1f} img/s "
              f"(meter) beside {k1 if k1 is not None else 'not run'} at K=1 (phases 8-10); "
              f"{smi}", flush=True)

    state, stats, _, counts = counted_run("dispatch", "train_glis K=8, 40 steps and 2 renders",
                                          train_glis, args + ["--niter", str(TRAINER_STEPS)],
                                          launches(per_step, TRAINER_STEPS, per_render, 2))
    saved = sorted(int(s) for s in os.listdir(os.path.join(run, "checkpoints")))
    grids = sorted(f for f in os.listdir(os.path.join(run, "samples")))
    want_grids = [f"samples_{s:08d}_stage{i}.png" for s in (24, 40) for i in range(cfg.n_stages)]
    if saved != [24, 40] or grids != want_grids:
        raise AssertionError(f"K=8 run: checkpoints {saved}, grids {grids}")
    trip = round_trip(run, TRAINER_STEPS, state, create_glis_state(cfg))
    note("train_glis", stats, k1_rates.get("g-lis"))
    out["train_glis"].update(launches=counts, checkpoints=saved, round_trip=trip)
    print(f"[dispatch] train_glis K=8: checkpoints {saved} and grids at 24, 40 (chunk ends); "
          f"bitwise round trip {trip}", flush=True)
    del state

    tail = os.path.join(tmp, "run_k8_tail")
    tail_args = TRAINER_ARGS + k8 + ["--save_path", tail, "--vis_interval", "0",
                                     "--save_interval", "0"]
    state, stats, _, counts = counted_run("dispatch", "train_glis K=8, 43 steps (tail of 3)",
                                          train_glis, tail_args + ["--niter", "43"],
                                          launches(per_step, 43, per_render, 0))
    out["ragged_tail"] = {"steps": state.step, "launches": counts}
    state, stats, text, counts = counted_run(
        "dispatch", "train_glis K=8 relaunch at 43 to 60", train_glis,
        tail_args + ["--niter", "60"], launches(per_step, 17, per_render, 0))
    line = f"resumed from {tail} at step 43"
    if line not in text or state.step != 60:
        raise AssertionError(f"misaligned resume: {line!r} printed {line in text}, "
                             f"step {state.step}")
    out["misaligned_resume"] = {"printed": line, "launches": counts,
                                "metrics": stats["metrics"]}
    del state

    rsep = os.path.join(tmp, "rsep_k8")
    rsep_args = ["--g_path", run, "--batch_size", str(BATCH), "--log_interval", "10",
                 "--save_path", rsep, "--vis_interval", str(TRAINER_VIS), "--save_interval",
                 str(TRAINER_VIS), *k8]
    r_step, r_render = r_separate_launches(r_separate_config(run, rsep_args))
    state, stats, _, counts = counted_run(
        "dispatch", "train_r_separate K=8, 40 steps and 2 renders", train_r_separate,
        rsep_args + ["--niter", str(TRAINER_STEPS)],
        launches(r_step, TRAINER_STEPS, r_render, 2))
    note("train_r_separate", stats, k1_rates.get("r-separate"))
    out["train_r_separate"]["launches"] = counts
    del state

    riter_args = TRAINER_ARGS + k8 + ["--r_chain_length", "2", "--lambda_r", "0.9",
                                      "--save_path", os.path.join(tmp, "riter_k8"),
                                      "--vis_interval", str(TRAINER_VIS), "--save_interval",
                                      str(TRAINER_VIS)]
    r_step, r_render = r_iterative_launches(TrainRIterativeConfig.from_args(riter_args))
    state, stats, _, counts = counted_run(
        "dispatch", "train_r_iterative K=8, 40 steps and 2 renders", train_r_iterative,
        riter_args + ["--niter", str(TRAINER_STEPS)],
        launches(r_step, TRAINER_STEPS, r_render, 2))
    note("train_r_iterative", stats, k1_rates.get("r-iterative"))
    out["train_r_iterative"]["launches"] = counts
    return out


def flag_runs(tmp: str, smi: str) -> dict:
    """Phase 14(d), short G-LIS runs at full width: --debug_checks with K=2
    (clean, then with a NaN in the input of iter 3, which must raise naming
    the op and the step), --profile_dir, --tensorboard."""
    base = TRAINER_ARGS + ["--vis_interval", "0", "--save_interval", "0"]
    out = {}
    t0 = time.perf_counter()
    state, stats, _ = run_cli(base + ["--save_path", os.path.join(tmp, "debug"), "--niter", "4",
                                      "--steps_per_dispatch", "2", "--debug_checks"])
    if state.step != 4 or not all(np.isfinite(v) for v in stats["metrics"].values()):
        raise AssertionError(f"--debug_checks clean run: step {state.step}, {stats['metrics']}")
    out["debug_clean_s"] = time.perf_counter() - t0
    make = train_glis.make_input_fn

    def poisoned(*args):
        fn = make(*args)

        def real(batch, step):
            out = fn(batch, step)
            if step == 2:
                out = out.clone()
                out[0, 0, 0, 0] = float("nan")
            return out

        return real

    train_glis.make_input_fn = poisoned
    try:
        run_cli(base + ["--save_path", os.path.join(tmp, "debug_nan"), "--niter", "4",
                        "--steps_per_dispatch", "2", "--debug_checks"])
        raise AssertionError("--debug_checks did not raise on a NaN input")
    except FloatingPointError as e:
        msg = str(e)
    finally:
        train_glis.make_input_fn = make
    if "step 1 of 2" not in msg or "(iter 3)" not in msg or "aten." not in msg:
        raise AssertionError(f"--debug_checks named the wrong place: {msg}")
    out["debug_nan_error"] = msg
    prof = os.path.join(tmp, "prof")
    run_cli(base + ["--save_path", os.path.join(tmp, "prof_run"), "--niter", "16",
                    "--steps_per_dispatch", str(GRAPH_K), "--profile_dir", prof])
    traces = os.listdir(prof)
    events = json.load(open(os.path.join(prof, traces[0])))["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if traces != ["trace_9-16.json"]:
        raise AssertionError(f"--profile_dir wrote {traces}")
    out["profile"] = {"trace": traces[0], "kernel_events": kernels, "events": len(events)}
    _, _, text = run_cli(base + ["--save_path", os.path.join(tmp, "tb_run"), "--niter", "16",
                                 "--steps_per_dispatch", str(GRAPH_K), "--tensorboard"])
    tb = os.path.join(tmp, "tb_run", "tb")
    files = os.listdir(tb) if os.path.isdir(tb) else []
    disabled = "[gea_torch] tensorboard disabled (" in text
    if not files and not disabled:
        raise AssertionError("--tensorboard wrote nothing and said nothing")
    out["tensorboard"] = {"files": files, "disabled_line": disabled}
    print(f"[dispatch] --debug_checks K=2: clean run in {out['debug_clean_s']:.1f} s; NaN in "
          f"iter 3's input raised: {msg}", flush=True)
    print(f"[dispatch] --profile_dir: {traces[0]} with {kernels} kernel events of "
          f"{len(events)}; --tensorboard: files {files}, disabled line printed {disabled}; "
          f"{smi}", flush=True)
    return out


def dispatch_phase(tmp: str, kernel_rows: dict, smi: str, k1_rates: dict) -> dict:
    """Phase 14: --steps_per_dispatch as CUDA graphs in the three trainers,
    and --debug_checks, --profile_dir and --tensorboard."""
    t0 = time.perf_counter()
    out = {}
    with cudnn_tf32():
        out["timing"] = {tag: eager_vs_graphed(tag, entry, smi, tmp)
                         for tag, entry in graph_trainers().items()}
    for name, n in out["timing"]["g-lis"]["graphed"]["launches_graph_nodes"].items():
        kernel_rows[name]["launches_graphed"] = n
    out["fp32"] = fp32_chunks()
    with cudnn_tf32():
        out["clis"] = graphed_clis(tmp, k1_rates, smi)
        out["flags"] = flag_runs(tmp, smi)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = smi
    print(f"[dispatch] phase 14 in {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------------------- phase 16: data parallelism

# `gea`'s fifth milestone configuration, "Data-parallel G-LIS at 160x160":
# flagship_config(image_size=160, spatial_code=4) (benchmarks/grad_accum_probe.py:46-52),
# G-LIS-3, nf 64 / cap 512, bf16, BCE, global batch 64.
DP_ARGS = [*TRAINER_ARGS[:TRAINER_ARGS.index("--image_size")], "--image_size", "160",
           *TRAINER_ARGS[TRAINER_ARGS.index("--image_size") + 2:], "--spatial_code", "4"]
DP_STEPS, DP_K, DP_REPLAYS = 10, 8, 2
DP_SERVE_BATCHES, DP_HTTP_REQUESTS = (1, 3, 64), 16


def dp_world() -> DataParallel:
    """One process group of world size 1 on NCCL, through a localhost TCP
    store: the script runs on one card."""
    dev = join(torch.device("cuda"), Launch(0, 1, 0, f"tcp://127.0.0.1:{free_port()}"))
    return DataParallel(dev)


@contextlib.contextmanager
def launcher_world():
    """torchrun's environment for a group of world size 1, as --multihost
    reads it (the group started by `dp_world` is joined, not started)."""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    kept = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    try:
        yield
    finally:
        for k, v in kept.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_config(**kw) -> TrainGLISConfig:
    return TrainGLISConfig.from_args(DP_ARGS).replace(**kw)


def dp_params(cfg) -> tuple:
    return init_generator_params(cfg, 0), init_discriminator_params(cfg, 1)


def state_tensors(state) -> dict:
    """Every trained parameter and its Adam state, by name."""
    out = {}
    for name, tag in state.PLAYERS:
        opt = getattr(state, f"opt_{tag}")
        for n, p in getattr(state, name).named_parameters():
            out[f"{name}.{n}"] = p.detach()
            out.update({f"{name}.{n}.{k}": v for k, v in opt.state[p].items()})
    return out


def bit_diffs(a, b, metrics_a: list, metrics_b: list) -> list:
    """The names of the tensors and metrics where two runs differ in a bit."""
    ta, tb = state_tensors(a), state_tensors(b)
    diffs = [n for n, t in tb.items() if not (ta[n].dtype == t.dtype and torch.equal(ta[n], t))]
    return diffs + [f"step {i + 1} {k}" for i, (x, y) in enumerate(zip(metrics_a, metrics_b))
                    for k in y if not torch.equal(x[k], y[k])]


def nccl_kernels(rows) -> dict:
    """Device ms and launches of the NCCL kernels in a profile's rows."""
    return {name: {"ms": ms, "launches": n} for name, ms, n in rows if "nccl" in name.lower()}


def profiled(fn, steps: int) -> tuple:
    """(device busy ms, host wall ms, profile rows) of `steps` calls of
    `fn` under torch.profiler, ending when the device has."""
    walls = []

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    busy, rows = device_profile(timed)
    return busy, walls[0], rows


def dp_bitwise(dp: DataParallel, kernel_rows: dict) -> dict:
    """16(a), deterministic algorithms: DP_STEPS eager steps of the DP step
    at world size 1 against DP_STEPS of the single-process step, from the
    same seeded params, with the states' own draws; parameters, Adam's
    state and metrics equal bit for bit. The DP run's launch counts are the
    kernels' `launches_dp`."""
    cfg = dp_config()
    params, real = dp_params(cfg), real_batch(cfg)

    def run(dp_):
        state, step = create_glis_state(cfg, *params), build_glis_train_step(cfg, dp=dp_)
        return state, [step(state, real) for _ in range(DP_STEPS)]

    per_step = glis_launches(cfg)[0]
    want = {k: DP_STEPS * v for k, v in per_step.items()}
    with deterministic():
        single, m_single = run(None)
        ops.reset_launch_counts()
        ranked, m_ranked = run(dp)
        counts = ops.launch_counts()
    diffs = bit_diffs(ranked, single, m_ranked, m_single)
    n = len(state_tensors(single))
    print(f"[dp] 16(a) config 5 bf16, deterministic: {DP_STEPS} DP steps (world 1, NCCL) vs "
          f"{DP_STEPS} single-process steps: {n} tensors and {4 * DP_STEPS} metrics, "
          f"differing {diffs[:8]} ({len(diffs)}); DP launches {counts} (want {want})",
          flush=True)
    if diffs or counts != want:
        raise AssertionError(f"the world-1 DP step is not the single-process step: {diffs[:8]}, "
                             f"launches {counts} != {want}")
    for name, c in counts.items():
        kernel_rows[name]["launches_dp"] = c
    del single, ranked
    torch.cuda.empty_cache()
    return {"tensors": n, "metrics": 4 * DP_STEPS, "bitwise": True, "launches": counts}


def dp_timing(dp: DataParallel, smi: str) -> dict:
    """16(a), PyTorch's default TF32 settings: the single-process step and
    the DP step in turns (single, DP, DP, single), each 2 warm-up steps,
    DP_STEPS timed steps (wall) and DP_STEPS under torch.profiler (busy,
    idle, the all-reduces' kernels)."""
    cfg = dp_config()
    params, real = dp_params(cfg), real_batch(cfg)
    out = {}
    for label, dp_ in (("single", None), ("dp", dp), ("dp again", dp), ("single again", None)):
        state, step = create_glis_state(cfg, *params), build_glis_train_step(cfg, dp=dp_)
        for _ in range(2):
            step(state, real)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_STEPS):
            step(state, real)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / DP_STEPS
        busy, pwall, rows = profiled(lambda: step(state, real), DP_STEPS)
        out[label] = {"step_wall_ms": wall * 1e3, "images_per_s": BATCH / wall,
                      "busy_ms_per_step": busy / DP_STEPS, "idle_share": 1 - busy / pwall,
                      "nccl_kernels": nccl_kernels(rows)}
        r = out[label]
        print(f"[dp] 16(a) {label}: {r['step_wall_ms']:.3f} ms a step (wall, {DP_STEPS} steps) "
              f"= {r['images_per_s']:.1f} images/s; device busy {r['busy_ms_per_step']:.3f} ms "
              f"a step, idle share {r['idle_share']:.3f}; NCCL kernels over {DP_STEPS} steps "
              f"{r['nccl_kernels']}; {smi}", flush=True)
        del state, step
        torch.cuda.empty_cache()
    return out


def dp_seed_shape(cfg) -> dict:
    """The seed kernel at config 5's shape (c0 = c1 = 512, s0 = 5) against
    its plain version, in fp32 and bf16, with its bound."""
    out = {}
    for name, label, _, per_step, make in cases(cfg):
        if name != "fused_seed" or per_step == 0:
            continue
        for dt in (torch.float32, torch.bfloat16):
            args, nbytes, nops = make(dt)
            err = compare(name, label, dt, KERNEL[name](*args), PLAIN[name](*args))
            k_ms, p_ms = time_ms(lambda: KERNEL[name](*args)), time_ms(lambda: PLAIN[name](*args))
            b_ms, b_by = bound(nbytes, nops, dt)
            out[f"{label} {str(dt)[6:]}"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                                              "bound_ms": b_ms, "bound_by": b_by}
            print(f"[dp] seed at config 5: {label} {str(dt)[6:]} max|err| {err:.3e} (atol, rtol "
                  f"{TOL[name][dt]})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
    return out


def nccl_nodes(text: str) -> int:
    """Kernel nodes of a graph dump that run an NCCL kernel."""
    return sum(1 for node in text.split("];") if "{KERNEL" in node and "nccl" in node.lower())


def dp_graphed(dp: DataParallel, smi: str, tmp: str) -> dict:
    """16(b): DP_REPLAYS replays of a K = DP_K graph of the DP step with its
    all-reduces captured, against DP_K * DP_REPLAYS eager DP steps; the
    port kernels' calls from the graph's own kernel nodes must equal DP_K
    eager steps' counters; the NCCL kernel nodes are counted beside them."""
    cfg = dp_config()
    params, real = dp_params(cfg), real_batch(cfg)
    per_step = glis_launches(cfg)[0]
    n = DP_K * DP_REPLAYS
    state, step = create_glis_state(cfg, *params), build_glis_train_step(cfg, dp=dp)
    for _ in range(2):
        step(state, real)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, real)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    busy, pwall, rows = profiled(lambda: step(state, real), n)
    out = {"eager": {"step_wall_ms": wall * 1e3, "images_per_s": BATCH / wall,
                     "busy_ms_per_step": busy / n, "idle_share": 1 - busy / pwall,
                     "nccl_kernels": nccl_kernels(rows)}}
    del state, step
    torch.cuda.empty_cache()

    kcfg = cfg.replace(steps_per_dispatch=DP_K)
    state, step = create_glis_state(kcfg, *params), build_glis_train_step(kcfg, dp=dp)
    dispatch = StepDispatcher(kcfg, step)
    reals = [real] * DP_K
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with graphs_kept():
        dispatch(state, reals)  # warm-up, capture, first replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    chunk = dispatch.chunks[DP_K]
    text = graph_text(chunk.graph, tmp)
    nodes, kernel_nodes, nccl = calls_from(text.count), text.count("{KERNEL"), nccl_nodes(text)
    per_replay = {k: DP_K * v for k, v in per_step.items()}
    if nodes != per_replay or chunk.launches != per_replay:
        raise AssertionError(f"dp graph: kernel nodes {nodes}, dispatcher {chunk.launches}, "
                             f"not {DP_K} steps' {per_replay}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = [dispatch(state, reals) for _ in range(DP_REPLAYS)]
    torch.cuda.synchronize()
    gwall = (time.perf_counter() - t0) / n
    gbusy, gpwall, grows = profiled(lambda: dispatch(state, reals), DP_REPLAYS)
    values = {k: v.tolist() for k, v in history[-1].items()}
    if not all(np.isfinite(x) for vs in values.values() for x in vs):
        raise AssertionError(f"dp graph: non-finite metrics {values}")
    out["graphed"] = {"step_wall_ms": gwall * 1e3, "images_per_s": BATCH / gwall,
                      "busy_ms_per_step": gbusy / n, "idle_share": 1 - gbusy / gpwall,
                      "warm_up_s": dispatch.warm_up_s, "capture_s": chunk.capture_s,
                      "first_call_s": first_s, "pool_peak_mb": chunk.pool_peak_mb,
                      "launches_per_replay": nodes, "kernel_nodes_per_replay": kernel_nodes,
                      "nccl_kernel_nodes_per_replay": nccl,
                      "nccl_kernels_traced": nccl_kernels(grows), "metrics_last_chunk": values}
    e, g = out["eager"], out["graphed"]
    print(f"[dp] 16(b) eager DP: {e['step_wall_ms']:.3f} ms a step (wall, {n} steps) = "
          f"{e['images_per_s']:.1f} images/s, busy {e['busy_ms_per_step']:.3f} ms, idle "
          f"{e['idle_share']:.3f}; graphed K={DP_K}: {g['step_wall_ms']:.3f} ms a step = "
          f"{g['images_per_s']:.1f} images/s, busy {g['busy_ms_per_step']:.3f} ms, idle "
          f"{g['idle_share']:.3f}; warm-up {g['warm_up_s']:.2f} s, capture "
          f"{g['capture_s']:.2f} s, pool {g['pool_peak_mb']:.1f} MB; a replay's kernel nodes: "
          f"port kernels {nodes} = {DP_K} eager steps' {per_replay}, NCCL {nccl}, all "
          f"{kernel_nodes}; {smi}", flush=True)
    del state, step, dispatch, chunk
    torch.cuda.empty_cache()
    return out


def dp_fp32(dp: DataParallel) -> dict:
    """16(b), fp32 without TF32: the graphed K = 2 chunk of the DP step
    against 2 eager DP steps (phase 14(b)'s `chunk_agreement` and gates)."""
    cfg = dp_config(dtype="float32")
    params = dp_params(cfg)
    return chunk_agreement("g-lis dp", cfg, lambda c: create_glis_state(c, *params),
                           lambda c: build_glis_train_step(c, dp=dp), real_batch(cfg), None)


def dp_clis(tmp: str, smi: str) -> dict:
    """16(c): the CLIs at DP_ARGS for TRAINER_STEPS steps each with exact
    launches: train_glis --num_devices 1; train_glis --multihost under a
    launcher's environment of world size 1, with a bitwise checkpoint round
    trip and a relaunch resuming at TRAINER_STEPS; train_r_separate against
    that run and train_r_iterative (at phase 10's flagship shape), both
    --multihost."""
    out = {}
    cfg = dp_config()
    per_step, per_render = glis_launches(cfg)
    renders = TRAINER_STEPS // TRAINER_VIS
    common = ["--vis_interval", str(TRAINER_VIS), "--save_interval", str(TRAINER_VIS)]
    want = launches(per_step, TRAINER_STEPS, per_render, renders)
    single = os.path.join(tmp, "dp_single")
    _, stats, _, counts = counted_run(
        "dp", "train_glis --num_devices 1", train_glis,
        DP_ARGS + common + ["--save_path", single, "--niter", str(TRAINER_STEPS),
                            "--num_devices", "1"], want)
    out["glis_num_devices_1"] = cli_summary(stats, counts)
    run = os.path.join(tmp, "dp_multihost")
    args = DP_ARGS + common + ["--save_path", run, "--multihost"]
    with launcher_world():
        state, stats, text, counts = counted_run(
            "dp", "train_glis --multihost", train_glis, args + ["--niter", str(TRAINER_STEPS)],
            want)
        if "multihost: process 0/1" not in text:
            raise AssertionError("train_glis --multihost did not join the group")
        out["glis_multihost"] = cli_summary(stats, counts)
        out["glis_round_trip"] = round_trip(run, TRAINER_STEPS, state, create_glis_state(cfg))
        del state
        out["glis_relaunch"] = relaunch("dp", train_glis, args, run, per_step, per_render)

        rsep = os.path.join(tmp, "dp_rsep")
        rargs = ["--g_path", run, "--batch_size", str(BATCH), "--log_interval", "10",
                 "--save_path", rsep, *common, "--multihost"]
        r_step, r_render = r_separate_launches(r_separate_config(run, rargs))
        _, stats, _, counts = counted_run(
            "dp", "train_r_separate --multihost", train_r_separate,
            rargs + ["--niter", str(TRAINER_STEPS)],
            launches(r_step, TRAINER_STEPS, r_render, renders))
        out["r_separate_multihost"] = cli_summary(stats, counts)
        riter = os.path.join(tmp, "dp_riter")
        iargs = TRAINER_ARGS + ["--r_chain_length", "2", "--lambda_r", "0.9", "--save_path",
                                riter, *common, "--multihost"]
        i_step, i_render = r_iterative_launches(TrainRIterativeConfig.from_args(iargs))
        _, stats, _, counts = counted_run(
            "dp", "train_r_iterative --multihost", train_r_iterative,
            iargs + ["--niter", str(TRAINER_STEPS)],
            launches(i_step, TRAINER_STEPS, i_render, renders))
        out["r_iterative_multihost"] = cli_summary(stats, counts)
    for label, r in out.items():
        if "images_per_sec" in r:
            print(f"[dp] 16(c) {label}: {r['images_per_sec']:.1f} images/s (meter), metrics "
                  f"{r['metrics']}; {smi}", flush=True)
    return out


def dp_serving(smi: str) -> dict:
    """16(d): `ServingModel.sharded()` over the visible cards renders what
    the single-card ServingModel renders, bit for bit, in bf16 at batches
    DP_SERVE_BATCHES; `serve_http --data_parallel` answers
    DP_HTTP_REQUESTS requests."""
    import threading

    cfg = dp_config()
    g = generator_from_jax_params(init_generator_params(cfg, 0), cfg)
    d = discriminator_from_jax_params(init_discriminator_params(cfg, 1), cfg)
    model = ServingModel.from_modules(g, d)
    sharded = model.sharded()
    rng = np.random.default_rng(7)
    out = {"replicas": [str(dev) for dev in sharded.devices]}
    for n in DP_SERVE_BATCHES:
        z = rng.standard_normal((n, cfg.code_size)).astype(np.float32)
        sn = rng.standard_normal((n, *model.spatial_noise_shape)).astype(np.float32)
        want, got = model(z, sn), sharded(z, sn)
        diff = [k for k in want if not np.array_equal(want[k], got[k])]
        if diff or got["images"].shape[0] != n:
            raise AssertionError(f"sharded render at batch {n} differs in {diff}")
    # The server renders the final stage alone: a 160x160 stage costs the
    # handler a PNG encode an image.
    final = ServingModel.from_modules(g, d, all_stages=False)
    server, batcher = serve_http.make_server("", "127.0.0.1", 0, model=final, data_parallel=True)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    latencies = []
    try:
        for i in range(DP_HTTP_REQUESTS):
            status, body, latency = http_post(base + "/render", {"count": 4, "seed": i})
            if status != 200 or len(body["images"]) != 4 or len(body["scores"]) != 4:
                raise AssertionError(f"serve_http --data_parallel: request {i} got {status}")
            latencies.append(latency * 1e3)
    finally:
        server.shutdown()
        batcher.close()
        thread.join(timeout=30)
    out.update(bitwise_batches=list(DP_SERVE_BATCHES), http_requests=DP_HTTP_REQUESTS,
               http_p50_ms=float(np.percentile(latencies, 50)))
    print(f"[dp] 16(d) ServingModel.sharded() over {out['replicas']}: bf16 renders at batches "
          f"{list(DP_SERVE_BATCHES)} equal the single card's bit for bit; serve_http "
          f"--data_parallel answered {DP_HTTP_REQUESTS} requests (p50 "
          f"{out['http_p50_ms']:.2f} ms); {smi}", flush=True)
    return out


def dp_phase(tmp: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 16: data parallelism at config 5's shape, on a process group
    of world size 1 over NCCL."""
    t0 = time.perf_counter()
    dp = dp_world()
    out = {"config": "G-LIS-3 160x160 spatial_code 4, nf 64 / cap 512, bf16, BCE, batch 64",
           "world_size": dp.size, "backend": torch.distributed.get_backend()}
    seconds = out["part_seconds"] = {}

    def part(name, fn, tf32=False):
        t = time.perf_counter()
        with cudnn_tf32() if tf32 else contextlib.nullcontext():
            out[name] = fn()
        seconds[name] = time.perf_counter() - t

    try:
        part("bitwise", lambda: dp_bitwise(dp, kernel_rows))
        part("seed_shape", lambda: dp_seed_shape(dp_config()))
        part("timing", lambda: dp_timing(dp, smi), tf32=True)
        part("graphed", lambda: dp_graphed(dp, smi, tmp), tf32=True)
        part("fp32", lambda: dp_fp32(dp))
        part("clis", lambda: dp_clis(tmp, smi), tf32=True)
        part("serving", lambda: dp_serving(smi))
    finally:
        torch.distributed.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    out["card"] = smi
    parts = ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
    print(f"[dp] phase 16 in {out['seconds']:.1f} s ({parts})", flush=True)
    return out


# ------------------------------------------------ phase 17: --norm batch

# Running statistics of two runs of the same steps, absolute: a conv bias
# that feeds a batch norm has a gradient zero up to rounding, so Adam's
# first update may move it by lr one way on one side and the other way on
# the other (2 lr = 4e-4 at the default lr), which moves the next running
# mean by 0.1 * 4e-4; an update applied twice moves it by 0.1 of the
# batch statistic itself, 1e-2 or more.
STATS_TOL = 1e-3
# Batch norm's fp32 steps, kernels vs plain versions, are compared under
# deterministic algorithms (plain vs plain is then bit for bit). Without
# weight norm the LIS links' fc1 weights hold many elements whose step-1
# gradient lies within the kernels' fp32 rounding (about 1e-2 of the
# tensor's largest), and Adam's first update, about lr * sign(g), flips
# them: 3.1-3.5% of fc1's elements were more than lr / 5 apart on an H100
# 80GB HBM3 at 700 W; a wrong backward flips about half.
BN_FP32_TOL = {**FP32_TOL, "params_apart_share": 0.1}
BN_STEPS, BN_VIS, BN_R_STEPS = 40, 20, 20
BN_FID_SAMPLES = 256
LOADER_BATCHES = 10


def with_norm(args: list, norm: str) -> list:
    i = args.index("--norm")
    return args[:i + 1] + [norm] + args[i + 2:]


BN_ARGS = with_norm(TRAINER_ARGS, "batch")


def running_stats(state) -> dict:
    """Batch norm's running means and variances of a state's trained
    players, by module and name ({} without batch norm)."""
    return {f"{name}.{n}": t for name, _ in state.PLAYERS
            for n, t in getattr(state, name).named_buffers() if n.endswith((".mean", ".var"))}


def bn_fed(state) -> set:
    """The conv biases whose output a batch norm takes: in train mode the
    norm subtracts each channel's batch mean, so their gradient is zero up
    to rounding and Adam's first update moves them by lr either way."""
    out = set()
    for name, _ in state.PLAYERS:
        keys = getattr(state, name).state_dict().keys()
        out |= {f"{name}.{k}" for k in keys if k.endswith(".conv.bias")
                and k.replace(".conv.bias", ".act.mean") in keys}
    return out


def named_unfed(state) -> dict:
    """`named_params` but the biases that feed a batch norm (`bn_fed`)."""
    fed = bn_fed(state)
    return {n: p for n, p in named_params(state).items() if n not in fed}


def bn_launches(cfg) -> tuple:
    """(launches of a batch-norm G-LIS step, of a render of every stage).
    No seed kernel: `gea` turns the fused seed off under batch norm. A G
    forward runs a LIS link per module and a TPReLU (LeakyReLU 0.2) after
    each of its d batch norms; the step runs G twice (the first forward's
    statistics are dropped) and D's trunk (d - 1 TPReLUs) three times: on
    the reals, on the fakes and for G's loss. The second G forward and the
    three D forwards are differentiated: d + 3 (d - 1) TPReLU backwards, each
    without da and db (the LeakyReLU's slope and offset are fixed), and a
    LIS backward a link, without dslope and dtrans."""
    d = generator_plan(cfg.image_size)[1]
    render = {"fused_tprelu": d, "fused_tprelu_backward": 0,
              "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0,
              "fused_seed": 0, "fused_seed_backward": 0}
    return ({"fused_tprelu": 2 * d + 3 * (d - 1), "fused_tprelu_backward": d + 3 * (d - 1),
             "lis_residual_mlp": 2 * cfg.r_iterations,
             "lis_residual_mlp_backward": cfg.r_iterations, "fused_seed": 0,
             "fused_seed_backward": 0}, render)


def bn_state(cfg, **kw):
    return create_glis_state(cfg, init_generator_params(cfg, 0),
                             init_discriminator_params(cfg, 1), **kw)


def bn_warm_up_restores(cfg) -> dict:
    """The K = 8 dispatcher's warm-up step leaves G and D as they were, bit
    for bit: parameters and running statistics (Adam's state, which the
    warm-up makes, starts at zeros as a fresh Adam's)."""
    state, step = bn_state(cfg), build_glis_train_step(cfg)
    dispatch = StepDispatcher(cfg, step)
    real = real_batch(cfg)
    dispatch._fill(state, [real] * GRAPH_K, [step.noise(state) for _ in range(GRAPH_K)])
    dispatch._fill_lr(state, GRAPH_K)

    def models():
        return {name: getattr(state, name).state_dict() for name, _ in state.PLAYERS}

    want = {k: {n: t.clone() for n, t in sd.items()} for k, sd in models().items()}
    dispatch._warm_up(state)
    diff = same(models(), want)
    print(f"[batch] 17(a) the K={GRAPH_K} warm-up step put back every tensor it changed "
          f"({len(running_stats(state))} running statistics among them): "
          f"{'bit for bit' if not diff else diff[:8]}", flush=True)
    if diff:
        raise AssertionError(f"the warm-up changed {diff[:8]}")
    return {"bitwise": True, "running_stats": len(running_stats(state))}


def bn_fp32_agreement(cfg) -> dict:
    """2 fp32 batch-norm steps with kernels against 2 with plain versions
    under deterministic algorithms (`fp32_agreement_of` with BN_FP32_TOL,
    the biases that feed a batch norm left out of its gradient and
    parameter gates), and the running statistics within STATS_TOL, beside
    a second plain run, which must then agree bit for bit."""
    tcfg = cfg.replace(dtype="float32")
    g_params, d_params = init_generator_params(tcfg, 0), init_discriminator_params(tcfg, 1)
    real = real_batch(tcfg)
    rng = np.random.default_rng(3)
    zs = [torch.from_numpy(rng.standard_normal((BATCH, tcfg.code_size)).astype(np.float32)).cuda()
          for _ in range(2)]
    stats = []

    def two_steps(use_kernels):
        state = create_glis_state(tcfg, g_params, d_params, use_kernels=use_kernels)
        out = two_fp32_steps(lambda: state, build_glis_train_step(tcfg), named_unfed,
                             [(real, z) for z in zs])
        stats.append({n: t.clone() for n, t in running_stats(state).items()})
        return out

    with deterministic():
        out = fp32_agreement_of("batch", two_steps, tcfg.lr, BN_FP32_TOL)
    kernels, plain, again = stats

    def apart(a, b):
        return max((a[n] - b[n]).abs().max().item() for n in b)

    out["stats_max_abs"], out["stats_plain_vs_plain"] = apart(kernels, plain), apart(again, plain)
    out["stats_moved"] = apart(plain, {n: torch.zeros_like(t) if n.endswith(".mean")
                                       else torch.ones_like(t) for n, t in plain.items()})
    print(f"[batch fp32] running statistics after 2 steps, kernels vs plain: max abs "
          f"{out['stats_max_abs']:.3e} (tol {STATS_TOL}), plain vs plain "
          f"{out['stats_plain_vs_plain']:.3e}; moved off their initial values by up to "
          f"{out['stats_moved']:.3e}", flush=True)
    if (out["stats_max_abs"] > STATS_TOL or not out["stats_moved"] > 10 * STATS_TOL
            or out["stats_plain_vs_plain"] != 0 or out["plain_vs_plain"]["params_abs"] != 0):
        raise AssertionError(f"batch-norm running statistics: {out}")
    return out


def bn_step(kernel_rows: dict, smi: str, tmp: str) -> dict:
    """Phase 17(a): the batch-norm G-LIS step at flagship width, bf16,
    batch 64, BCE."""
    cfg = TrainGLISConfig.from_args(BN_ARGS)
    per_step, _ = bn_launches(cfg)
    out = {"fp32": bn_fp32_agreement(cfg)}
    state, step = bn_state(cfg), build_glis_train_step(cfg)
    real = real_batch(cfg)
    fed = bn_fed(state)

    ops.reset_launch_counts()
    step(state, real)
    counts = ops.launch_counts()
    print(f"[batch] step 1 launches {counts} (want {per_step})", flush=True)
    if counts != per_step:
        raise AssertionError(f"launches per batch-norm step {counts} != {per_step}")
    grads = {n: p.grad for n, p in named_params(state).items()}
    bad = [n for n, g in grads.items() if g is None or not torch.isfinite(g).all()
           or (n not in fed and not g.abs().max() > 0)]
    if bad:
        raise AssertionError(f"batch-norm step 1: no finite non-zero gradient for {bad}")
    fed_max = max(grads[n].abs().max().item() for n in fed)
    other_max = max(g.abs().max().item() for n, g in grads.items() if n not in fed)
    print(f"[batch] step 1: every parameter has a finite gradient, non-zero but for the "
          f"{len(fed)} conv biases that feed a batch norm (largest {fed_max:.3e}, against "
          f"{other_max:.3e} elsewhere)", flush=True)
    step(state, real)

    stats0 = {n: t.clone() for n, t in running_stats(state).items()}
    ops.reset_launch_counts()
    walls, history = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, real)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        history.append({k: v.item() for k, v in metrics.items()})
    counts = ops.launch_counts()
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    print(f"[batch] launch counts over {TRAIN_STEPS} timed steps: {counts} (want {want})",
          flush=True)
    if counts != want:
        raise AssertionError(f"batch-norm launch counts {counts} != {want}")
    for name, n in counts.items():
        kernel_rows[name]["launches_batch"] = n
        kernel_rows[name]["launches_per_batch_step"] = per_step[name]
    stats = running_stats(state)
    unmoved = [n for n, t in stats.items() if torch.equal(t, stats0[n])]
    if (unmoved or not all(np.isfinite(v) for m in history for v in m.values())
            or not all(bool(torch.isfinite(t).all()) for t in stats.values())
            or not all(bool((t > 0).all()) for n, t in stats.items() if n.endswith(".var"))):
        raise AssertionError(f"batch-norm steps: metrics {history[-1]}, statistics that did "
                             f"not move {unmoved}")
    wall = statistics.median(walls)
    profiled = step_profile(lambda: step(state, real))
    out["eager"] = {"step_wall_ms_median": wall * 1e3, "step_wall_ms": [w * 1e3 for w in walls],
                    "images_per_s": BATCH / wall, "step_device_busy_ms": profiled["device_ms"],
                    "step_device_idle_share": 1.0 - profiled["device_ms"] / (wall * 1e3),
                    "step_by_category": profiled["by_category"],
                    "launches": counts, "metrics_last": history[-1], "card": smi}
    e = out["eager"]
    print(f"[batch] flagship bf16 batch-norm step, batch {BATCH}: median wall "
          f"{e['step_wall_ms_median']:.3f} ms of {TRAIN_STEPS} = {e['images_per_s']:.1f} "
          f"images/s; device busy {e['step_device_busy_ms']:.3f} ms (torch.profiler), idle "
          f"share {e['step_device_idle_share']:.3f}; {smi}", flush=True)
    for cat, t in sorted(profiled["by_category"].items(), key=lambda kv: -kv[1]):
        print(f"[batch] step by category: {t:8.4f} ms {cat}", flush=True)
    del state, step
    torch.cuda.empty_cache()

    out["warm_up"] = bn_warm_up_restores(cfg.replace(steps_per_dispatch=GRAPH_K))
    entry = (cfg.replace(steps_per_dispatch=GRAPH_K), bn_state, build_glis_train_step,
             per_step, real)
    with cudnn_tf32():
        out["graphed"] = eager_vs_graphed("g-lis batch norm", entry, smi, tmp)
    fp32 = TrainGLISConfig(**{**dataclasses.asdict(cfg), "dtype": "float32"})
    out["graphed_fp32"] = chunk_agreement("g-lis batch norm", fp32, bn_state,
                                          build_glis_train_step, real_batch(fp32), None,
                                          named=named_unfed)
    return out


def bn_clis(tmp: str, folder: str, smi: str) -> dict:
    """Phase 17(b): the three trainer CLIs with --norm batch: train_glis on
    phase 12's demo JPEGs with --data_backend auto, streamed and with
    --data_cache (exact launches: the steps' and 2 renders'), R-separate
    against the streamed run, R-iterative at 80x80 --r_chain_length 2."""
    cfg = TrainGLISConfig.from_args(BN_ARGS)
    per_step, per_render = bn_launches(cfg)
    want = launches(per_step, BN_STEPS, per_render, BN_STEPS // BN_VIS)
    out = {}
    folder_args = ["--dataset", "folder", "--dataroot", folder, "--synthetic_on_device", "false",
                   "--data_backend", "auto", "--niter", str(BN_STEPS), "--vis_interval",
                   str(BN_VIS), "--save_interval", str(BN_STEPS)]
    for label, extra in (("streamed", []), ("data_cache", ["--data_cache", "true"])):
        run = os.path.join(tmp, f"bn_{label}")
        with cudnn_tf32():
            state, stats, text, counts = counted_run(
                "batch", f"train_glis --norm batch on the demo JPEGs ({label}), {BN_STEPS} steps "
                f"and 2 renders", train_glis, BN_ARGS + folder_args + extra + ["--save_path", run],
                want)
        chose = [ln for ln in text.splitlines() if "decoded by" in ln]
        out[label] = {"run": run, "images_per_sec": stats["images_per_sec"],
                      "metrics": stats["metrics"], "launches": counts,
                      "decoded_by": chose[0].split("decoded by ")[1].split(" ")[0]
                      if chose else None}
        if (not chose or not all(np.isfinite(v) for v in stats["metrics"].values())
                or not os.path.isfile(os.path.join(run, "checkpoints", str(BN_STEPS), "state.pt"))):
            raise AssertionError(f"batch-norm CLI ({label}): {out[label]}")
        print(f"[batch] train_glis --norm batch --data_backend auto ({label}): "
              f"{stats['images_per_sec']:.1f} img/s (meter); auto chose "
              f"{out[label]['decoded_by']}; {smi}", flush=True)
        if label == "streamed":
            out["state"] = state
    r_args = ["--batch_size", str(BATCH), "--niter", str(BN_R_STEPS), "--log_interval", "10",
              "--vis_interval", str(BN_R_STEPS), "--save_interval", str(BN_R_STEPS)]
    with cudnn_tf32():
        _, sep, _ = run_cli(r_args + ["--g_path", out["streamed"]["run"], "--save_path",
                                      os.path.join(tmp, "bn_rsep")], train_r_separate)
        _, it, _ = run_cli(BN_ARGS + r_args + ["--r_chain_length", "2", "--save_path",
                                               os.path.join(tmp, "bn_riter")], train_r_iterative)
    for label, stats in (("r_separate", sep), ("r_iterative", it)):
        out[label] = {"images_per_sec": stats["images_per_sec"], "metrics": stats["metrics"]}
        if not all(np.isfinite(v) for v in stats["metrics"].values()):
            raise AssertionError(f"batch-norm {label}: {stats['metrics']}")
        print(f"[batch] {label} --norm batch, {BN_R_STEPS} steps: "
              f"{stats['images_per_sec']:.1f} img/s (meter), metrics {stats['metrics']}; {smi}",
              flush=True)
    return out


def loader_rate(dataset, batches: int) -> float:
    it = dataset.batches(0)
    next(it)  # the pool's start and first batch off the clock
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return batches * dataset.batch_size / (time.perf_counter() - t0)


def bn_loader(folder: str, smi: str) -> dict:
    """Phase 17(c): the native loader on the card's host: whether g++ and
    libjpeg built it and in how many seconds, images/s of PIL threads and,
    where it built, of the native pool on the demo JPEGs at the flagship
    crop, and the stream `auto` chose against an explicit `native` one,
    byte for byte."""
    import ctypes.util

    lib = native_build.load_library()
    out = {"built": lib is not None, "build_seconds": native_build.build_seconds,
           "library": str(native_build.library_path()), "g++": shutil.which("g++"),
           "jpeglib.h": os.path.exists("/usr/include/jpeglib.h"),
           "libjpeg": ctypes.util.find_library("jpeg")}
    cfg = TrainGLISConfig.from_args(BN_ARGS + ["--dataset", "folder", "--dataroot", folder])
    decode = max(cfg.crop_size, cfg.image_size)
    pil = FolderDataset(folder, BATCH, cfg.crop_size, decode, workers=cfg.data_workers)
    out["pil_images_per_s"] = loader_rate(pil, LOADER_BATCHES)
    where = (f"crop {cfg.crop_size} -> {decode}, {cfg.data_workers} workers, batch {BATCH}, "
             f"{LOADER_BATCHES} batches")
    if lib is None:
        print(f"[batch] 17(c) the native loader did NOT build on this host (g++ at "
              f"{out['g++']}, /usr/include/jpeglib.h present: {out['jpeglib.h']}, libjpeg "
              f"found: {out['libjpeg']}): --data_backend auto decoded with PIL above, as "
              f"gea's auto does; PIL threads {out['pil_images_per_s']:.1f} images/s at "
              f"{where}; {smi}", flush=True)
        return out
    native = NativeFolderLoader(list_images(folder), BATCH, cfg.crop_size, decode,
                                workers=cfg.data_workers)
    out["native_images_per_s"] = loader_rate(native, LOADER_BATCHES)
    native.close()
    auto = make_dataset(cfg.replace(data_backend="auto"), seed=cfg.seed)
    explicit = make_dataset(cfg.replace(data_backend="native"), seed=cfg.seed)
    a, b = auto.batches(0), explicit.batches(0)
    out["auto_equals_native"] = all(np.array_equal(next(a), next(b)) for _ in range(3))
    auto.close()
    explicit.close()
    print(f"[batch] 17(c) native loader built by g++/libjpeg "
          f"({'in %.2f s' % out['build_seconds'] if out['build_seconds'] else 'earlier'}): "
          f"{out['native_images_per_s']:.1f} images/s against PIL's "
          f"{out['pil_images_per_s']:.1f} at {where}; auto's stream equals an explicit "
          f"native one for 3 batches: {out['auto_equals_native']}; {smi}", flush=True)
    if not out["auto_equals_native"]:
        raise AssertionError("--data_backend auto and native streams differ")
    return out


def bn_inference(tmp: str, run: str, state, smi: str) -> dict:
    """Phase 17(d): `sample` from the streamed run (exact launches), its
    export rendering what the live eval-mode G renders, bit for bit, with
    the same launches, and one evaluation leaving the running statistics
    as they were, bit for bit."""
    cfg = TrainGLISConfig.load(os.path.join(run, "config.json"))
    _, per_render = bn_launches(cfg)
    out = {}
    ops.reset_launch_counts()
    sample.main(["--load_path", run, "--count", str(BATCH), "--batch_size", str(BATCH),
                 "--save_path_samples", os.path.join(tmp, "bn_samples")])
    out["sample_launches"] = ops.launch_counts()
    if out["sample_launches"] != per_render:
        raise AssertionError(f"sample launches {out['sample_launches']} != {per_render}")
    art = os.path.join(tmp, "bn_art")
    export_model.main(["--load_path", run, "--out", art, "--all_stages", "1",
                       "--with_scores", "1"])
    g, _ = load_generator(run)
    live = ServingModel.from_modules(g, load_discriminator(run), all_stages=True)
    d = generator_plan(cfg.image_size)[1]
    scored = {**per_render, "fused_tprelu": per_render["fused_tprelu"] + d - 1}
    model = serve.load(art)
    z = np.random.default_rng(0).standard_normal((BATCH, cfg.code_size)).astype(np.float32)
    counts = []
    for fn in (model, live):
        ops.reset_launch_counts()
        counts.append((fn(z), ops.launch_counts()))
    (got, got_n), (want, want_n) = counts
    out["artifact_equals_live"] = all(np.array_equal(got[k], want[k]) for k in want)
    out["artifact_launches"], out["live_launches"] = got_n, want_n
    if not out["artifact_equals_live"] or got_n != want_n or want_n != scored:
        raise AssertionError(f"batch-norm artifact vs live: {out}")
    before = {k: v.clone() for k, v in running_stats(state).items()}
    modes = [m.training for mod in state_modules(state) for m in mod.modules()]
    fid_fn = train_glis.make_fid_fn(cfg.replace(fid_samples=BN_FID_SAMPLES), state.device)
    t0 = time.perf_counter()
    with eval_mode(*state_modules(state)):
        out["fid"] = float(fid_fn(state))
    out["eval_s"] = time.perf_counter() - t0
    after = running_stats(state)
    out["eval_left_stats"] = all(torch.equal(after[n], t) for n, t in before.items())
    out["modes_restored"] = modes == [m.training for mod in state_modules(state)
                                      for m in mod.modules()]
    print(f"[batch] 17(d) sample: launches {out['sample_launches']} (want {per_render}); the "
          f"exported artifact renders and scores {BATCH} codes as the live eval-mode G and D "
          f"do, bit for bit: "
          f"{out['artifact_equals_live']}, launches {got_n} = {want_n}; one evaluation "
          f"({BN_FID_SAMPLES} samples, proxy-FID {out['fid']:.3f}, {out['eval_s']:.2f} s) left "
          f"the {len(before)} running statistics bit for bit: {out['eval_left_stats']}, modes "
          f"put back: {out['modes_restored']}; {smi}", flush=True)
    if not (out["eval_left_stats"] and out["modes_restored"] and np.isfinite(out["fid"])):
        raise AssertionError(f"batch-norm evaluation: {out}")
    return out


def batch_norm_phase(tmp: str, folder: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 17: --norm batch through the step, the CLIs, the native
    loader and inference."""
    t0 = time.perf_counter()
    seconds = {}
    out = {"config": "G-LIS-3 80x80 --norm batch, nf 64 / cap 512, bf16, BCE, batch 64"}

    def part(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t

    part("step", lambda: bn_step(kernel_rows, smi, tmp))
    part("clis", lambda: bn_clis(tmp, folder, smi))
    part("loader", lambda: bn_loader(folder, smi))
    state = out["clis"].pop("state")
    part("inference", lambda: bn_inference(tmp, out["clis"]["streamed"]["run"], state, smi))
    out["seconds"], out["part_seconds"], out["card"] = time.perf_counter() - t0, seconds, smi
    parts = ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
    print(f"[batch] phase 17 in {out['seconds']:.1f} s ({parts})", flush=True)
    return out


# ------------------------------- phase 18: tensor parallelism, LSUN, grain

TP_SHARDS, TP_TIMED, TP_TIMEOUT_S = 2, 5, 300
TP_STEPS = 10  # the LSUN and grain CLI runs
TP_CONFIG = ("G-LIS-3 80x80, code 256, weight norm, nf 64 / cap 512, bf16, BCE, batch 64, "
             "--g_ema 0.999, --model_shards 2, tp_min_width 64")
GRAIN_IMAGES = 320  # 5 batches of 64: one epoch of either stream


def tp_config(**kw) -> TrainGLISConfig:
    return TrainGLISConfig.from_args(TRAINER_ARGS).replace(
        g_ema=0.999, model_shards=TP_SHARDS, **kw)


def gloo_carries_cuda() -> bool:
    """Whether this torch's gloo all-reduces and all-gathers CUDA tensors
    (every rank tries; both must agree)."""
    try:
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        out = torch.empty(TP_SHARDS, 4, device="cuda")
        dist.all_gather(list(out.unbind(0)), t)
        return bool((out == TP_SHARDS).all())
    except RuntimeError as e:
        print(f"[tp] gloo refuses CUDA tensors here ({e}); the phase stages them through "
              "host copies", flush=True)
        return False


class HostStaged(Collectives):
    """TP's collectives with each CUDA tensor copied to the host and back
    around the gloo call: what the phase hands a TensorParallel where gloo
    refuses CUDA tensors."""

    def all_reduce(self, t: torch.Tensor) -> None:
        h = t.cpu()
        super().all_reduce(h)
        t.copy_(h)

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> None:
        h = torch.empty(out.shape, dtype=out.dtype)
        super().all_gather(h, t.cpu())
        out.copy_(h)


# Where the models call each kernel's wrapper (module, name, kernel): the
# names a recording swaps for a spy that keeps the inputs and calls the
# wrapper. TPReLU's backward is called by its Function, through `_backward`.
KERNEL_SITES = (("gea_torch.models.generator", "lis_residual_mlp", "lis_residual_mlp"),
                ("gea_torch.models.generator", "fused_seed", "fused_seed"),
                ("gea_torch.ops.layers", "fused_tprelu", "fused_tprelu"),
                ("gea_torch.ops.tprelu", "_backward", "fused_tprelu_backward"),
                ("gea_torch.ops.seed", "_backward", "fused_seed_backward"),
                ("gea_torch.ops.lis", "_backward", "lis_residual_mlp_backward"))


@contextlib.contextmanager
def recorded_inputs(store: dict):
    """Within: the first call's inputs at each (kernel, shape, dtype) the
    models give a kernel, detached copies, into `store`; the calls still
    launch the kernels."""
    saved = []
    for module, name, kernel in KERNEL_SITES:
        mod = importlib.import_module(module)
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=kernel):
            key = (_name, tuple(args[0].shape), args[0].dtype)
            if key not in store:
                store[key] = tuple(a.detach().clone() if torch.is_tensor(a) else a
                                   for a in args)
            return _fn(*args)

        saved.append((mod, name, fn))
        setattr(mod, name, spy)
    try:
        yield store
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_recorded(store: dict, rows: int, tag: str) -> dict:
    """Each recorded kernel input against the kernel's plain version, the
    forwards at check_kernels' TOL (max |err|), TPReLU's backward by
    `compare_backward` (dx bit for bit; the da/db error relative to their
    max), the seed's and LIS's by `compare_seed_backward` and
    `compare_lis_backward` (the error relative to each gradient's max);
    every kernel must have been recorded, LIS and the seed (and their
    backwards) at this rank's `rows` (the seed on the S stages' stacked
    rows)."""
    got = {name for name, _, _ in store}
    if got != {*KERNEL, "fused_tprelu_backward", "fused_seed_backward",
               "lis_residual_mlp_backward"}:
        raise AssertionError(f"{tag}: recorded {sorted(got)}, not every kernel of the step")
    out = {}
    with torch.no_grad():
        for (name, shape, dt), args in sorted(store.items(), key=str):
            if not name.startswith("fused_tprelu") and shape[0] % rows:
                raise AssertionError(f"{tag}: {name} at {shape}, not this rank's {rows} rows")
            label = f"{tag} {name} {shape}"
            if name == "fused_tprelu_backward":
                out[f"{name} {shape} {str(dt)[6:]} (dx bitwise; da/db rel)"] = compare_backward(
                    label, dt, args)[0]
            elif name == "fused_seed_backward":
                out[f"{name} {shape} {str(dt)[6:]} (rel to max)"] = compare_seed_backward(
                    label, dt, args[:-1], args[-1])[0]
            elif name == "lis_residual_mlp_backward":
                out[f"{name} {shape} {str(dt)[6:]} (rel to max)"] = compare_lis_backward(
                    label, dt, args[:-1], args[-1])[0]
            else:
                out[f"{name} {shape} {str(dt)[6:]}"] = compare(
                    name, label, dt, KERNEL[name](*args), PLAIN[name](*args))
    return out


def single_memory(cfg, params, real) -> dict:
    """A single process's train state on this card: `resident_bytes`, and
    the allocator's bytes kept after two steps and at their peak, each over
    what was allocated before the state was made."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = create_glis_state(cfg, *params)
    step = build_glis_train_step(cfg)
    step(state, real)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, real)
    torch.cuda.synchronize()
    out = {"resident": resident_bytes(state), "allocated": torch.cuda.memory_allocated() - base,
           "peak": torch.cuda.max_memory_allocated() - base}
    del state, step
    torch.cuda.empty_cache()
    return out


def tp_fp32(tp) -> dict:
    """2 fp32 steps of the TP step against 2 single-process steps on the
    same card from the same params and draws, under deterministic
    algorithms: phase 16's gates (metrics within CHUNK_METRICS_TOL, at most
    CHUNK_TOL of each parameter's and EMA tensor's elements more than
    lr / 5 and (1 - g_ema) lr / 5 apart). The lead alone runs the single
    process and compares."""
    cfg = tp_config(dtype="float32")
    params, real = dp_params(cfg), real_batch(cfg)
    with deterministic():
        if tp.lead:
            single = create_glis_state(cfg, *params)
            step = build_glis_train_step(cfg)
            m_single = [{k: v.item() for k, v in step(single, real).items()} for _ in range(2)]
        state = create_glis_state(cfg, *params)
        step = build_glis_train_step(cfg, dp=tp)
        tp.replicate(state)
        with recorded_inputs({}) as inputs:
            m_tp = [{k: v.item() for k, v in step(state, tp.rows(real)).items()}
                    for _ in range(2)]
        view = tp.full_view(state)
    kernels = check_recorded(inputs, tp.local, f"rank {tp.rank} fp32")
    if not tp.lead:
        return {"kernels": kernels}
    limits = {n: (p, cfg.lr / 5) for n, p in named_params(single).items()}
    limits.update({f"g_ema.{n}": (t, (1 - cfg.g_ema) * cfg.lr / 5)
                   for n, t in single.g_ema.items()})
    got = {**named_params(state), **{f"g_ema.{n}": t for n, t in view.g_ema.items()}}
    share = max(((got[n] - t).abs() > limit).float().mean().item()
                for n, (t, limit) in limits.items())
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-2) for a, b in zip(m_tp, m_single) for k in b)
    out = {"metrics_rel": rel, "params_apart_share": share, "tp": m_tp, "single": m_single,
           "kernels": kernels}
    print(f"[tp] 18(a) fp32, deterministic: 2 TP steps (world 2, one card) vs 2 single-process "
          f"steps: metrics rel {rel:.3e} (tol {CHUNK_METRICS_TOL}), largest share of a "
          f"tensor's elements apart {share:.6f} (tol {CHUNK_TOL})", flush=True)
    if rel > CHUNK_METRICS_TOL or share > CHUNK_TOL:
        raise AssertionError(f"the fp32 TP step disagrees with the single process: {out}")
    return out


def tp_rank_body(rank: int) -> dict:
    dev = torch.device("cuda", 0)
    carries = gloo_carries_cuda()
    cfg = tp_config()
    params, real = dp_params(cfg), real_batch(cfg)
    single = single_memory(cfg, params, real)
    tp = TensorParallel(dev, TP_SHARDS, cfg.batch_size, 1, cfg.tp_min_width)
    if not carries:
        tp.comm = HostStaged(tp.comm.model_group)
    rows = tp.rows(real)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = create_glis_state(cfg, *params)
    step = build_glis_train_step(cfg, dp=tp)
    tp.replicate(state)
    with recorded_inputs({}) as inputs:
        step(state, rows)  # warm-up: Adam's lazy state, the kernels' first calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step(state, rows)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    memory = {"resident": resident_bytes(state), "allocated": torch.cuda.memory_allocated() - base,
              "peak": torch.cuda.max_memory_allocated() - base}
    want = glis_launches(cfg)[0]
    kernels = check_recorded(inputs, tp.local, f"rank {rank} bf16")
    busy, wall, prof = profiled(lambda: step(state, rows), TP_TIMED)
    del state
    torch.cuda.empty_cache()
    fp32 = tp_fp32(tp)
    every = [None] * TP_SHARDS
    dist.all_gather_object(every, {
        "rank": rank, "launches": counts, "memory": memory, "single": single,
        "kernels": {"bf16": kernels, "fp32": fp32.pop("kernels")},
        "busy_ms": busy / TP_TIMED, "wall_ms": wall / TP_TIMED})
    if any(e["launches"] != want for e in every):
        raise AssertionError(f"TP launches a step {[e['launches'] for e in every]} != {want}")
    for e in every:
        got, whole = sum(e["memory"]["resident"].values()), sum(e["single"]["resident"].values())
        if not got < whole:
            raise AssertionError(f"rank {e['rank']} keeps {got} bytes of state, the single "
                                 f"process {whole}")
    return {"gloo_carries_cuda": carries, "ranks": every, "want": want, "fp32": fp32,
            "top_kernels": [(n, ms / TP_TIMED) for n, ms, _ in prof[:8]]}


def tp_rank(rank: int, port: int, results) -> None:
    """One of phase 18(a)'s two ranks: both on cuda:0, in a gloo group
    (NCCL refuses two ranks on one card)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP_SHARDS, rank=rank)
    try:
        out = tp_rank_body(rank)
        if rank == 0:
            results.put(json.dumps(out))
    finally:
        dist.destroy_process_group()


def tp_step(kernel_rows: dict, smi: str) -> dict:
    """18(a): the TP step at data 1 x model 2 on the one card (two spawned
    processes); each rank's launches a step (`launches_tp`), state bytes
    against the single process's, wall and busy, and the fp32 gates."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    t0 = time.perf_counter()
    ctx = mp.start_processes(tp_rank, nprocs=TP_SHARDS, join=False, start_method="spawn",
                             args=(free_port(), results))
    got = None
    try:
        while not ctx.join(timeout=0.5):
            if got is None and not results.empty():
                got = results.get()
            if time.perf_counter() - t0 > TP_TIMEOUT_S:
                raise TimeoutError(f"phase 18(a)'s ranks did not end within {TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    out = json.loads(results.get() if got is None else got)
    out["seconds"] = time.perf_counter() - t0
    for name, c in out["ranks"][0]["launches"].items():
        kernel_rows[name]["launches_tp"] = c
    mib = lambda n: f"{n / 2**20:.1f} MiB"  # noqa: E731
    for r in out["ranks"]:
        mem, one = r["memory"], r["single"]
        print(f"[tp] 18(a) {TP_CONFIG}, gloo{'' if out['gloo_carries_cuda'] else ' via host'}: "
              f"rank {r['rank']} launches a step {r['launches']} (phase 7's {out['want']}); "
              f"state kept {mem['resident']} = {mib(sum(mem['resident'].values()))} against "
              f"the single process's {one['resident']} = "
              f"{mib(sum(one['resident'].values()))}; allocated after a step "
              f"{mib(mem['allocated'])} (single {mib(one['allocated'])}), peak over a step "
              f"{mib(mem['peak'])} (single {mib(one['peak'])}); a step {r['wall_ms']:.3f} ms "
              f"wall, {r['busy_ms']:.3f} ms of this process's device time (two processes "
              f"sharing one card: not a TP speed); {smi}", flush=True)
        for dt, errs in r["kernels"].items():
            print(f"[tp] 18(a) rank {r['rank']} {dt}: the kernels on this rank's own inputs "
                  f"vs plain (check_kernels' TOL), max|err| {errs}", flush=True)
    print(f"[tp] 18(a) rank 0's top device kernels a step {out['top_kernels']}", flush=True)
    return out


def tp_refusal(tmp: str) -> dict:
    """18(b): --model_shards 2 on one visible card raises `gea`'s
    SystemExit before anything runs."""
    want = f"--model_shards {TP_SHARDS} needs multiple devices (1 visible)"
    try:
        run_cli(TRAINER_ARGS + ["--model_shards", str(TP_SHARDS), "--niter", "1",
                                "--save_path", os.path.join(tmp, "tp_refused")])
    except SystemExit as e:
        if str(e) != want:
            raise AssertionError(f"--model_shards {TP_SHARDS}: {e!r}, not {want!r}") from e
        print(f"[tp] 18(b) train_glis --model_shards {TP_SHARDS} on {torch.cuda.device_count()} "
              f"card: SystemExit {str(e)!r}", flush=True)
        return {"message": str(e)}
    raise AssertionError(f"--model_shards {TP_SHARDS} ran on one card")


def linked_folder(root: str, paths: list) -> str:
    os.makedirs(root, exist_ok=True)
    for p in paths:
        os.symlink(p, os.path.join(root, os.path.basename(p)))
    return root


def folder_run(tag: str, label: str, args: list, run: str) -> dict:
    """TP_STEPS steps of train_glis on a folder dataset with exact
    launches (the steps' and one render's)."""
    cfg = TrainGLISConfig.from_args(TRAINER_ARGS)
    per_step, per_render = glis_launches(cfg)
    _, stats, text, counts = counted_run(
        "tp", label, train_glis, TRAINER_ARGS + args + [
            "--synthetic_on_device", "false", "--niter", str(TP_STEPS), "--vis_interval",
            str(TP_STEPS), "--save_interval", str(TP_STEPS), "--save_path", run],
        launches(per_step, TP_STEPS, per_render, 1))
    chose = [ln for ln in text.splitlines() if "decoded by" in ln]
    if (not chose or not all(np.isfinite(v) for v in stats["metrics"].values())
            or not os.path.isfile(os.path.join(run, "checkpoints", str(TP_STEPS), "state.pt"))):
        raise AssertionError(f"{label}: {stats['metrics']}, {chose}")
    return {**cli_summary(stats, counts), "decoded_by": chose[0].split("decoded by ")[1]}


def lsun_phase(tmp: str, folder: str, smi: str) -> dict:
    """18(c): the demo JPEGs as two LSUN class folders, train_glis
    --dataset lsun --lsun_classes on both; an LMDB-only class raises
    `gea`'s lmdb message where lmdb is missing."""
    from gea_torch.data.lsun import resolve_lsun_root

    paths = list_images(folder)
    root = os.path.join(tmp, "lsun")
    half = len(paths) // 2
    linked_folder(os.path.join(root, "tower"), paths[:half])
    linked_folder(os.path.join(root, "church_outdoor"), paths[half:])
    out = folder_run("tp", f"train_glis --dataset lsun --lsun_classes tower,church_outdoor "
                     f"({len(paths)} demo JPEGs), {TP_STEPS} steps and 1 render",
                     ["--dataset", "lsun", "--dataroot", root, "--lsun_classes",
                      "tower,church_outdoor"], os.path.join(tmp, "tp_lsun"))
    os.makedirs(os.path.join(root, "bedroom_train_lmdb"))
    open(os.path.join(root, "bedroom_train_lmdb", "data.mdb"), "wb").close()
    have_lmdb = importlib.util.find_spec("lmdb") is not None
    try:
        resolve_lsun_root(TrainGLISConfig(dataset="lsun", dataroot=root,
                                          lsun_classes="bedroom"))
    except Exception as e:  # noqa: BLE001 -- which error, is the check
        out["lmdb_only"] = f"{type(e).__name__}: {e}"
        if not have_lmdb and not (isinstance(e, RuntimeError)
                                  and "needs the 'lmdb' package" in str(e)):
            raise AssertionError(f"the LMDB-only class without lmdb: {e!r}") from e
    else:
        raise AssertionError("an empty LMDB-only class resolved")
    if os.path.exists(os.path.join(root, "bedroom_train_images", ".complete")):
        raise AssertionError("a failed export left its marker")
    out["lmdb_importable"] = have_lmdb
    print(f"[tp] 18(c) lsun: {out['images_per_sec']:.1f} img/s (meter), decoded by "
          f"{out['decoded_by']}; lmdb importable: {have_lmdb}; the LMDB-only class: "
          f"{out['lmdb_only']}; {smi}", flush=True)
    return out


def image_multiset(batches) -> list:
    return sorted(hashlib.sha256(img.tobytes()).hexdigest() for b in batches for img in b)


def grain_phase(tmp: str, folder: str, smi: str) -> dict:
    """18(d): whether grain imports here; if it does, train_glis
    --data_backend grain on GRAIN_IMAGES demo JPEGs and its first epoch
    against the PIL stream's as a multiset; if not, --data_backend grain
    raises."""
    try:
        import grain
    except ImportError as e:
        print(f"[tp] 18(d) grain does not import on this machine ({e})", flush=True)
        cfg = TrainGLISConfig.from_args(TRAINER_ARGS).replace(
            dataset="folder", dataroot=folder, data_backend="grain")
        try:
            make_dataset(cfg)
        except ImportError as refused:
            print(f"[tp] 18(d) --data_backend grain raises {type(refused).__name__}: {refused}",
                  flush=True)
            return {"grain_importable": False, "refused": str(refused)}
        raise AssertionError("--data_backend grain ran without grain") from e
    version = getattr(grain, "__version__", "?")
    sub = linked_folder(os.path.join(tmp, "grain_jpegs"), list_images(folder)[:GRAIN_IMAGES])
    out = folder_run("tp", f"train_glis --data_backend grain ({GRAIN_IMAGES} demo JPEGs), "
                     f"{TP_STEPS} steps and 1 render",
                     ["--dataset", "folder", "--dataroot", sub, "--data_backend", "grain"],
                     os.path.join(tmp, "tp_grain"))
    cfg = TrainGLISConfig.from_args(TRAINER_ARGS).replace(dataset="folder", dataroot=sub)
    epoch = GRAIN_IMAGES // cfg.batch_size
    streams = {b: make_dataset(cfg.replace(data_backend=b)).batches(0) for b in ("grain", "pil")}
    sets = {b: image_multiset(next(it) for _ in range(epoch)) for b, it in streams.items()}
    out.update(grain_importable=True, version=version,
               first_epoch_equal=sets["grain"] == sets["pil"])
    print(f"[tp] 18(d) grain {version}: {out['images_per_sec']:.1f} img/s (meter); its first "
          f"epoch's {GRAIN_IMAGES} images equal the PIL stream's as a multiset: "
          f"{out['first_epoch_equal']}; {smi}", flush=True)
    if not out["first_epoch_equal"]:
        raise AssertionError("grain's first epoch is not the PIL stream's images")
    return out


def tp_phase(tmp: str, folder: str, kernel_rows: dict, smi: str) -> dict:
    """Phase 18: tensor parallelism on the one card, LSUN and grain."""
    t0 = time.perf_counter()
    out = {"config": TP_CONFIG}
    seconds = out["part_seconds"] = {}
    for name, fn in (("step", lambda: tp_step(kernel_rows, smi)),
                     ("refusal", lambda: tp_refusal(tmp)),
                     ("lsun", lambda: lsun_phase(tmp, folder, smi)),
                     ("grain", lambda: grain_phase(tmp, folder, smi))):
        t = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t0
    out["card"] = smi
    parts = ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
    print(f"[tp] phase 18 in {out['seconds']:.1f} s ({parts})", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"[device] {smi}", flush=True)
    import scipy  # frechet_distance needs it; a missing scipy stops the script here

    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, scipy {scipy.__version__}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Read at cuBLAS's first use; the H100's default size, in the form that
    # deterministic algorithms (phase 14(b)) require.
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {', '.join(str(p.name) for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build] {name}: {line.strip()}", flush=True)

    cfg = FLAGSHIP
    rows = check_kernels(cfg)
    check_backward(cfg, rows)
    check_seed_backward(cfg, rows)
    check_lis_backward(cfg, rows)
    grads = check_grads(cfg, rows)
    edges = check_edges()
    served = serving(cfg, rows)
    fp32 = fp32_agreement(cfg)
    train = training(cfg, rows, smi)
    train_fp32 = train_fp32_agreement(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        trained = trainer(tmp, rows, train["images_per_s"], smi)
        r_trainers = {"r_separate": r_separate(tmp, trained["run_dir"], rows, smi),
                      "r_iterative": r_iterative(tmp, rows, smi)}
        evaluated = evaluation(tmp, rows, smi)
        sampled = samplers(tmp, rows, smi)
        exported = export_serving(tmp, rows, served, smi)
        dispatched = dispatch_phase(tmp, rows, smi, {
            "g-lis": trained["runs"]["synthetic on device"]["images_per_sec"],
            "r-separate": r_trainers["r_separate"]["cli"]["images_per_sec"],
            "r-iterative": r_trainers["r_iterative"]["cli"]["images_per_sec"]})
        parallel = dp_phase(tmp, rows, smi)
        normed = batch_norm_phase(tmp, sampled["demo_data"]["folder"], rows, smi)
        sharded = tp_phase(tmp, sampled["demo_data"]["folder"], rows, smi)

    kernels = []
    for name, row in rows.items():
        route, source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": row["launches"], "launches_per_step": row["launches_per_step"],
            "launches_trainer": row["launches_trainer"],
            "launches_r_separate": row["launches_r_separate"],
            "launches_r_iterative": row["launches_r_iterative"],
            "launches_eval": row["launches_eval"],
            "launches_samplers": row["launches_samplers"],
            "launches_per_r_separate_step": row["launches_per_r_separate_step"],
            "launches_per_r_iterative_step": row["launches_per_r_iterative_step"],
            "launches_serving": row["launches_serving"],
            "launches_graphed": row["launches_graphed"], "launches_dp": row["launches_dp"],
            "launches_batch": row["launches_batch"], "launches_tp": row["launches_tp"],
            "launches_per_batch_step": row["launches_per_batch_step"],
            "max_abs_err": row["max_abs_err"],
            "max_err": row["max_abs_err"], "max_abs_err_fp32": row["max_abs_err_fp32"],
            "ms": row["ms"], "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "composite_ms": row["composite_ms"],
            "empty_launch_ms": row["empty_launch_ms"],
            "backward_ms": row["backward_ms"], "backward_step_ms": row["backward_step_ms"],
            "step_profile_ms": row.get("step_profile_ms"),
            "backward_bound_ms": row.get("backward_bound_ms"),
            "render_ms": row["render_ms"], "render_plain_ms": row["render_plain_ms"],
            "render_bound_ms": row["render_bound_ms"],
            "per": "bf16, one flagship train step (every launch of the kernel in it); "
                   "render_* per scored render",
            "shapes": row["shapes"],
        })
    print(json.dumps({"serving": served, "fp32_agreement": fp32, "edges": edges,
                      "grads": grads}), flush=True)
    print(json.dumps({"training": train, "train_fp32_agreement": train_fp32,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"trainer": trained}), flush=True)
    print(json.dumps({"r_trainers": r_trainers, "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"evaluation": evaluated, "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"samplers": sampled, "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"export_serving": exported, "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"dispatch": dispatched, "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"data_parallel": parallel, "seconds": time.perf_counter() - t_start}),
          flush=True)
    print(json.dumps({"batch_norm": normed, "seconds": time.perf_counter() - t_start},
                     default=str), flush=True)
    print(json.dumps({"tensor_parallel": sharded, "seconds": time.perf_counter() - t_start},
                     default=str), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
