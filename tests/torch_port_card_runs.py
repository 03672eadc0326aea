"""Train steps, trainers and worlds of the card modules
(`tests/test_torch_port_*_card.py`): the flagship trainer arguments, the
kernel launches each path must make, in-process CLI runs with their
launches counted, bitwise checkpoint round trips, the fp32
kernels-against-plain and graphed-against-eager gates with their limits,
the demo JPEGs a session writes once, and the rank body of the
tensor-parallel world that two spawned processes run on one card.
Imports no JAX and builds nothing at import."""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch_port_card_cases import (
    KERNEL,
    PLAIN,
    compare,
    compare_backward,
    compare_lis_chain,
    compare_seed_backward,
)

from gea_torch import ops
from gea_torch.cli import make_demo_data, train_glis, train_r_separate
from gea_torch.config import (
    TrainGLISConfig,
    TrainRIterativeConfig,
    TrainRSeparateConfig,
    generator_plan,
)
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.parallel.tp import Collectives, TensorParallel, resident_bytes
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.dispatch import StepDispatcher
from gea_torch.utils.checkpoint import restore_checkpoint, state_dict

BATCH = 64
TRAINER_ARGS = [
    "--dataset", "synthetic", "--synthetic_on_device", "true", "--image_size", "80",
    "--crop_size", "160", "--code_size", "256", "--r_iterations", "3", "--norm", "weight",
    "--num_features", "64", "--max_features", "512", "--dtype", "bfloat16",
    "--batch_size", str(BATCH), "--log_interval", "10",
]
RITER_ARGS = ["--r_chain_length", "2", "--lambda_r", "0.9"]
TRAINER_STEPS, TRAINER_VIS, RESUME_TO = 40, 20, 60
# `gea`'s fifth milestone configuration, "Data-parallel G-LIS at 160x160":
# flagship_config(image_size=160, spatial_code=4) (benchmarks/grad_accum_probe.py:46-52),
# G-LIS-3, nf 64 / cap 512, bf16, BCE, global batch 64.
DP_ARGS = [*TRAINER_ARGS[:TRAINER_ARGS.index("--image_size")], "--image_size", "160",
           *TRAINER_ARGS[TRAINER_ARGS.index("--image_size") + 2:], "--spatial_code", "4"]
GRAPH_K, GRAPH_REPLAYS = 8, 2  # a K = 8 graph, replayed twice: 16 steps

FP32_TOL = {"metrics_rel": 1e-4, "grad_rel_to_max": 2e-2, "params_apart_share": 2e-2}
CHUNK_TOL = 2e-2  # graphed vs eager and vs the golden: atol 2e-2, rtol 2%, 2% of elements
# Graphed vs eager metrics under deterministic algorithms, relative: the two
# differ only in the capturable Adam's fp32 arithmetic (at most 2.3e-5 on an
# H100 80GB HBM3 at 700 W).
CHUNK_METRICS_TOL = 1e-3
# Running statistics of two runs of the same steps, absolute: a conv bias
# that feeds a batch norm has a gradient zero up to rounding, so Adam's
# first update may move it by lr one way on one side and the other way on
# the other (2 lr = 4e-4 at the default lr), which moves the next running
# mean by 0.1 * 4e-4; an update applied twice moves it by 0.1 of the
# batch statistic itself, 1e-2 or more.
STATS_TOL = 1e-3

# demo20k's first images, which hold its spot hashes img00000 and img01250.
DEMO_COUNT, DEMO_SPOTS = 1251, ("img00000.jpg", "img01250.jpg")
DEMO_ARGS = ["--size", "200", "--seed", "0", "--quality", "92", "--style", "diverse"]


@contextlib.contextmanager
def cudnn_tf32():
    """PyTorch's default for cuDNN (TF32 allowed in fp32 convolutions),
    under which the train steps and trainers run; elsewhere the card
    modules keep TF32 off so that fp32 comparisons hold fp32 arithmetic."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for every op (cuDNN's convolutions among
    them; cuBLAS through CUBLAS_WORKSPACE_CONFIG, which the `card` fixture
    sets), so that two runs of the same steps agree bit for bit."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def real_batch(cfg) -> torch.Tensor:
    """The real batch every `gea` probe times against (benchmarks/common.py)."""
    s = cfg.image_size
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (BATCH, s, s, 3)).astype(np.float32)).cuda()


def named_params(state) -> dict:
    """The trained parameters of a train state, by module and name."""
    return {f"{name}.{n}": p for name, _ in state.PLAYERS
            for n, p in getattr(state, name).named_parameters()}


def finite(metrics) -> bool:
    return all(np.isfinite(v) for v in metrics.values())


# ------------------------------------------------------------------ launches


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
             "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0,
             "lis_chain_backward": 1, "fused_seed": 1, "fused_seed_backward": 1},
            {"fused_tprelu": acts, "fused_tprelu_backward": 0,
             "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0,
             "lis_chain_backward": 0, "fused_seed": 1, "fused_seed_backward": 0})


def r_separate_launches(cfg) -> tuple:
    """(launches of an R-separate step, of a corrected render)."""
    acts = generator_plan(cfg.image_size)[1] - 1  # TPReLUs of one G render, of D's trunk
    # A render: before, R (trunk + head), after; a step adds D on it and
    # differentiates D, the after render (its LIS links and seed for dz
    # alone) and R (the before render is not).
    per_render = {"fused_tprelu": acts + (acts + 1) + acts, "fused_tprelu_backward": 0,
                  "lis_residual_mlp": 2 * cfg.r_iterations, "lis_residual_mlp_backward": 0,
                  "lis_chain_backward": 0, "fused_seed": 2, "fused_seed_backward": 0}
    return {**per_render, "fused_tprelu": per_render["fused_tprelu"] + acts,
            "fused_tprelu_backward": 3 * acts + 1, "lis_chain_backward": 1,
            "fused_seed_backward": 1}, per_render


def r_iterative_launches(cfg) -> tuple:
    """(launches of an R-iterative step, of one unroll of the chain)."""
    acts, links = generator_plan(cfg.image_size)[1] - 1, cfg.r_chain_length
    chain = (links + 1) * acts + links * (acts + 1)  # renders and R's of one unroll
    # A step: the D step's unroll, D on real and on fakes, the joint
    # unroll and D on its images; all but the D step's unroll (no grad)
    # are differentiated, so each of the joint unroll's links + 1 renders
    # has a seed backward.
    return ({"fused_tprelu": 2 * chain + 3 * acts, "fused_tprelu_backward": chain + 3 * acts,
             "lis_residual_mlp": 0, "lis_residual_mlp_backward": 0, "lis_chain_backward": 0,
             "fused_seed": 2 * (links + 1), "fused_seed_backward": links + 1},
            {"fused_tprelu": chain, "fused_tprelu_backward": 0, "lis_residual_mlp": 0,
             "lis_residual_mlp_backward": 0, "lis_chain_backward": 0, "fused_seed": links + 1,
             "fused_seed_backward": 0})


def bn_launches(cfg) -> tuple:
    """(launches of a batch-norm G-LIS step, of a render of every stage).
    No seed kernel: `gea` turns the fused seed off under batch norm. A G
    forward runs a LIS link per module and a TPReLU (LeakyReLU 0.2) after
    each of its d batch norms; the step runs G twice (the first forward's
    statistics are dropped) and D's trunk (d - 1 TPReLUs) three times: on
    the reals, on the fakes and for G's loss. The second G forward and the
    three D forwards are differentiated: d + 3 (d - 1) TPReLU backwards, each
    without da and db (the LeakyReLU's slope and offset are fixed), and a
    LIS chain backward, without dslope and dtrans."""
    d = generator_plan(cfg.image_size)[1]
    render = {"fused_tprelu": d, "fused_tprelu_backward": 0,
              "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0,
              "lis_chain_backward": 0, "fused_seed": 0, "fused_seed_backward": 0}
    return ({"fused_tprelu": 2 * d + 3 * (d - 1), "fused_tprelu_backward": d + 3 * (d - 1),
             "lis_residual_mlp": 2 * cfg.r_iterations, "lis_residual_mlp_backward": 0,
             "lis_chain_backward": 1, "fused_seed": 0, "fused_seed_backward": 0}, render)


def launches(per_step: dict, steps: int, per_render: dict, renders: int) -> dict:
    return {k: steps * per_step[k] + renders * per_render[k] for k in per_step}


def times(per: dict, n: int) -> dict:
    return {k: n * v for k, v in per.items()}


def counted(label: str, fn, want: dict) -> dict:
    """`fn()` with the launch counters zeroed just before and read just
    after; they must equal `want`."""
    ops.reset_launch_counts()
    fn()
    counts = ops.launch_counts()
    assert counts == want, f"{label}: launch counts {counts} != {want}"
    return counts


# ------------------------------------------------------------------ CLI runs


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


def counted_run(label: str, cli, args, want: dict) -> tuple:
    """One CLI run with the launch counters zeroed just before it and read
    just after; they must equal `want`. (state, stats, text, counts)."""
    ops.reset_launch_counts()
    state, stats, text = run_cli(args, cli)
    counts = ops.launch_counts()
    print(f"{label}: launch counts {counts} (want {want})", flush=True)
    assert counts == want, f"{label}: launch counts {counts} != {want}"
    return state, stats, text, counts


def relaunch(label: str, cli, args, run: str, per_step: dict, per_render: dict) -> None:
    """The same CLI with --niter RESUME_TO resumes at TRAINER_STEPS and
    reaches RESUME_TO with finite metrics and exact launches."""
    renders = RESUME_TO // TRAINER_VIS - TRAINER_STEPS // TRAINER_VIS
    state, stats, text, _ = counted_run(
        f"{label} relaunch, {RESUME_TO - TRAINER_STEPS} steps and {renders} renders", cli,
        args + ["--niter", str(RESUME_TO)],
        launches(per_step, RESUME_TO - TRAINER_STEPS, per_render, renders))
    line = f"resumed from {run} at step {TRAINER_STEPS}"
    assert line in text and state.step == RESUME_TO, (
        f"{label} resume: {line!r} printed: {line in text}, step {state.step}")
    assert finite(stats["metrics"]), f"{label}: non-finite metrics after the resume: {stats}"


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


def round_trip(run_dir: str, step: int, state, fresh) -> None:
    """The checkpoint of `step` restored into `fresh`, a new state of the
    same trainer, equals `state` bit for bit: parameters, Adam's moments and
    steps, the schedulers, the generator's state, the EMA shadow (G-LIS)
    and the step."""
    want = state_dict(state)
    restored = restore_checkpoint(run_dir, fresh, step=step)
    diff = same(state_dict(restored), want)
    assert not diff, f"restored checkpoint {step} differs at {diff[:8]}"


def check_trained(label: str, state, init: dict) -> None:
    """Every trained parameter has a finite, non-zero gradient from the
    last step and has moved from its initial value `init`."""
    params = named_params(state)
    norms = {n: p.grad.float().norm().item() if p.grad is not None else float("nan")
             for n, p in params.items()}
    bad = [n for n, v in norms.items() if not (np.isfinite(v) and v > 0)]
    still = [n for n, p in params.items() if torch.equal(p.detach(), init[n])]
    assert not bad and not still, (f"{label}: no finite non-zero gradient for {bad}; never "
                                   f"moved: {still}")


def check_artifacts(label: str, run: str, stages: int) -> None:
    artifacts = ["config.json"] + [f"checkpoints/{s}/state.pt" for s in (20, 40)] + [
        f"samples/samples_{s:08d}_stage{i}.png" for s in (20, 40) for i in range(stages)]
    missing = [a for a in artifacts if not os.path.isfile(os.path.join(run, a))]
    assert not missing, f"{label}: missing artifacts {missing}"


def r_separate_config(g_run: str, args: list) -> TrainRSeparateConfig:
    g_cfg = TrainGLISConfig.load(os.path.join(g_run, "config.json"))
    return train_r_separate.architecture_from_g(TrainRSeparateConfig.from_args(args), g_cfg)


_DEMO = {}  # the session's temporary directory -> its demo folder


def demo_folder(tmp_path_factory) -> str:
    """`make_demo_data`'s first DEMO_COUNT images of demo20k, written once
    a session under the session's temporary directory: the trainers' and
    the batch-norm modules share it, and a card run holds no conftest to
    keep a session fixture in."""
    base = tmp_path_factory.getbasetemp()
    if base not in _DEMO:
        folder = str(tmp_path_factory.mktemp("demo") / "demo20k")
        make_demo_data.main(["--out", folder, "--count", str(DEMO_COUNT)] + DEMO_ARGS)
        _DEMO[base] = folder
    return _DEMO[base]


# ------------------------------------------------- fp32, kernels vs plain


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

    def apart(a, b) -> dict:
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
        }

    kernels, plain, again = two_steps(True), two_steps(False), two_steps(False)
    errs, spread = apart(kernels, plain), apart(again, plain)
    print(f"[{label} fp32] 2 steps with kernels vs plain versions: {errs} (tol {tol}); "
          f"plain vs plain again: {spread}", flush=True)
    for k in tol:
        assert errs[k] <= tol[k], f"{label} fp32 step {k} {errs[k]:.3e} > {tol[k]}"
    return {"kernels_vs_plain": errs, "plain_vs_plain": spread}


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


def fp32_codes(seed: int, code_size: int) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BATCH, code_size)).astype(np.float32)).cuda()
            for _ in range(2)]


# ------------------------------------------------------ graphed against eager

# Each wrapper's kernels by their names in a torch.profiler trace, with the
# launches one call makes: a bf16 seed call is two launches of seed_tap_gemm
# (the projection, then the transposed conv), an fp32 one seed_f32_project
# then seed_f32_conv; every seed backward that
# computes any gradient (in either dtype) launches seed_bwd_project once,
# every LIS chain backward lis_chain_kernel once. A link's backward alone
# (`lis_residual_mlp_backward`, a chain of one) launches the same kernel
# and runs on no path counted here: its calls would count as the chain's.
KERNEL_EVENTS = {"fused_tprelu": (("tprelu_kernel", 1),),
                 "fused_tprelu_backward": (("tprelu_grad_kernel", 1),),
                 "lis_residual_mlp": (("lis_kernel_", 1),),
                 "lis_residual_mlp_backward": (),
                 "lis_chain_backward": (("lis_chain_kernel", 1),),
                 "fused_seed": (("seed_tap_gemm", 2), ("seed_f32_", 2)),
                 "fused_seed_backward": (("seed_bwd_project", 1),)}


def calls_from(launches_of) -> dict:
    """Each wrapper's calls from `launches_of(kernel name) -> launches of
    kernels so named`, over the launches a call makes."""
    out = {}
    for name, kernels in KERNEL_EVENTS.items():
        out[name] = 0
        for key, per_call in kernels:
            n = launches_of(key)
            assert n % per_call == 0, f"{n} {key} launches are not whole calls of {name}"
            out[name] += n // per_call
    return out


def traced_calls(fn) -> dict:
    """Each wrapper's calls in a torch.profiler trace of one call of `fn`,
    from its kernels' events. A trace can miss records (CUPTI drops some
    now and then), never invent them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages() if e.self_device_time_total > 0]
    return calls_from(lambda key: sum(count for k, count in rows if key in k))


@contextlib.contextmanager
def graphs_kept():
    """Graphs captured meanwhile keep their CUDA graph after it is
    instantiated (`keep_graph`, debug mode), so that `graph_text` can
    read it."""
    made = torch.cuda.CUDAGraph

    def kept_graph():
        graph = made(keep_graph=True)
        graph.enable_debug_mode()
        return graph

    torch.cuda.CUDAGraph = kept_graph
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_text(graph, tmp: str) -> str:
    """CUDA's dump of a graph captured under `graphs_kept`
    (`cudaGraphDebugDotPrint`), which names each kernel node's function
    once: a replay launches exactly these nodes."""
    path = os.path.join(tmp, "graph.dot")
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    os.remove(path)
    return text


def graph_trainers() -> dict:
    """tag -> (cfg at K = GRAPH_K, make_state(cfg), build_step(cfg), launches
    of one step, the real batch or None) of the three trainers at flagship
    width, bf16, batch 64, BCE; R-separate against a frozen G and D made
    from seeded params."""
    rsep = TrainRSeparateConfig.from_args(TRAINER_ARGS)
    rsep_g = generator_from_jax_params(init_generator_params(rsep, 0), rsep)
    rsep_d = discriminator_from_jax_params(init_discriminator_params(rsep, 1), rsep)
    glis = TrainGLISConfig.from_args(TRAINER_ARGS)
    riter = TrainRIterativeConfig.from_args(TRAINER_ARGS + RITER_ARGS)
    k = {"steps_per_dispatch": GRAPH_K}
    return {
        "g-lis": (glis.replace(**k), create_glis_state, build_glis_train_step,
                  glis_launches(glis)[0], real_batch(glis)),
        "r-separate": (rsep.replace(**k), lambda c: create_r_state(c, rsep_g, rsep_d),
                       build_r_separate_step, r_separate_launches(rsep)[0], None),
        "r-iterative": (riter.replace(**k), create_r_iterative_state, build_r_iterative_step,
                        r_iterative_launches(riter)[0], real_batch(riter)),
    }


def eager_vs_graphed(tag: str, entry: tuple, tmp: str) -> None:
    """GRAPH_K * GRAPH_REPLAYS eager steps against GRAPH_REPLAYS replays
    of a K-step graph, each with exact launches. The launch counters after
    the replays are the dispatcher's (a replay runs no Python), so the
    graph's own kernel nodes are counted (CUDA's dump of the captured
    graph) and must equal GRAPH_K eager steps' counters; the kernels'
    events in a torch.profiler trace of the eager steps and of the replays
    may not exceed the counters. The replays' metrics are finite, every
    parameter moved and the state's step counts every step."""
    cfg, make_state, build_step, per_step, real = entry
    n = GRAPH_K * GRAPH_REPLAYS
    want = times(per_step, n)
    eager_cfg = cfg.replace(steps_per_dispatch=1)
    state, step = make_state(eager_cfg), build_step(eager_cfg)
    for _ in range(2):
        step(state, real)

    def eager():
        for _ in range(n):
            step(state, real)

    counted(f"{tag} eager", eager, want)
    traced = {"eager": traced_calls(eager)}
    del state, step
    torch.cuda.empty_cache()

    state, step = make_state(cfg), build_step(cfg)
    before = {k: p.detach().clone() for k, p in named_params(state).items()}
    dispatch = StepDispatcher(cfg, step)
    reals = [real] * GRAPH_K
    with graphs_kept():
        dispatch(state, reals)  # warm-up, capture, first replay (which instantiates)
    chunk = dispatch.chunks[GRAPH_K]
    nodes = calls_from(graph_text(chunk.graph, tmp).count)
    per_replay = times(per_step, GRAPH_K)
    assert nodes == per_replay and chunk.launches == per_replay, (
        f"{tag}: the graph's kernel nodes {nodes} and the dispatcher's count of a replay "
        f"{chunk.launches}, not {GRAPH_K} steps' {per_replay}")
    history = []

    def replays():
        for _ in range(GRAPH_REPLAYS):
            history.append(dispatch(state, reals))

    counted(f"{tag} graphed", replays, want)
    traced["graphed"] = traced_calls(replays)
    for mode, seen in traced.items():
        assert not any(seen[k] > v for k, v in want.items()), (
            f"{tag}: the {mode} trace of {n} steps holds {seen} kernel calls, more than the "
            f"{want} launched")
    values = {k: v.tolist() for k, v in history[-1].items()}
    assert all(np.isfinite(x) for vs in values.values() for x in vs), (
        f"{tag}: non-finite graphed metrics {values}")
    still = [k for k, p in named_params(state).items() if torch.equal(p, before[k])]
    assert not still and state.step == (1 + 2 * GRAPH_REPLAYS) * GRAPH_K, (
        f"{tag}: parameters not moved by the graph {still[:8]}, step {state.step}")
    print(f"[dispatch] {tag}: a K={GRAPH_K} replay launches {nodes}; traced {traced}", flush=True)
    del state, step, dispatch, chunk
    torch.cuda.empty_cache()


def injected(step, draws: Optional[list]):
    """`step` with `draws` (one noise dict a step) in place of its own;
    `step` itself with None."""
    if draws is not None:
        it = iter(draws)
        step.noise = lambda state: next(it)
    return step


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


def running_stats(state) -> dict:
    """Batch norm's running means and variances of a state's trained
    players, by module and name ({} without batch norm)."""
    return {f"{name}.{n}": t for name, _ in state.PLAYERS
            for n, t in getattr(state, name).named_buffers() if n.endswith((".mean", ".var"))}


def chunk_agreement(tag: str, cfg, make_state, build_step, real, draws: Optional[list],
                    golden: Optional[dict] = None, named=None) -> dict:
    """fp32 without TF32, under deterministic algorithms: a graphed K = 2
    chunk against 2 eager steps from the same params and draws (`draws`,
    or the state's own generator with None). Two eager runs must agree bit
    for bit. The graphed chunk (a capturable Adam with its lr read from the
    graph's buffer): the metrics within CHUNK_METRICS_TOL, and every
    parameter with at most CHUNK_TOL of its elements more than lr / 5 apart
    (Adam's first update is about lr * sign(g): a gradient near zero flips
    by 2 lr); the EMA shadow likewise against (1 - g_ema) * lr / 5. Both
    against the golden where there is one (metrics, the norm of every
    tensor). `named(state)` gives the parameters held to the share gate
    (all of them by default); batch norm's running statistics, where the
    models have them, are held to STATS_TOL."""
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
    same_again = again == eager and bitwise(again_state, eager_state)
    result = {"metrics_rel": worst, "params_apart_share": share,
              "eager_again_bitwise": same_again}
    bad = worst > CHUNK_METRICS_TOL or share > CHUNK_TOL or not same_again
    stats, eager_stats = running_stats(state), running_stats(eager_state)
    if stats:
        same_again = same_again and all(torch.equal(t, running_stats(again_state)[n])
                                        for n, t in eager_stats.items())
        result["eager_again_bitwise"] = same_again
        result["stats_max_abs"] = max((t - eager_stats[n]).abs().max().item()
                                      for n, t in stats.items())
        bad = bad or not same_again or result["stats_max_abs"] > STATS_TOL
    if golden is not None:
        for label, metrics, st in (("eager", eager, eager_state), ("graphed", graphed, state)):
            result[f"golden_{label}"] = golden_deviations(metrics, st, golden)
            bad = bad or bool(result[f"golden_{label}"]["off"])
    print(f"[dispatch] {tag} fp32, no TF32, deterministic: graphed K=2 chunk vs 2 eager steps "
          f"{result} (metrics tol {CHUNK_METRICS_TOL}, share tol {CHUNK_TOL})", flush=True)
    assert not bad, f"{tag}: the graphed chunk disagrees: {result}"
    return result


# --------------------------------------------------------------- batch norm


def with_norm(args: list, norm: str) -> list:
    i = args.index("--norm")
    return args[:i + 1] + [norm] + args[i + 2:]


BN_ARGS = with_norm(TRAINER_ARGS, "batch")


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


def bn_state(cfg, **kw):
    return create_glis_state(cfg, init_generator_params(cfg, 0),
                             init_discriminator_params(cfg, 1), **kw)


# ---------------------------------------------------- parallel worlds


def dp_config(**kw) -> TrainGLISConfig:
    return TrainGLISConfig.from_args(DP_ARGS).replace(**kw)


def dp_params(cfg) -> tuple:
    return init_generator_params(cfg, 0), init_discriminator_params(cfg, 1)


def http_post(url: str, payload: dict) -> tuple:
    """(status, JSON body) of one POST."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


TP_SHARDS, TP_TIMEOUT_S = 2, 300


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
        print(f"[tp] gloo refuses CUDA tensors here ({e}); the ranks stage them through "
              "host copies", flush=True)
        return False


class HostStaged(Collectives):
    """TP's collectives with each CUDA tensor copied to the host and back
    around the gloo call: what a TensorParallel gets where gloo refuses
    CUDA tensors."""

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
KERNEL_SITES = (("gea_torch.ops.lis", "_forward", "lis_residual_mlp"),
                ("gea_torch.models.generator", "fused_seed", "fused_seed"),
                ("gea_torch.ops.layers", "fused_tprelu", "fused_tprelu"),
                ("gea_torch.ops.tprelu", "_backward", "fused_tprelu_backward"),
                ("gea_torch.ops.seed", "_backward", "fused_seed_backward"),
                ("gea_torch.ops.lis", "_chain_backward", "lis_chain_backward"))


def kept(a):
    """A detached copy of a tensor, or of each tensor of a list (the chain's
    per-link inputs); anything else as it is."""
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
        return [t.detach().clone() for t in a]
    return a


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
            first = args[0][0] if isinstance(args[0], (list, tuple)) else args[0]  # the chain's z0
            key = (_name, tuple(first.shape), first.dtype)
            if key not in store:
                store[key] = tuple(kept(a) for a in args)
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
    forwards at `compare`'s TOL (max |err|), TPReLU's backward by
    `compare_backward` (dx bit for bit; the da/db error relative to their
    max), the seed's and LIS's by `compare_seed_backward` and
    `compare_lis_chain` (the error relative to each gradient's max);
    every kernel must have been recorded, LIS and the seed (and their
    backwards) at this rank's `rows` (the seed on the S stages' stacked
    rows)."""
    got = {name for name, _, _ in store}
    assert got == {*KERNEL, "fused_tprelu_backward", "fused_seed_backward",
                   "lis_chain_backward"}, f"{tag}: recorded {sorted(got)}, not every kernel"
    out = {}
    with torch.no_grad():
        for (name, shape, dt), args in sorted(store.items(), key=str):
            assert name.startswith("fused_tprelu") or shape[0] % rows == 0, (
                f"{tag}: {name} at {shape}, not this rank's {rows} rows")
            label = f"{tag} {name} {shape}"
            if name == "fused_tprelu_backward":
                out[f"{name} {shape} {str(dt)[6:]}"] = compare_backward(label, dt, args)[0]
            elif name == "fused_seed_backward":
                out[f"{name} {shape} {str(dt)[6:]}"] = compare_seed_backward(
                    label, dt, args[:-1], args[-1])[0]
            elif name == "lis_chain_backward":
                out[f"{name} {shape} {str(dt)[6:]}"] = compare_lis_chain(
                    label, dt, args[:-1], args[-1])[0]
            else:
                out[f"{name} {shape} {str(dt)[6:]}"] = compare(
                    name, label, dt, KERNEL[name](*args), PLAIN[name](*args))
    return out


def tp_fp32(tp) -> dict:
    """2 fp32 steps of the TP step against 2 single-process steps on the
    same card from the same params and draws, under deterministic
    algorithms: metrics within CHUNK_METRICS_TOL, at most CHUNK_TOL of each
    parameter's and EMA tensor's elements more than lr / 5 and
    (1 - g_ema) lr / 5 apart. Each rank holds its recorded kernel inputs
    against the plain versions; the lead alone runs the single process
    and compares."""
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
    out = {"metrics_rel": rel, "params_apart_share": share, "kernels": kernels}
    assert rel <= CHUNK_METRICS_TOL and share <= CHUNK_TOL, (
        f"the fp32 TP step disagrees with the single process: {out}")
    return out


def single_resident(cfg, params, real) -> dict:
    """`resident_bytes` of a single process's train state on this card
    after two steps."""
    state = create_glis_state(cfg, *params)
    step = build_glis_train_step(cfg)
    for _ in range(2):
        step(state, real)
    out = resident_bytes(state)
    del state, step
    torch.cuda.empty_cache()
    return out


def tp_rank_body(rank: int) -> dict:
    """The flagship TP step (bf16, --g_ema, model 2) on this rank: its
    launches a step, the state it keeps, and the kernels on its own inputs
    against their plain versions, in bf16 and in fp32 (`tp_fp32`). All
    ranks' records are gathered; every rank's launches must be a G-LIS
    step's and every rank must keep fewer state bytes than the single
    process."""
    dev = torch.device("cuda", 0)
    carries = gloo_carries_cuda()
    cfg = tp_config()
    params, real = dp_params(cfg), real_batch(cfg)
    single = single_resident(cfg, params, real)
    tp = TensorParallel(dev, TP_SHARDS, cfg.batch_size, 1, cfg.tp_min_width)
    if not carries:
        tp.comm = HostStaged(tp.comm.model_group)
    rows = tp.rows(real)
    state = create_glis_state(cfg, *params)
    step = build_glis_train_step(cfg, dp=tp)
    tp.replicate(state)
    with recorded_inputs({}) as inputs:
        step(state, rows)  # warm-up: Adam's lazy state, the kernels' first calls
    ops.reset_launch_counts()
    step(state, rows)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    resident = resident_bytes(state)
    kernels = check_recorded(inputs, tp.local, f"rank {rank} bf16")
    del state
    torch.cuda.empty_cache()
    fp32 = tp_fp32(tp)
    every = [None] * TP_SHARDS
    dist.all_gather_object(every, {"rank": rank, "launches": counts, "resident": resident,
                                   "single": single,
                                   "kernels": {"bf16": kernels, "fp32": fp32.pop("kernels")}})
    want = glis_launches(cfg)[0]
    assert all(e["launches"] == want for e in every), (
        f"TP launches a step {[e['launches'] for e in every]} != {want}")
    for e in every:
        got, whole = sum(e["resident"].values()), sum(e["single"].values())
        assert got < whole, f"rank {e['rank']} keeps {got} bytes of state, the single {whole}"
    return {"gloo_carries_cuda": carries, "ranks": every, "fp32": fp32}


def tp_rank(rank: int, port: int, results) -> None:
    """One of the TP world's two ranks: both on cuda:0, in a gloo group
    (NCCL refuses two ranks on one card). Rank 0 puts the gathered record
    on `results`."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=TP_SHARDS, rank=rank)
    try:
        out = tp_rank_body(rank)
        if rank == 0:
            results.put(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()

