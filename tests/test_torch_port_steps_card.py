"""Renders and train steps on the card at flagship width (80x80, code 256,
3 LIS links, nf 64 / cap 512, batch 64, BCE): a filtered serving request's
launches and outputs, the fp32 render with kernels against the plain
versions, the bf16 G-LIS step's launches, gradients and backward kernels,
and 2 fp32 steps with kernels against 2 with the plain versions; then the
steps as CUDA graphs (`--steps_per_dispatch`): K = 8 replays against eager
steps with exact launches for the three trainers, graphed K = 2 fp32 chunks
against eager steps under deterministic algorithms (and against
`tests/torch_port_step_golden.json`), the CLIs at K = 8 with their saves,
renders and resumes, and `--debug_checks`, `--profile_dir` and
`--tensorboard`. Needs an NVIDIA card and skips without one; imports no
JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_steps_card.py
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_card_cases import card  # noqa: F401 -- the session fixture
from torch_port_card_runs import (
    BATCH,
    GRAPH_K,
    RITER_ARGS,
    TRAINER_ARGS,
    TRAINER_STEPS,
    TRAINER_VIS,
    chunk_agreement,
    counted_run,
    cudnn_tf32,
    eager_vs_graphed,
    finite,
    fp32_agreement_of,
    fp32_codes,
    glis_launches,
    graph_trainers,
    launches,
    named_params,
    r_iterative_launches,
    r_separate_config,
    r_separate_launches,
    real_batch,
    round_trip,
    run_cli,
    two_fp32_steps,
)

from gea_torch import FLAGSHIP, ops
from gea_torch.cli import train_glis, train_r_iterative, train_r_separate
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
from gea_torch.serve import ServingModel
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]
TESTS = Path(__file__).resolve().parent
COUNT, OVERSAMPLE = 64, 4
TRAIN_STEPS = 10

# Device kernels under these autograd nodes are the backward of a port
# kernel's Function; the port's own kernels, by name, are the first
# category, then the libraries' (the first rule that matches wins).
PORT_BACKWARD = {"FusedTPReLUBackward": "fused_tprelu",
                 "LISResidualMLPBackward": "lis_residual_mlp",
                 "LISChainBackward": "lis_residual_mlp",
                 "FusedSeedBackward": "fused_seed"}
CATEGORIES = (
    ("port kernels", ("seed_tap_gemm", "seed_f32_", "lis_kernel", "tprelu_kernel",
                      "tprelu_grad_", "seed_bwd_", "lis_chain_")),
    ("library convs (cuDNN)", ("xmma", "cudnn", "cutlass", "nhwc", "implicit_gemm")),
    ("library matmuls (cuBLAS)", ("gemm", "gemv")),
)


def kernel_category(name: str) -> str:
    return next((c for c, keys in CATEGORIES if any(k in name for k in keys)), "other")


def foreign_kernels_in_backwards(fn) -> tuple:
    """torch.profiler (CPU and CUDA) over one call of `fn`: for each port
    Function's backward node, the cuBLAS and cuDNN kernels launched under
    it, and the kernels other than the port's launched inside its custom
    op (`gea_torch::...`). (library, in_op), each {kernel: [names]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    library = {k: [] for k in PORT_BACKWARD.values()}
    in_op = {k: [] for k in PORT_BACKWARD.values()}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        names, parent = [], e
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        port = next((k for key, k in PORT_BACKWARD.items() if any(key in n for n in names)), None)
        if port is None:
            continue
        op = any(n.startswith("gea_torch::") for n in names)
        for k in e.kernels:
            cat = kernel_category(k.name)
            if cat == "port kernels":
                continue
            if cat in ("library convs (cuDNN)", "library matmuls (cuBLAS)"):
                library[port].append(k.name[:90])
            if op:
                in_op[port].append(k.name[:90])
    return library, in_op


def test_filtered_request_launches_and_outputs():
    """`ServingModel.from_modules(G, D).sample_filtered(64, oversample=4,
    batch_size=64)` in bf16 from seeded params: each render's launches,
    the outputs' shapes and dtypes, scores in [0, 1] and sorted, not every
    pixel the same."""
    cfg = FLAGSHIP
    model = ServingModel.from_modules(
        generator_from_jax_params(init_generator_params(cfg, seed=0), cfg),
        discriminator_from_jax_params(init_discriminator_params(cfg, seed=1), cfg))
    ops.reset_launch_counts()
    best = model.sample_filtered(COUNT, seed=0, oversample=OVERSAMPLE, batch_size=BATCH)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    renders = COUNT * OVERSAMPLE // BATCH
    n_act = 2 * (generator_plan(cfg.image_size)[1] - 1)
    want = {"fused_tprelu": n_act * renders, "fused_tprelu_backward": 0,
            "lis_residual_mlp": cfg.r_iterations * renders, "lis_residual_mlp_backward": 0,
            "lis_chain_backward": 0, "fused_seed": renders, "fused_seed_backward": 0}
    assert counts == want
    s = cfg.image_size
    expect = {"images": ((COUNT, s, s, 3), np.uint8),
              "stages": ((cfg.r_iterations + 1, COUNT, s, s, 3), np.uint8),
              "scores": ((COUNT,), np.float32)}
    for k, (shape, dt) in expect.items():
        assert best[k].shape == shape and best[k].dtype == dt, (k, best[k].shape, best[k].dtype)
    sc = best["scores"]
    assert np.isfinite(sc).all() and (sc >= 0).all() and (sc <= 1).all(), sc
    assert (np.diff(sc) <= 0).all(), "scores are not sorted by descending score"
    assert not np.array_equal(best["images"].min(), best["images"].max()), (
        "every pixel of every image is the same")


def test_fp32_render_with_kernels_matches_the_plain_versions():
    """The same fp32 render + score with kernels and with plain versions:
    fp32 sums in another order through 4 conv layers, about 1e-6 relative
    a layer; 2e-4 is a wide margin over that and far below one uint8
    level."""
    cfg32 = dataclasses.replace(FLAGSHIP, dtype="float32")
    g_params = init_generator_params(cfg32, seed=0)
    d_params = init_discriminator_params(cfg32, seed=1)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (BATCH, cfg32.code_size)).astype(np.float32)).cuda()
    outs = []
    with torch.inference_mode():
        for use_kernels in (True, False):
            g = generator_from_jax_params(g_params, cfg32, use_kernels=use_kernels)
            d = discriminator_from_jax_params(d_params, cfg32, use_kernels=use_kernels)
            imgs, zs = g.render(z)
            outs.append((imgs, zs, torch.sigmoid(d(imgs[-1]))))
            del g, d
    (ik, zk, sk), (ip, zp, sp) = outs
    errs = {"images": (ik - ip).abs().max().item(), "zs": (zk - zp).abs().max().item(),
            "scores": (sk - sp).abs().max().item()}
    tol = {"images": 2e-4, "zs": 1e-4, "scores": 1e-5}
    print(f"[fp32] render with kernels vs plain versions: max |diff| {errs} (tol {tol})")
    assert all(errs[k] <= tol[k] for k in errs), (errs, tol)
    assert torch.isfinite(ik).all(), "non-finite fp32 images"


def test_glis_step_launches_gradients_and_backward_kernels():
    """The bf16 G-LIS step, under PyTorch's default TF32 settings: the
    first step launches seed 1, LIS 3, TPReLU 9, TPReLU's backward 9,
    LIS's chain backward once and the seed's backward once, and gives
    every parameter of G and D a finite non-zero gradient; 10 more steps
    launch 10 steps' kernels with finite metrics, and every parameter
    moved. Under torch.profiler no cuBLAS or cuDNN kernel runs under the
    seed's backward, and under LIS's none, nor any kernel inside its op
    but the port's."""
    cfg = FLAGSHIP
    tcfg = TrainGLISConfig(**{**dataclasses.asdict(cfg), "batch_size": BATCH, "gan_loss": "bce"})
    with cudnn_tf32():
        state = create_glis_state(tcfg, init_generator_params(cfg, 0),
                                  init_discriminator_params(cfg, 1))
        step = build_glis_train_step(tcfg)
        real = real_batch(cfg)
        params = named_params(state)
        before = {n: p.detach().clone() for n, p in params.items()}
        per_step = glis_launches(tcfg)[0]
        ops.reset_launch_counts()
        step(state, real)
        torch.cuda.synchronize()
        assert ops.launch_counts() == per_step
        norms = {n: p.grad.float().norm().item() if p.grad is not None else float("nan")
                 for n, p in params.items()}
        bad = [n for n, v in norms.items() if not (np.isfinite(v) and v > 0)]
        assert not bad, f"no finite non-zero gradient on step 1 for {bad}"
        step(state, real)
        ops.reset_launch_counts()
        history = [{k: v.item() for k, v in step(state, real).items()}
                   for _ in range(TRAIN_STEPS)]
        assert ops.launch_counts() == {k: TRAIN_STEPS * v for k, v in per_step.items()}
        assert all(finite(m) for m in history), history
        still = [n for n, p in params.items() if torch.equal(p.detach(), before[n])]
        assert not still, f"parameters that never moved: {still}"
        assert state.step == 2 + TRAIN_STEPS
        library, in_op = foreign_kernels_in_backwards(lambda: step(state, real))
    print(f"[train] library kernels under each backward {library}; others inside its op {in_op}")
    assert not library["fused_seed"], "cuBLAS or cuDNN kernels under FusedSeedBackward"
    assert not library["lis_residual_mlp"] and not in_op["lis_residual_mlp"], (
        "library or eager kernels under LIS's backward")


def test_glis_fp32_steps_with_kernels_match_the_plain_versions():
    """2 fp32 G-LIS steps with kernels against 2 with plain versions, from
    the same params on the same real batch and z (`fp32_agreement_of`)."""
    cfg = FLAGSHIP
    tcfg = TrainGLISConfig(**{**dataclasses.asdict(cfg), "batch_size": BATCH, "gan_loss": "bce",
                              "dtype": "float32"})
    g_params, d_params = init_generator_params(cfg, 0), init_discriminator_params(cfg, 1)
    real = real_batch(cfg)
    zs = fp32_codes(3, cfg.code_size)
    fp32_agreement_of("train", lambda use_kernels: two_fp32_steps(
        lambda: create_glis_state(tcfg, g_params, d_params, use_kernels=use_kernels),
        build_glis_train_step(tcfg), named_params, [(real, z) for z in zs]), tcfg.lr)


@pytest.mark.parametrize("tag", ["g-lis", "r-separate", "r-iterative"])
def test_graphed_replays_launch_what_eager_steps_launch(tag, tmp_path):
    with cudnn_tf32():
        eager_vs_graphed(tag, graph_trainers()[tag], str(tmp_path))


FP32_CHUNKS = ["g-lis golden", "g-lis cosine, g_ema, grad_accum 2, remat", "g-lis wgan-gp",
               "r-separate", "r-iterative"]


@pytest.mark.parametrize("tag", FP32_CHUNKS)
def test_graphed_fp32_chunk_agrees_with_eager_steps(tag):
    """G-LIS on the step golden's recipe (its config, params, real batch
    and `gea`'s draws, batch 4); then at the same width and batch 64, from
    seeded params: G-LIS under a cosine schedule whose second lr is half
    the first, with --g_ema, --grad_accum 2 and --remat; G-LIS with
    WGAN-GP's double backward (both drawing their own noise); R-separate
    and R-iterative from numpy draws (`chunk_agreement`)."""
    cfg = TrainGLISConfig(**{**dataclasses.asdict(FLAGSHIP), "dtype": "float32",
                             "batch_size": 4, "dataset": "synthetic"})
    g_params, d_params = init_generator_params(cfg, 0), init_discriminator_params(cfg, 1)
    if tag == "g-lis golden":
        golden = json.loads((TESTS / "torch_port_step_golden.json").read_text())
        real = torch.from_numpy(np.random.default_rng(3).uniform(
            -1, 1, (4, 80, 80, 3)).astype(np.float32)).cuda()
        z = torch.from_numpy(np.load(TESTS / "torch_port_step_draws.npz")["z"]).cuda()
        chunk_agreement(tag, cfg, lambda c: create_glis_state(c, g_params, d_params),
                        build_glis_train_step, real,
                        [{"z": z[i], "spatial_noise": None, "gp_eps": None} for i in range(2)],
                        golden)
        return
    wide = {**dataclasses.asdict(FLAGSHIP), "dtype": "float32", "batch_size": BATCH}
    glis = TrainGLISConfig(**{**wide, "dataset": "synthetic"})
    if tag.startswith("g-lis"):
        vcfg = (glis.replace(lr_schedule="cosine", niter=2, lr_final=0.0, g_ema=0.999,
                             grad_accum=2, remat=True)
                if "cosine" in tag else glis.replace(gan_loss="wgan-gp"))
        chunk_agreement(tag, vcfg, lambda c: create_glis_state(c, g_params, d_params),
                        build_glis_train_step, real_batch(vcfg), None)
        return
    rng = np.random.default_rng(11)
    draws = [{"z": torch.from_numpy(rng.standard_normal((BATCH, cfg.code_size)).astype(
        np.float32)).cuda(), "spatial_noise": None} for _ in range(2)]
    if tag == "r-separate":
        rsep = TrainRSeparateConfig(**wide)
        g = generator_from_jax_params(g_params, rsep)
        d = discriminator_from_jax_params(d_params, rsep)
        chunk_agreement(tag, rsep, lambda c: create_r_state(c, g, d), build_r_separate_step,
                        None, draws)
    else:
        riter = TrainRIterativeConfig(**{**wide, "r_chain_length": 2})
        chunk_agreement(tag, riter, create_r_iterative_state, build_r_iterative_step,
                        real_batch(riter), draws)


def test_graphed_clis(tmp_path):
    """The three CLIs at --steps_per_dispatch 8 with exact launches
    (replays counted): G-LIS 40 steps with saves and renders at the chunk
    ends that cross 20 and 40 (24, 40) and a bitwise round trip; 43 steps
    (a ragged tail of 3) and a relaunch resuming at 43 to 60; R-separate
    against that run and R-iterative, 40 steps each."""
    k8 = ["--steps_per_dispatch", str(GRAPH_K)]
    run = str(tmp_path / "run_k8")
    args = TRAINER_ARGS + k8 + ["--save_path", run, "--vis_interval", str(TRAINER_VIS),
                                "--save_interval", str(TRAINER_VIS)]
    cfg = TrainGLISConfig.from_args(args)
    per_step, per_render = glis_launches(cfg)
    with cudnn_tf32():
        state, stats, _, _ = counted_run("train_glis K=8, 40 steps and 2 renders", train_glis,
                                         args + ["--niter", str(TRAINER_STEPS)],
                                         launches(per_step, TRAINER_STEPS, per_render, 2))
        saved = sorted(int(s) for s in os.listdir(os.path.join(run, "checkpoints")))
        grids = sorted(os.listdir(os.path.join(run, "samples")))
        want_grids = [f"samples_{s:08d}_stage{i}.png" for s in (24, 40)
                      for i in range(cfg.n_stages)]
        assert saved == [24, 40] and grids == want_grids, (saved, grids)
        round_trip(run, TRAINER_STEPS, state, create_glis_state(cfg))
        del state

        tail = str(tmp_path / "run_k8_tail")
        tail_args = TRAINER_ARGS + k8 + ["--save_path", tail, "--vis_interval", "0",
                                         "--save_interval", "0"]
        counted_run("train_glis K=8, 43 steps (tail of 3)", train_glis,
                    tail_args + ["--niter", "43"], launches(per_step, 43, per_render, 0))
        state, stats, text, _ = counted_run(
            "train_glis K=8 relaunch at 43 to 60", train_glis, tail_args + ["--niter", "60"],
            launches(per_step, 17, per_render, 0))
        line = f"resumed from {tail} at step 43"
        assert line in text and state.step == 60, (line, state.step)
        del state

        rsep_args = ["--g_path", run, "--batch_size", str(BATCH), "--log_interval", "10",
                     "--save_path", str(tmp_path / "rsep_k8"), "--vis_interval",
                     str(TRAINER_VIS), "--save_interval", str(TRAINER_VIS), *k8]
        r_step, r_render = r_separate_launches(r_separate_config(run, rsep_args))
        counted_run("train_r_separate K=8, 40 steps and 2 renders", train_r_separate,
                    rsep_args + ["--niter", str(TRAINER_STEPS)],
                    launches(r_step, TRAINER_STEPS, r_render, 2))

        riter_args = TRAINER_ARGS + k8 + RITER_ARGS + [
            "--save_path", str(tmp_path / "riter_k8"), "--vis_interval", str(TRAINER_VIS),
            "--save_interval", str(TRAINER_VIS)]
        r_step, r_render = r_iterative_launches(TrainRIterativeConfig.from_args(riter_args))
        counted_run("train_r_iterative K=8, 40 steps and 2 renders", train_r_iterative,
                    riter_args + ["--niter", str(TRAINER_STEPS)],
                    launches(r_step, TRAINER_STEPS, r_render, 2))


def test_debug_checks_profile_dir_and_tensorboard(tmp_path):
    """Short G-LIS runs at full width: --debug_checks with K=2 (clean, then
    with a NaN in the input of iter 3, which must raise naming the op and
    the step), --profile_dir (one trace of steps 9-16), --tensorboard
    (files, or the line that says it is disabled)."""
    base = TRAINER_ARGS + ["--vis_interval", "0", "--save_interval", "0"]
    with cudnn_tf32():
        state, stats, _ = run_cli(base + ["--save_path", str(tmp_path / "debug"), "--niter", "4",
                                          "--steps_per_dispatch", "2", "--debug_checks"])
        assert state.step == 4 and finite(stats["metrics"]), (state.step, stats["metrics"])
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
            with pytest.raises(FloatingPointError) as raised:
                run_cli(base + ["--save_path", str(tmp_path / "debug_nan"), "--niter", "4",
                                "--steps_per_dispatch", "2", "--debug_checks"])
        finally:
            train_glis.make_input_fn = make
        msg = str(raised.value)
        assert "step 1 of 2" in msg and "(iter 3)" in msg and "aten." in msg, msg
        prof = tmp_path / "prof"
        run_cli(base + ["--save_path", str(tmp_path / "prof_run"), "--niter", "16",
                        "--steps_per_dispatch", str(GRAPH_K), "--profile_dir", str(prof)])
        assert os.listdir(prof) == ["trace_9-16.json"], os.listdir(prof)
        _, _, text = run_cli(base + ["--save_path", str(tmp_path / "tb_run"), "--niter", "16",
                                     "--steps_per_dispatch", str(GRAPH_K), "--tensorboard"])
    tb = tmp_path / "tb_run" / "tb"
    files = os.listdir(tb) if tb.is_dir() else []
    assert files or "[gea_torch] tensorboard disabled (" in text, (
        "--tensorboard wrote nothing and said nothing")
