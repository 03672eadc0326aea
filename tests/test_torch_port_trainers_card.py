"""The trainers, evaluation, samplers, export and serving on the card, at
flagship width (80x80, code 256, 3 LIS links, nf 64 / cap 512, bf16, batch
64, BCE), each CLI called in-process with the kernel launch counters zeroed
just before it and read just after: every run must launch exactly its
steps' and renders' kernels. `train_glis` 40 steps with its artifacts,
bitwise checkpoint round trips, a relaunch from 40 to 60 and its other
input paths; R-separate against that run as its frozen G and D, and
R-iterative, each with R's gradients, a round trip, the launches of the
options that change them, a relaunch and 2 fp32 steps with kernels
against 2 with plain versions; both feature networks against
`tests/torch_port_fid_golden.json`, the trainers with `--fid_interval` and
the offline evaluators; the demo JPEGs against their manifest, a run on
them, every sampler, `info`, the convert round trip and the fp32 render
against `tests/torch_port_render_golden.json`; every export against the
live render, on the card and on the CPU, `python -m gea_torch.serve` and
`serve_http` under 16 client threads. Needs an NVIDIA card and skips
without one; imports no JAX, so on the card it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_trainers_card.py
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_card_cases import card  # noqa: F401 -- the session fixture
from torch_port_card_runs import (
    BATCH,
    DEMO_SPOTS,
    RITER_ARGS,
    TRAINER_ARGS,
    TRAINER_STEPS,
    TRAINER_VIS,
    Tee,
    check_artifacts,
    check_trained,
    counted,
    counted_run,
    cudnn_tf32,
    demo_folder,
    finite,
    fp32_agreement_of,
    fp32_codes,
    glis_launches,
    http_post,
    launches,
    named_params,
    r_iterative_launches,
    r_separate_config,
    r_separate_launches,
    real_batch,
    relaunch,
    round_trip,
    times,
    two_fp32_steps,
)

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
from gea_torch.eval import fid
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.state import generator_config
from gea_torch.utils.checkpoint import (
    best_record,
    record_best_step,
    restore_checkpoint,
    save_checkpoint,
)

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]
REPO = Path(__file__).resolve().parents[1]
JPEGS = 256  # a folder of 218 x 178 JPEGs, CelebA's aligned size
BARE_STEPS = 12  # 2 warm-up steps and 10 more, each with finite metrics
FID_STEPS, FID_INTERVAL, FID_SAMPLES, EVAL_SAMPLES = 20, 10, 1024, 2048
FEATURE_BATCH = 64
IMAGE_STEPS, IMAGE_FID_INTERVAL = 40, 20
GOLDEN_TOL = 1e-4  # fp32 without TF32, with the kernels; the CPU holds 1e-5
COUNT, HTTP_CLIENTS, HTTP_REQUESTS = 64, 16, 8


@pytest.fixture(scope="module")
def work(card, tmp_path_factory) -> Path:  # noqa: F811
    return tmp_path_factory.mktemp("trainers")


# ------------------------------------------------------------------- G-LIS


@pytest.fixture(scope="module")
def glis(work) -> dict:
    """`train_glis` 40 steps with renders and saves at 20 and 40, exactly
    40 steps' and 2 renders' launches; its run directory is the frozen G
    of R-separate and the evaluators'."""
    run = str(work / "run")
    args = TRAINER_ARGS + ["--save_path", run, "--vis_interval", str(TRAINER_VIS),
                           "--save_interval", str(TRAINER_VIS)]
    cfg = TrainGLISConfig.from_args(args)
    per_step, per_render = glis_launches(cfg)
    with cudnn_tf32():
        state, _, _, _ = counted_run(
            "train_glis, 40 steps and 2 renders", train_glis,
            args + ["--niter", str(TRAINER_STEPS)],
            launches(per_step, TRAINER_STEPS, per_render, TRAINER_STEPS // TRAINER_VIS))
    return {"run": run, "args": args, "cfg": cfg, "state": state, "per_step": per_step,
            "per_render": per_render}


def test_glis_artifacts_and_checkpoint_round_trips(glis, work):
    """The run directory's config, checkpoints and per-stage grids; the
    checkpoint of step 40 restored into a fresh state equals the trained
    state bit for bit, as does a state with an EMA shadow and a cosine
    schedule after 2 steps."""
    cfg, state = glis["cfg"], glis["state"]
    assert state.step == TRAINER_STEPS
    check_artifacts("train_glis", glis["run"], cfg.n_stages)
    with cudnn_tf32():
        round_trip(glis["run"], TRAINER_STEPS, state, create_glis_state(cfg))
        ema_cfg = cfg.replace(g_ema=0.999, lr_schedule="cosine", niter=100)
        ema_state = create_glis_state(ema_cfg)
        ema_step = build_glis_train_step(ema_cfg)
        for _ in range(2):
            ema_step(ema_state, real_batch(ema_cfg))
        save_checkpoint(str(work / "ema"), ema_state.step, ema_state)
        round_trip(str(work / "ema"), ema_state.step, ema_state, create_glis_state(ema_cfg))


def test_glis_relaunch_resumes_at_40(glis):
    with cudnn_tf32():
        relaunch("train_glis", train_glis, glis["args"], glis["run"], glis["per_step"],
                 glis["per_render"])


def write_jpegs(root: Path) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:218, 0:178].astype(np.float32)
    for i in range(JPEGS):
        f = rng.uniform(0.01, 0.1, 3)
        img = 127.5 + 100 * np.sin(yy[..., None] * f + xx[..., None] * f[::-1])
        img += rng.normal(0, 10, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / f"{i:06d}.jpg", quality=90)


@pytest.fixture(scope="module")
def jpegs(work) -> str:
    root = work / "jpegs"
    root.mkdir()
    write_jpegs(root)
    return str(root)


INPUT_PATHS = {
    "synthetic on device, no renders or saves before the end": [],
    "synthetic streamed from the host": ["--synthetic_on_device", "false"],
    "synthetic, host preprocess": ["--synthetic_on_device", "false",
                                   "--on_device_pipeline", "false"],
    "JPEG folder, --data_cache": ["--dataset", "folder", "--data_cache", "true"],
    "JPEG folder, --device_data_cache": ["--dataset", "folder", "--device_data_cache", "true"],
}


@pytest.mark.parametrize("label", list(INPUT_PATHS))
def test_glis_input_paths(label, work, jpegs):
    """40 steps of each other input path, exactly 40 steps' launches."""
    extra = INPUT_PATHS[label] + (["--dataroot", jpegs] if "JPEG" in label else [])
    args = TRAINER_ARGS + extra + [
        "--save_path", str(work / f"path{list(INPUT_PATHS).index(label)}"),
        "--niter", str(TRAINER_STEPS), "--vis_interval", "0", "--save_interval", "0"]
    per_step, per_render = glis_launches(TrainGLISConfig.from_args(args))
    with cudnn_tf32():
        counted_run(label, train_glis, args, launches(per_step, TRAINER_STEPS, per_render, 0))


# -------------------------------------------------------------- R trainers


def bare_steps(label: str, run_step) -> None:
    metrics = [{k: v.item() for k, v in run_step().items()} for _ in range(BARE_STEPS)]
    assert all(finite(m) for m in metrics), f"{label}: non-finite metrics {metrics}"


@pytest.fixture(scope="module")
def rsep(glis, work) -> dict:
    """`train_r_separate` against the G-LIS run: 40 steps with renders and
    saves at 20 and 40, exactly 40 steps' and 2 corrected renders'
    launches."""
    run = str(work / "rsep")
    args = ["--g_path", glis["run"], "--batch_size", str(BATCH), "--log_interval", "10",
            "--save_path", run, "--vis_interval", str(TRAINER_VIS),
            "--save_interval", str(TRAINER_VIS)]
    cfg = r_separate_config(glis["run"], args)
    per_step, per_render = r_separate_launches(cfg)
    with cudnn_tf32():
        state, _, _, _ = counted_run(
            "train_r_separate, 40 steps and 2 renders", train_r_separate,
            args + ["--niter", str(TRAINER_STEPS)],
            launches(per_step, TRAINER_STEPS, per_render, TRAINER_STEPS // TRAINER_VIS))
    return {"run": run, "args": args, "cfg": cfg, "state": state, "per_step": per_step,
            "per_render": per_render, "g_run": glis["run"]}


def test_r_separate_trains_r_against_the_frozen_g_and_d(rsep):
    """The run directory's artifacts; every parameter of R got a finite
    non-zero gradient and moved; the frozen G and D are unchanged bit for
    bit and hold no gradient; a bitwise checkpoint round trip."""
    cfg, state, g_run = rsep["cfg"], rsep["state"], rsep["g_run"]
    check_artifacts("train_r_separate", rsep["run"], 2)
    assert state.step == TRAINER_STEPS and state.discriminator is not None
    with cudnn_tf32():
        fresh_g, _ = load_generator(g_run)
        fresh_d = load_discriminator(g_run)
        fresh = create_r_state(cfg, fresh_g, fresh_d)
        check_trained("train_r_separate", state,
                      {n: p.detach().clone() for n, p in named_params(fresh).items()})
        changed = [f"{i}.{k}" for i, (live, ref) in
                   enumerate(((state.generator, fresh_g), (state.discriminator, fresh_d)))
                   for k, v in live.state_dict().items() if not torch.equal(v, ref.state_dict()[k])]
        with_grad = [n for m in (state.generator, state.discriminator)
                     for n, p in m.named_parameters() if p.requires_grad or p.grad is not None]
        assert not changed and not with_grad, (changed, with_grad)
        round_trip(rsep["run"], TRAINER_STEPS, state, fresh)


def test_r_separate_steps_and_the_options_that_change_their_launches(rsep):
    """12 bare steps with finite metrics; one step with --remat (it renders
    the corrected code and scores it again in the backward) and one with
    --r_mine_weight 0.5 (D scores the frozen render), exact launches."""
    cfg, state, per_step = rsep["cfg"], rsep["state"], rsep["per_step"]
    acts = generator_plan(cfg.image_size)[1] - 1
    remat = {**per_step, "fused_tprelu": per_step["fused_tprelu"] + 2 * acts,
             "lis_residual_mlp": 3 * cfg.r_iterations, "fused_seed": 3}
    mining = {**per_step, "fused_tprelu": per_step["fused_tprelu"] + acts}
    with cudnn_tf32():
        step = build_r_separate_step(cfg)
        bare_steps("train_r_separate", lambda: step(state))
        counted("--remat", lambda: build_r_separate_step(cfg.replace(remat=True))(state), remat)
        counted("--r_mine_weight 0.5",
                lambda: build_r_separate_step(cfg.replace(r_mine_weight=0.5))(state), mining)


def test_r_separate_relaunch_resumes_at_40(rsep):
    with cudnn_tf32():
        relaunch("train_r_separate", train_r_separate, rsep["args"], rsep["run"],
                 rsep["per_step"], rsep["per_render"])


def test_r_separate_fp32_steps_with_kernels_match_the_plain_versions(rsep):
    cfg32 = rsep["cfg"].replace(dtype="float32")
    params = (init_generator_params(cfg32, 0), init_discriminator_params(cfg32, 1),
              init_reverter_params(cfg32, 2))
    zs = fp32_codes(4, cfg32.code_size)

    def make(use_kernels):
        g = generator_from_jax_params(params[0], cfg32, use_kernels=use_kernels)
        d = discriminator_from_jax_params(params[1], cfg32, use_kernels=use_kernels)
        return create_r_state(cfg32, g, d, params[2], use_kernels=use_kernels)

    fp32_agreement_of("r-separate", lambda use_kernels: two_fp32_steps(
        lambda: make(use_kernels), build_r_separate_step(cfg32), named_params,
        [(None, z) for z in zs]), cfg32.lr)


@pytest.fixture(scope="module")
def riter(work) -> dict:
    """`train_r_iterative` at --r_chain_length 2 --lambda_r 0.9: 40 steps
    with renders and saves at 20 and 40, exactly 40 steps' and 2 unrolls'
    launches."""
    run = str(work / "riter")
    args = TRAINER_ARGS + RITER_ARGS + ["--save_path", run, "--vis_interval", str(TRAINER_VIS),
                                        "--save_interval", str(TRAINER_VIS)]
    cfg = TrainRIterativeConfig.from_args(args)
    per_step, per_render = r_iterative_launches(cfg)
    with cudnn_tf32():
        state, _, _, _ = counted_run(
            "train_r_iterative, 40 steps and 2 renders", train_r_iterative,
            args + ["--niter", str(TRAINER_STEPS)],
            launches(per_step, TRAINER_STEPS, per_render, TRAINER_STEPS // TRAINER_VIS))
    return {"run": run, "args": args, "cfg": cfg, "state": state, "per_step": per_step,
            "per_render": per_render}


def test_r_iterative_trains_g_d_and_r(riter):
    cfg, state = riter["cfg"], riter["state"]
    check_artifacts("train_r_iterative", riter["run"], cfg.r_chain_length + 1)
    assert state.step == TRAINER_STEPS and not state.generator.lis
    with cudnn_tf32():
        fresh = create_r_iterative_state(cfg)
        check_trained("train_r_iterative", state,
                      {n: p.detach().clone() for n, p in named_params(fresh).items()})
        round_trip(riter["run"], TRAINER_STEPS, state, fresh)


def test_r_iterative_steps_and_remat_launches(riter):
    """12 bare steps with finite metrics; one step with --remat (the joint
    unroll's first render and its links run again in the backward), exact
    launches."""
    cfg, state, per_step = riter["cfg"], riter["state"], riter["per_step"]
    chain, links = riter["per_render"]["fused_tprelu"], cfg.r_chain_length
    remat = {**per_step, "fused_tprelu": per_step["fused_tprelu"] + chain,
             "fused_seed": per_step["fused_seed"] + links + 1}
    with cudnn_tf32():
        step, real = build_r_iterative_step(cfg), real_batch(cfg)
        bare_steps("train_r_iterative", lambda: step(state, real))
        counted("--remat", lambda: build_r_iterative_step(cfg.replace(remat=True))(state, real),
                remat)


def test_r_iterative_relaunch_resumes_at_40(riter):
    with cudnn_tf32():
        relaunch("train_r_iterative", train_r_iterative, riter["args"], riter["run"],
                 riter["per_step"], riter["per_render"])


def test_r_iterative_fp32_steps_with_kernels_match_the_plain_versions(riter):
    cfg32 = riter["cfg"].replace(dtype="float32")
    params = (init_generator_params(generator_config(cfg32), 0),
              init_discriminator_params(cfg32, 1), init_reverter_params(cfg32, 2))
    zs = fp32_codes(5, cfg32.code_size)
    real = real_batch(cfg32)
    fp32_agreement_of("r-iterative", lambda use_kernels: two_fp32_steps(
        lambda: create_r_iterative_state(cfg32, *params, use_kernels=use_kernels),
        build_r_iterative_step(cfg32), named_params, [(real, z) for z in zs]), cfg32.lr)


# --------------------------------------------------------------- evaluation


def test_feature_extractors_match_the_golden():
    """Both feature networks on the card against the golden written from
    `gea` (`tests/test_torch_port_fid.py --write`): feature means and
    covariance trace within rtol 1e-4 (on the mean, of the largest
    magnitude), the proxy-FID between the two halves within rtol 1e-3.
    Run with TF32 allowed, as the trainers run: the extractor must turn it
    off itself."""
    golden = json.loads((REPO / "tests" / "torch_port_fid_golden.json").read_text())
    recipe = golden["images"]
    halves = [torch.from_numpy(np.clip(np.random.default_rng(h["seed"]).normal(
        h["shift"], h["scale"], (h["count"], recipe["size"], recipe["size"], 3)), -1, 1).astype(
        np.float32)).cuda() for h in recipe["halves"]]
    with cudnn_tf32():
        for name in fid.EXTRACTORS:
            extract, label = fid.make_feature_extractor(recipe["size"], name)
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
            trace_err = abs(float(np.trace(stats[0].cov)) / want["cov_trace"] - 1)
            fid_halves = fid.frechet_distance(stats[1].mean, stats[1].cov, stats[2].mean,
                                              stats[2].cov)
            fid_err = abs(fid_halves / want["fid_halves"] - 1)
            print(f"[eval] {label}: means {mean_err:.2e}, covariance trace {trace_err:.2e}, "
                  f"proxy-FID of the halves {fid_err:.2e}")
            assert mean_err <= 1e-4 and trace_err <= 1e-4 and fid_err <= 1e-3, (
                name, mean_err, trace_err, fid_err)


def fid_rows(run: str) -> list:
    with open(os.path.join(run, "fid.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def tracked(glis, work):
    """name -> (state, run directory, its launches a render, its tracker
    and a fresh state) of each trainer's 20 steps with --fid_interval 10
    --fid_samples 1024, run once, after 20 steps without: both with exact
    launches (the steps' and 2 evaluations of 16 renders)."""
    g_run = glis["run"]
    renders = -(-FID_SAMPLES // BATCH)  # per evaluation
    r_args = ["--g_path", g_run, "--batch_size", str(BATCH), "--log_interval", "10"]
    track_args = ["--fid_interval", str(FID_INTERVAL), "--fid_samples", str(FID_SAMPLES)]
    glis_cfg = TrainGLISConfig.from_args(TRAINER_ARGS + track_args)
    rsep_cfg = r_separate_config(g_run, r_args + track_args)
    it_args = TRAINER_ARGS + RITER_ARGS
    it_cfg = TrainRIterativeConfig.from_args(it_args + track_args)
    g_cfg = TrainGLISConfig.load(os.path.join(g_run, "config.json"))
    trainers = {
        "train_glis": (train_glis, TRAINER_ARGS, glis_launches(glis_cfg),
                       lambda s: create_glis_state(glis_cfg),
                       lambda s: train_glis.make_fid_fn(glis_cfg, s.device)),
        "train_r_separate": (train_r_separate, r_args, r_separate_launches(rsep_cfg),
                             lambda s: create_r_state(rsep_cfg, s.generator, s.discriminator),
                             lambda s: train_r_separate.make_fid_fn(rsep_cfg, g_cfg, s.generator)),
        "train_r_iterative": (train_r_iterative, it_args, r_iterative_launches(it_cfg),
                              lambda s: create_r_iterative_state(it_cfg),
                              lambda s: train_r_iterative.make_fid_fn(it_cfg, s.device)),
    }
    done = {}

    def get(name):
        if name not in done:
            cli, args, (per_step, per_render), fresh, make_fid = trainers[name]
            common = args + ["--niter", str(FID_STEPS), "--vis_interval", "0",
                             "--save_interval", str(FID_STEPS)]
            run = str(work / f"{name}_fid")
            with cudnn_tf32():
                counted_run(f"{name}, {FID_STEPS} steps without --fid_interval", cli,
                            common + ["--save_path", str(work / f"{name}_plain")],
                            launches(per_step, FID_STEPS, per_render, 0))
                state, _, _, _ = counted_run(
                    f"{name}, {FID_STEPS} steps with --fid_interval {FID_INTERVAL}", cli,
                    common + ["--save_path", run] + track_args,
                    launches(per_step, FID_STEPS, per_render, 2 * renders))
            done[name] = (state, run, per_render, make_fid, fresh)
        return done[name]

    return get


@pytest.mark.parametrize("name", ["train_glis", "train_r_separate", "train_r_iterative"])
def test_trainer_tracks_fid(name, tracked):
    """fid.jsonl has an evaluation at 10 and at 20, both finite; best.json
    names the best one's checkpoint, which restores; one evaluation
    outside the loop launches 16 renders' kernels and is finite."""
    state, run, per_render, make_fid, fresh = tracked(name)
    rows = fid_rows(run)
    best = best_record(run)
    assert [r["step"] for r in rows] == [FID_INTERVAL, FID_STEPS], rows
    assert all(np.isfinite(r["fid"]) for r in rows), rows
    assert best is not None and best["metric"] == min(r["fid"] for r in rows), best
    assert restore_checkpoint(run, fresh(state), step=-1).step == best["step"]
    with cudnn_tf32():
        fid_fn = make_fid(state)
        fid_fn(state)
        value = []
        counted(f"{name} one evaluation", lambda: value.append(fid_fn(state)),
                times(per_render, -(-FID_SAMPLES // BATCH)))
    assert np.isfinite(value[0])


def finite_numbers(obj) -> bool:
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or np.isfinite(obj)


EVAL_CLIS = ["compute_fid", "compute_fid --d_filter", "compute_fid --r_path",
             "compute_fid --second_opinion", "compute_fid --step -1", "eval_stages", "eval_chain"]


@pytest.mark.parametrize("label", EVAL_CLIS)
def test_offline_evaluator(label, glis, rsep, riter, tracked):
    """Each evaluator on the trainers' run directories (and the tracked
    G-LIS run for --step -1), 2048 samples in batches of 64, with exact
    launches and finite values."""
    g_run, r_run, it_run = glis["run"], rsep["run"], riter["run"]
    glis_cfg = TrainGLISConfig.load(os.path.join(g_run, "config.json"))
    rsep_cfg = TrainRSeparateConfig.load(os.path.join(r_run, "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(it_run, "config.json"))
    acts = generator_plan(glis_cfg.image_size)[1] - 1  # TPReLUs of D's trunk
    _, render = glis_launches(glis_cfg)
    _, pair = r_separate_launches(rsep_cfg)
    _, chain = r_iterative_launches(it_cfg)
    scored = {**render, "fused_tprelu": render["fused_tprelu"] + acts}
    fid_args = ["--load_path", g_run, "--dataset", "synthetic"]
    runs = {
        "compute_fid": (compute_fid, fid_args, render),
        "compute_fid --d_filter": (compute_fid, fid_args + ["--d_filter"], scored),
        "compute_fid --r_path": (compute_fid, fid_args + ["--r_path", r_run], pair),
        "compute_fid --second_opinion": (compute_fid, fid_args + ["--second_opinion"], render),
        "compute_fid --step -1": (compute_fid, ["--load_path", "", "--dataset", "synthetic",
                                                "--step", "-1"], render),
        "eval_stages": (eval_stages, ["--load_path", g_run], scored),
        "eval_chain": (eval_chain, ["--load_path", it_run],
                       {**chain, "fused_tprelu": chain["fused_tprelu"] + acts}),
    }
    cli, args, per_batch = runs[label]
    if label == "compute_fid --step -1":
        args[1] = tracked("train_glis")[1]
    result = []
    counted(label, lambda: result.append(cli.main(
        args + ["--num_samples", str(EVAL_SAMPLES), "--batch_size", str(BATCH)])),
        times(per_batch, -(-EVAL_SAMPLES // BATCH)))
    assert finite_numbers(result[0]), result[0]


# ---------------------------------------------------------------- samplers


def test_demo_data_matches_its_manifest(tmp_path_factory):
    """`make_demo_data` writes demo20k's first DEMO_COUNT images; where pillow
    and libjpeg are the manifest's, img00000.jpg and img01250.jpg have the
    manifest's sha256 (else the check cannot run, and says so)."""
    folder = demo_folder(tmp_path_factory)
    manifest = json.loads((REPO / "data" / "demo20k" / "MANIFEST.json").read_text())
    versions = make_demo_data.library_versions()
    equal = {}
    for name in DEMO_SPOTS:
        with open(os.path.join(folder, name), "rb") as f:
            equal[name] = (hashlib.sha256(f.read()).hexdigest()
                           == manifest["sha256_spot_check"][name])
    if all(versions[k] == manifest["versions"][k] for k in ("pillow", "libjpeg")):
        assert all(equal.values()), equal
    else:
        print(f"[samplers] the hash check did NOT run: pillow/libjpeg {versions} differ from the "
              f"manifest's {manifest['versions']} (equal anyway: {equal})")


@pytest.fixture(scope="module")
def demo_run(work, tmp_path_factory) -> str:
    """`train_glis` on the demo JPEGs, --data_cache --g_ema 0.999
    --fid_interval 20, 40 steps and a save at 40, exactly 40 steps' and 2
    evaluations' launches."""
    run = str(work / "demo_run")
    args = TRAINER_ARGS + [
        "--dataset", "folder", "--dataroot", demo_folder(tmp_path_factory),
        "--synthetic_on_device", "false", "--data_cache", "true", "--g_ema", "0.999",
        "--fid_interval", str(IMAGE_FID_INTERVAL), "--niter", str(IMAGE_STEPS),
        "--vis_interval", "0", "--save_interval", str(IMAGE_STEPS), "--save_path", run]
    cfg = TrainGLISConfig.from_args(args)
    per_step, per_render = glis_launches(cfg)
    with cudnn_tf32():
        _, stats, _, _ = counted_run(
            "train_glis on the demo images", train_glis, args,
            launches(per_step, IMAGE_STEPS, per_render, 2 * -(-cfg.fid_samples // BATCH)))
    rows = fid_rows(run)
    assert [r["step"] for r in rows] == [IMAGE_FID_INTERVAL, IMAGE_STEPS], rows
    assert all(np.isfinite(r["fid"]) for r in rows) and finite(stats["metrics"]), (
        rows, stats["metrics"])
    return run


def run_counted(module, args: list) -> tuple:
    """`module.main(args)` with the launch counters zeroed just before and
    read just after: (launch counts, printed text)."""
    tee = Tee(sys.stdout)
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(tee):
        module.main(args)
    torch.cuda.synchronize()
    return ops.launch_counts(), tee.buf.getvalue()


SAMPLERS = ["sample", "sample --d_filter", "sample --d_threshold 0.9999 (fill)",
            "sample --save_gif", "sample --use_ema", "sample --step -1",
            "sample --d_filter --d_filter_step -1", "sample_interpolations slerp",
            "sample_interpolations lerp", "sample_r_separate", "sample_r_iterative",
            "sample_r_iterative --chain_length 3"]


@pytest.mark.parametrize("label", SAMPLERS)
def test_sampler(label, demo_run, rsep, riter, work):
    """Every sampler on the demo run and the R trainers' runs, with exact
    launches; `--d_threshold` past every score fills with a notice."""
    r_run, it_run = rsep["run"], riter["run"]
    cfg = TrainGLISConfig.load(os.path.join(demo_run, "config.json"))
    rsep_cfg = TrainRSeparateConfig.load(os.path.join(r_run, "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(it_run, "config.json"))
    acts = generator_plan(cfg.image_size)[1] - 1  # TPReLUs of a render, of D's trunk
    _, render = glis_launches(cfg)
    scored = {**render, "fused_tprelu": render["fused_tprelu"] + acts}

    def correction(steps: int) -> dict:
        # steps + 1 renders and steps R calls (trunk + head) a batch.
        return {"fused_tprelu": (steps + 1) * acts + steps * (acts + 1),
                "fused_tprelu_backward": 0,
                "lis_residual_mlp": (steps + 1) * rsep_cfg.r_iterations,
                "lis_residual_mlp_backward": 0, "lis_chain_backward": 0, "fused_seed": steps + 1,
                "fused_seed_backward": 0}

    def chain(links: int) -> dict:
        return r_iterative_launches(it_cfg.replace(r_chain_length=links))[1]

    demo = ["--load_path", demo_run]
    threshold = ["--d_filter", "--d_threshold", "0.9999"]
    calls = {  # label -> (CLI, arguments, launches)
        "sample": (sample, demo + ["--count", "256"], times(render, 4)),
        "sample --d_filter": (sample, demo + ["--count", "256", "--d_filter"], times(scored, 4)),
        "sample --d_threshold 0.9999 (fill)": (
            sample, demo + ["--count", "64"] + threshold, times(scored, sample.THRESHOLD_ROUNDS)),
        "sample --save_gif": (sample, demo + ["--save_gif"], render),
        "sample --use_ema": (sample, demo + ["--use_ema"], render),
        "sample --step -1": (sample, demo + ["--step", "-1"], render),
        "sample --d_filter --d_filter_step -1": (
            sample, demo + ["--d_filter", "--d_filter_step", "-1"], scored),
        "sample_interpolations slerp": (sample_interpolations, demo, render),
        "sample_interpolations lerp": (sample_interpolations, demo + ["--interp_mode", "lerp"],
                                       render),
        "sample_r_separate": (sample_r_separate, ["--load_path", r_run], correction(2)),
        "sample_r_iterative": (sample_r_iterative, ["--load_path", it_run],
                               chain(it_cfg.r_chain_length)),
        "sample_r_iterative --chain_length 3": (
            sample_r_iterative, ["--load_path", it_run, "--chain_length", "3"], chain(3)),
    }
    cli, args, want = calls[label]
    counts, text = run_counted(cli, args + ["--save_path_samples",
                                            str(work / "samples" / str(SAMPLERS.index(label)))])
    assert counts == want, (counts, want)
    assert ("filling" in text) == ("fill" in label), text[-500:]


def test_info_counts_the_parameters_of_every_run(glis, rsep, riter, demo_run):
    """`info` on the four runs: the parameter counts of the modules each
    holds, with no kernel launched."""
    cfg = TrainGLISConfig.load(os.path.join(demo_run, "config.json"))
    rsep_cfg = TrainRSeparateConfig.load(os.path.join(rsep["run"], "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(riter["run"], "config.json"))

    def n_params(*modules):
        return sum(p.numel() for m in modules for p in m.parameters())

    it_g = generator_config(it_cfg)
    want_params = {
        demo_run: (n_params(GeneratorLIS(cfg)), n_params(Discriminator(cfg)), 0),
        glis["run"]: (n_params(GeneratorLIS(cfg)), n_params(Discriminator(cfg)), 0),
        rsep["run"]: (0, 0, n_params(Reverter(rsep_cfg))),
        riter["run"]: (n_params(GeneratorLIS(it_g)), n_params(Discriminator(it_cfg)),
                       n_params(Reverter(it_cfg))),
    }
    for run, want in want_params.items():
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = info.main(["--load_path", run])
        got = tuple(summary["params"][k] for k in ("params_g", "params_d", "params_r"))
        assert got == want and not any(ops.launch_counts().values()), (run, got, want)


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


@pytest.mark.parametrize("name", ["demo_run", "riter"])
def test_convert_round_trip_renders_the_same_images(name, demo_run, riter, work):
    """`convert_checkpoint` export, then `--from_torch` re-import: the run
    renders the same images bit for bit."""
    run, cli = (demo_run, sample) if name == "demo_run" else (riter["run"], sample_r_iterative)
    pt, back = str(work / f"{name}.pt"), str(work / f"{name}_imported")
    convert_checkpoint.main(["--load_path", run, "--out", pt])
    convert_checkpoint.main(["--from_torch", pt, "--out_run", back])
    a, b = (rendered(cli, ["--load_path", r, "--save_path_samples", str(work / "trip")])
            for r in (run, back))
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), (
        f"{name}: the re-imported run renders other images")


def test_fp32_render_matches_the_golden():
    """The flagship fp32 render and D's logits on the card, without TF32
    and with the kernels, against the golden written from `gea`
    (`tests/test_torch_port_samplers.py --write`) within GOLDEN_TOL, with a
    render's launches."""
    golden = json.loads((REPO / "tests" / "torch_port_render_golden.json").read_text())
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
            "lis_residual_mlp": cfg.r_iterations, "lis_residual_mlp_backward": 0,
            "lis_chain_backward": 0, "fused_seed": 1, "fused_seed_backward": 0}
    print(f"[samplers] fp32 render + D vs the golden: max |err| {errs} (tol {GOLDEN_TOL})")
    assert max(errs.values()) <= GOLDEN_TOL and counts == want, (errs, counts)


# ------------------------------------------------------- export and serving


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


EXPORTS = [f"{v} {dt}" for dt in ("bf16", "fp32") for v in (
    "all_stages with_scores", "step -1 use_ema", "batch 64", "r_path", "ri_path 2 links",
    "ri_path 3 links")]


@pytest.fixture(scope="module")
def exported(demo_run, rsep, riter, work):
    """label -> the artifact of one export, made once: `export_model` (with
    its selfcheck) in bf16 (the runs as trained) or fp32 (the same
    checkpoints under a float32 config) on the card; its render of 64 codes
    and its launches against the live render's of the same options."""
    r_cfg = TrainRSeparateConfig.load(os.path.join(rsep["run"], "config.json"))
    r_g_cfg = TrainGLISConfig.load(os.path.join(r_cfg.g_path, "config.json"))
    g_cfg = TrainGLISConfig.load(os.path.join(demo_run, "config.json"))
    it_cfg = TrainRIterativeConfig.load(os.path.join(riter["run"], "config.json"))
    assert it_cfg.r_chain_length == 2
    runs = {}
    done = {}

    def dirs(dt):
        if dt == "bf16":
            return demo_run, rsep["run"], riter["run"]
        if dt not in runs:
            g_fp32 = fp32_copy(r_cfg.g_path, str(work / "fp32_run"), TrainGLISConfig)
            runs[dt] = (
                fp32_copy(demo_run, str(work / "fp32_demo_run"), TrainGLISConfig),
                fp32_copy(rsep["run"], str(work / "fp32_rsep"), TrainRSeparateConfig,
                          g_path=g_fp32),
                fp32_copy(riter["run"], str(work / "fp32_riter"), TrainRIterativeConfig))
        return runs[dt]

    def get(label):
        if label in done:
            return done[label]
        variant, dt = label.rsplit(" ", 1)
        d, r, i = dirs(dt)
        args, want = {
            "all_stages with_scores": (["--load_path", d, "--all_stages", "1",
                                        "--with_scores", "1"], artifact_launches("glis", g_cfg)),
            "step -1 use_ema": (["--load_path", d, "--step", "-1", "--use_ema"],
                                artifact_launches("glis", g_cfg)),
            "batch 64": (["--load_path", d, "--batch", str(BATCH)],
                         artifact_launches("glis", g_cfg)),
            "r_path": (["--r_path", r], artifact_launches("r_path", r_g_cfg)),
            "ri_path 2 links": (["--ri_path", i], artifact_launches("ri_path", it_cfg, 2)),
            "ri_path 3 links": (["--ri_path", i, "--chain_links", "3"],
                                artifact_launches("ri_path", it_cfg, 3)),
        }[variant]
        out = str(work / "exports" / label.replace(" ", "_"))
        argv = args + ["--out", out, "--device", "cuda"]
        export_model.main(argv)
        model = serve.load(out, device="cuda")
        live = export_model.live_model(export_model.parse(argv))[0]
        z = np.random.default_rng(0).standard_normal((BATCH, model.code_size)).astype(np.float32)
        counts = {}
        for who, m in (("live", live), ("artifact", model)):
            m(z)  # warm: the first call of a program pays its set-up
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            counts[who] = (m(z), ops.launch_counts())
        done[label] = {"dir": out, "model": model, "bf16": dt == "bf16", "want": want,
                       "counts": counts}
        return done[label]

    return get


@pytest.mark.parametrize("label", EXPORTS)
def test_export_renders_what_the_live_model_renders(label, exported):
    """The artifact's launches equal the live render's and the path's; its
    images within 3 uint8 levels and 1% beyond 1 in bf16, 1 level and
    scores within 1e-5 in fp32; its scores finite."""
    art = exported(label)
    (want_out, live_counts), (got, art_counts) = art["counts"]["live"], art["counts"]["artifact"]
    assert art_counts == live_counts == art["want"], (art_counts, live_counts, art["want"])
    diff = np.abs(got["images"].astype(int) - want_out["images"].astype(int))
    frac = float((diff > 1).mean())
    score_err = float(np.abs(got["scores"] - want_out["scores"]).max()) if "scores" in got else 0.0
    print(f"[export] {label}: max uint8 diff {diff.max()}, {frac:.4%} beyond 1 level, scores max "
          f"|diff| {score_err:.3e}")
    ok = (diff.max() <= 3 and frac <= 0.01) if art["bf16"] else (diff.max() <= 1
                                                                 and score_err <= 1e-5)
    assert ok, f"{label}: the artifact's render differs from the live one"
    assert np.isfinite(got.get("scores", np.zeros(1))).all()


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
def test_artifact_written_on_the_card_renders_on_the_cpu(dt, exported):
    """The scored artifact loaded with device="cpu": a batch of 3 within
    the selfcheck's band of the card's render."""
    art = exported(f"all_stages with_scores {dt}")
    model = serve.load(art["dir"], device="cpu")
    bf16 = model.manifest["dtype"] == "bfloat16"
    z = np.random.default_rng(3).standard_normal((3, model.code_size)).astype(np.float32)
    got, want = model(z), art["model"](z)
    diff = np.abs(got["images"].astype(int) - want["images"].astype(int))
    assert diff.max() <= (3 if bf16 else 1) and float((diff > 1).mean()) <= 0.01, (
        "the artifact renders otherwise on the CPU")


def test_serve_cli_writes_sorted_scores(exported, work):
    """`python -m gea_torch.serve <artifact> --d_filter 1` in its own
    process writes samples.png and 64 scores, sorted."""
    out = str(work / "serve_cli")
    proc = subprocess.run([sys.executable, "-m", "gea_torch.serve",
                           exported("step -1 use_ema bf16")["dir"], "--d_filter", "1",
                           "--count", str(COUNT), "--out", out, "--device", "cuda"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    assert proc.returncode == 0 and files == ["samples.png", "scores.json"], proc.stderr[-2000:]
    with open(os.path.join(out, "scores.json")) as f:
        scores = json.load(f)
    assert len(scores) == COUNT and scores == sorted(scores, reverse=True), scores[:8]


def test_serve_http_answers_16_clients(exported):
    """serve_http on 127.0.0.1 (port 0): 16 client threads, each with 8
    {"count": 4} requests and one {"count": 16, "oversample": 4}; every
    response's images and scores, the filtered ones sorted; the server's
    count of requests and rendered rows."""
    import urllib.request

    server, batcher = serve_http.make_server(exported("step -1 use_ema bf16")["dir"],
                                             "127.0.0.1", 0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    answered, errors = [], []
    try:
        batcher.warmup()

        def client(i):
            try:
                for j in range(HTTP_REQUESTS + 1):
                    filtered = j == HTTP_REQUESTS
                    payload = ({"count": 16, "oversample": 4, "seed": i} if filtered
                               else {"count": 4, "seed": i * 100 + j})
                    status, body = http_post(base + "/render", payload)
                    n = payload["count"]
                    sc = body.get("scores", [])
                    if (status != 200 or len(body["images"]) != n or len(sc) != n
                            or not all(0 <= s <= 1 for s in sc)
                            or (filtered and (sc != sorted(sc, reverse=True)
                                              or body["filter"]["oversample"] != 4))):
                        raise AssertionError(f"bad response to {payload}: {status}")
                    answered.append(filtered)
            except Exception as e:  # reported after the join
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        batcher.close()
        thread.join(timeout=30)
    want = HTTP_CLIENTS * (HTTP_REQUESTS + 1)
    assert not errors and len(answered) == want and not any(t.is_alive() for t in threads), (
        len(answered), errors[:3])
    rows = HTTP_CLIENTS * (HTTP_REQUESTS * 4 + 16 * 4)  # a filtered request: one draw of 64
    assert stats["rows"] == rows and stats["requests"] == want, stats
