"""`--norm batch`, tensor parallelism, LSUN and grain on the card. The
batch-norm G-LIS step at flagship width (bf16, batch 64, BCE): 2 fp32
steps with kernels against 2 with plain versions under deterministic
algorithms, a step's launches (LIS 6, TPReLU 17, seed 0) and gradients,
the running statistics; the K = 8 dispatcher's warm-up putting back what
it changed, K = 8 replays against eager steps and a graphed fp32 K = 2
chunk; the three CLIs with --norm batch on the demo JPEGs, the native
loader's stream against an explicit one, `sample` and export from the
streamed run. Then the flagship TP step (--model_shards 2) on two ranks
sharing the card over gloo: launches, state kept against the single
process's, each kernel on each rank's own inputs against its plain
version, fp32 against the single process; --model_shards 2 refused on one
card; LSUN on the demo JPEGs as two classes; grain where it imports.
Needs an NVIDIA card and skips without one; imports no JAX, so on the card
it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_norm_tp_card.py
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch
from torch_port_card_cases import card  # noqa: F401 -- the session fixture
from torch_port_card_runs import (
    BATCH,
    BN_ARGS,
    FP32_TOL,
    GRAPH_K,
    STATS_TOL,
    TP_SHARDS,
    TP_TIMEOUT_S,
    TRAINER_ARGS,
    bn_fed,
    bn_launches,
    bn_state,
    chunk_agreement,
    counted_run,
    cudnn_tf32,
    demo_folder,
    deterministic,
    eager_vs_graphed,
    finite,
    fp32_agreement_of,
    fp32_codes,
    glis_launches,
    launches,
    named_params,
    named_unfed,
    real_batch,
    run_cli,
    running_stats,
    same,
    tp_rank,
    two_fp32_steps,
)

from gea_torch import ops, serve
from gea_torch.cli import export_model, sample, train_glis, train_r_iterative, train_r_separate
from gea_torch.cli.sample import load_discriminator, load_generator
from gea_torch.config import TrainGLISConfig, generator_plan
from gea_torch.data import native_build
from gea_torch.data.pipeline import list_images, make_dataset
from gea_torch.interop import init_discriminator_params, init_generator_params
from gea_torch.ops.layers import eval_mode
from gea_torch.parallel.mesh import free_port
from gea_torch.serve import ServingModel
from gea_torch.train import build_glis_train_step, create_glis_state
from gea_torch.train.dispatch import StepDispatcher
from gea_torch.train.runner import state_modules

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]
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
TRAIN_STEPS = 10
TP_STEPS = 10  # the LSUN and grain CLI runs
GRAIN_IMAGES = 320  # 5 batches of 64: one epoch of either stream


def test_batch_norm_fp32_steps_with_kernels_match_the_plain_versions():
    """2 fp32 batch-norm steps with kernels against 2 with plain versions
    under deterministic algorithms (`fp32_agreement_of` with BN_FP32_TOL,
    the biases that feed a batch norm left out of its gradient and
    parameter gates), and the running statistics within STATS_TOL, beside
    a second plain run, which must then agree bit for bit."""
    tcfg = TrainGLISConfig.from_args(BN_ARGS).replace(dtype="float32")
    g_params, d_params = init_generator_params(tcfg, 0), init_discriminator_params(tcfg, 1)
    real = real_batch(tcfg)
    zs = fp32_codes(3, tcfg.code_size)
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

    moved = apart(plain, {n: torch.zeros_like(t) if n.endswith(".mean") else torch.ones_like(t)
                          for n, t in plain.items()})
    print(f"[batch fp32] running statistics: kernels vs plain {apart(kernels, plain):.3e}, "
          f"plain vs plain {apart(again, plain):.3e}, moved by {moved:.3e}")
    assert apart(kernels, plain) <= STATS_TOL and moved > 10 * STATS_TOL
    assert apart(again, plain) == 0 and out["plain_vs_plain"]["params_abs"] == 0


def test_batch_norm_step_launches_gradients_and_statistics():
    """The first step launches LIS 6, TPReLU 17 and its backward 13, a
    chain backward and no seed, and gives every parameter a finite
    gradient, non-zero but for the conv biases that feed a batch norm; 10
    more steps launch 10 steps' kernels with finite metrics, and every
    running statistic moved, finite, the variances positive."""
    cfg = TrainGLISConfig.from_args(BN_ARGS)
    per_step, _ = bn_launches(cfg)
    state, step = bn_state(cfg), build_glis_train_step(cfg)
    real = real_batch(cfg)
    fed = bn_fed(state)
    ops.reset_launch_counts()
    step(state, real)
    assert ops.launch_counts() == per_step
    grads = {n: p.grad for n, p in named_params(state).items()}
    bad = [n for n, g in grads.items() if g is None or not torch.isfinite(g).all()
           or (n not in fed and not g.abs().max() > 0)]
    assert not bad, f"batch-norm step 1: no finite non-zero gradient for {bad}"
    step(state, real)
    stats0 = {n: t.clone() for n, t in running_stats(state).items()}
    ops.reset_launch_counts()
    history = [{k: v.item() for k, v in step(state, real).items()} for _ in range(TRAIN_STEPS)]
    assert ops.launch_counts() == {k: TRAIN_STEPS * v for k, v in per_step.items()}
    stats = running_stats(state)
    unmoved = [n for n, t in stats.items() if torch.equal(t, stats0[n])]
    assert not unmoved and all(finite(m) for m in history), (unmoved, history[-1])
    assert all(bool(torch.isfinite(t).all()) for t in stats.values())
    assert all(bool((t > 0).all()) for n, t in stats.items() if n.endswith(".var"))


def test_batch_norm_warm_up_puts_back_what_it_changed():
    """The K = 8 dispatcher's warm-up step leaves G and D as they were, bit
    for bit: parameters and running statistics (Adam's state, which the
    warm-up makes, starts at zeros as a fresh Adam's)."""
    cfg = TrainGLISConfig.from_args(BN_ARGS).replace(steps_per_dispatch=GRAPH_K)
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
    assert not diff, f"the warm-up changed {diff[:8]}"
    assert running_stats(state)


def test_batch_norm_graphed_replays_launch_what_eager_steps_launch(tmp_path):
    cfg = TrainGLISConfig.from_args(BN_ARGS)
    entry = (cfg.replace(steps_per_dispatch=GRAPH_K), bn_state, build_glis_train_step,
             bn_launches(cfg)[0], real_batch(cfg))
    with cudnn_tf32():
        eager_vs_graphed("g-lis batch norm", entry, str(tmp_path))


def test_batch_norm_graphed_fp32_chunk_agrees_with_eager_steps():
    cfg = TrainGLISConfig.from_args(BN_ARGS)
    fp32 = TrainGLISConfig(**{**dataclasses.asdict(cfg), "dtype": "float32"})
    chunk_agreement("g-lis batch norm", fp32, bn_state, build_glis_train_step,
                    real_batch(fp32), None, named=named_unfed)


@pytest.fixture(scope="module")
def bn_runs(card, tmp_path_factory):  # noqa: F811
    """train_glis --norm batch on the demo JPEGs with --data_backend auto,
    streamed and with --data_cache: 40 steps and 2 renders each with exact
    launches; which decoder auto chose, finite metrics, the checkpoint at
    40. label -> (run directory, state)."""
    folder = demo_folder(tmp_path_factory)
    tmp = tmp_path_factory.mktemp("batch_norm")
    cfg = TrainGLISConfig.from_args(BN_ARGS)
    per_step, per_render = bn_launches(cfg)
    want = launches(per_step, BN_STEPS, per_render, BN_STEPS // BN_VIS)
    folder_args = ["--dataset", "folder", "--dataroot", folder, "--synthetic_on_device", "false",
                   "--data_backend", "auto", "--niter", str(BN_STEPS), "--vis_interval",
                   str(BN_VIS), "--save_interval", str(BN_STEPS)]
    out = {"tmp": tmp, "folder": folder}
    for label, extra in (("streamed", []), ("data_cache", ["--data_cache", "true"])):
        run = str(tmp / f"bn_{label}")
        with cudnn_tf32():
            state, stats, text, _ = counted_run(
                f"train_glis --norm batch on the demo JPEGs ({label})", train_glis,
                BN_ARGS + folder_args + extra + ["--save_path", run], want)
        chose = [ln for ln in text.splitlines() if "decoded by" in ln]
        assert chose and finite(stats["metrics"]), (label, chose, stats["metrics"])
        assert os.path.isfile(os.path.join(run, "checkpoints", str(BN_STEPS), "state.pt"))
        out[label] = (run, state)
    return out


def test_batch_norm_r_trainers(bn_runs):
    """R-separate against the streamed batch-norm run, and R-iterative
    with --norm batch, 20 steps each with finite metrics."""
    tmp = bn_runs["tmp"]
    r_args = ["--batch_size", str(BATCH), "--niter", str(BN_R_STEPS), "--log_interval", "10",
              "--vis_interval", str(BN_R_STEPS), "--save_interval", str(BN_R_STEPS)]
    with cudnn_tf32():
        _, sep, _ = run_cli(r_args + ["--g_path", bn_runs["streamed"][0], "--save_path",
                                      str(tmp / "bn_rsep")], train_r_separate)
        _, it, _ = run_cli(BN_ARGS + r_args + ["--r_chain_length", "2", "--save_path",
                                               str(tmp / "bn_riter")], train_r_iterative)
    assert finite(sep["metrics"]) and finite(it["metrics"]), (sep["metrics"], it["metrics"])


def test_native_loader_stream_equals_auto(bn_runs):
    """Where g++ and libjpeg build the native loader, --data_backend auto's
    stream equals an explicit `native` one for 3 batches, byte for byte
    (else auto decodes with PIL, as `gea`'s does, and it says so)."""
    lib = native_build.load_library()
    cfg = TrainGLISConfig.from_args(BN_ARGS + ["--dataset", "folder", "--dataroot",
                                               bn_runs["folder"]])
    if lib is None:
        print("[batch] the native loader did not build on this host: auto decodes with PIL")
        return
    auto = make_dataset(cfg.replace(data_backend="auto"), seed=cfg.seed)
    explicit = make_dataset(cfg.replace(data_backend="native"), seed=cfg.seed)
    a, b = auto.batches(0), explicit.batches(0)
    try:
        assert all(np.array_equal(next(a), next(b)) for _ in range(3)), (
            "--data_backend auto and native streams differ")
    finally:
        auto.close()
        explicit.close()


def test_batch_norm_sample_export_and_evaluation(bn_runs):
    """`sample` from the streamed run launches a render's kernels; its
    export renders and scores 64 codes as the live eval-mode G and D do,
    bit for bit, with the same launches; one evaluation leaves the running
    statistics as they were, bit for bit, and the modules' modes put
    back."""
    run, state = bn_runs["streamed"]
    tmp = bn_runs["tmp"]
    cfg = TrainGLISConfig.load(os.path.join(run, "config.json"))
    _, per_render = bn_launches(cfg)
    ops.reset_launch_counts()
    sample.main(["--load_path", run, "--count", str(BATCH), "--batch_size", str(BATCH),
                 "--save_path_samples", str(tmp / "bn_samples")])
    assert ops.launch_counts() == per_render
    art = str(tmp / "bn_art")
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
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert got_n == want_n == scored, (got_n, want_n, scored)
    before = {k: v.clone() for k, v in running_stats(state).items()}
    modes = [m.training for mod in state_modules(state) for m in mod.modules()]
    fid_fn = train_glis.make_fid_fn(cfg.replace(fid_samples=BN_FID_SAMPLES), state.device)
    with eval_mode(*state_modules(state)):
        value = float(fid_fn(state))
    after = running_stats(state)
    assert all(torch.equal(after[n], t) for n, t in before.items())
    assert modes == [m.training for mod in state_modules(state) for m in mod.modules()]
    assert np.isfinite(value)


def test_tensor_parallel_step_on_two_ranks_sharing_the_card():
    """The flagship TP step (bf16, --g_ema 0.999, --model_shards 2) on two
    spawned ranks in a gloo group on cuda:0: each rank launches a G-LIS
    step's kernels, keeps fewer state bytes than the single process, and
    every kernel on its own inputs matches its plain version in bf16 and
    fp32; 2 fp32 TP steps agree with 2 single-process steps
    (`torch_port_card_runs.tp_rank_body`)."""
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
            assert time.perf_counter() - t0 <= TP_TIMEOUT_S, (
                f"the TP ranks did not end within {TP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    out = json.loads(results.get() if got is None else got)
    print(f"[tp] {out}")
    assert len(out["ranks"]) == TP_SHARDS


def test_model_shards_2_is_refused_on_one_card(tmp_path):
    """--model_shards 2 on one visible card raises `gea`'s SystemExit
    before anything runs."""
    want = f"--model_shards {TP_SHARDS} needs multiple devices (1 visible)"
    with pytest.raises(SystemExit) as raised:
        run_cli(TRAINER_ARGS + ["--model_shards", str(TP_SHARDS), "--niter", "1",
                                "--save_path", str(tmp_path / "tp_refused")])
    assert str(raised.value) == want


def linked_folder(root: str, paths: list) -> str:
    os.makedirs(root, exist_ok=True)
    for p in paths:
        os.symlink(p, os.path.join(root, os.path.basename(p)))
    return root


def folder_run(label: str, args: list, run: str) -> None:
    """TP_STEPS steps of train_glis on a folder dataset with exact
    launches (the steps' and one render's), a decoder named, finite
    metrics and the checkpoint."""
    cfg = TrainGLISConfig.from_args(TRAINER_ARGS)
    per_step, per_render = glis_launches(cfg)
    _, stats, text, _ = counted_run(
        label, train_glis, TRAINER_ARGS + args + [
            "--synthetic_on_device", "false", "--niter", str(TP_STEPS), "--vis_interval",
            str(TP_STEPS), "--save_interval", str(TP_STEPS), "--save_path", run],
        launches(per_step, TP_STEPS, per_render, 1))
    chose = [ln for ln in text.splitlines() if "decoded by" in ln]
    assert chose and finite(stats["metrics"]), (label, stats["metrics"], chose)
    assert os.path.isfile(os.path.join(run, "checkpoints", str(TP_STEPS), "state.pt"))


def test_lsun_classes_from_folders(tmp_path, tmp_path_factory):
    """The demo JPEGs as two LSUN class folders, train_glis --dataset lsun
    --lsun_classes on both; an LMDB-only class raises `gea`'s lmdb
    message where lmdb is missing, and leaves no export marker."""
    from gea_torch.data.lsun import resolve_lsun_root

    paths = list_images(demo_folder(tmp_path_factory))
    root = str(tmp_path / "lsun")
    half = len(paths) // 2
    linked_folder(os.path.join(root, "tower"), paths[:half])
    linked_folder(os.path.join(root, "church_outdoor"), paths[half:])
    folder_run("train_glis --dataset lsun --lsun_classes tower,church_outdoor",
               ["--dataset", "lsun", "--dataroot", root, "--lsun_classes",
                "tower,church_outdoor"], str(tmp_path / "tp_lsun"))
    os.makedirs(os.path.join(root, "bedroom_train_lmdb"))
    open(os.path.join(root, "bedroom_train_lmdb", "data.mdb"), "wb").close()
    have_lmdb = importlib.util.find_spec("lmdb") is not None
    with pytest.raises(Exception) as raised:  # noqa: B017 -- which error, is the check
        resolve_lsun_root(TrainGLISConfig(dataset="lsun", dataroot=root, lsun_classes="bedroom"))
    e = raised.value
    assert have_lmdb or (isinstance(e, RuntimeError) and "needs the 'lmdb' package" in str(e)), (
        f"the LMDB-only class without lmdb: {e!r}")
    assert not os.path.exists(os.path.join(root, "bedroom_train_images", ".complete")), (
        "a failed export left its marker")


def image_multiset(batches) -> list:
    return sorted(hashlib.sha256(img.tobytes()).hexdigest() for b in batches for img in b)


def test_grain_stream_or_its_refusal(tmp_path, tmp_path_factory):
    """Where grain imports: train_glis --data_backend grain on 320 demo
    JPEGs, and its first epoch equal to the PIL stream's as a multiset.
    Where it does not: --data_backend grain raises ImportError."""
    folder = demo_folder(tmp_path_factory)
    try:
        import grain  # noqa: F401
    except ImportError:
        cfg = TrainGLISConfig.from_args(TRAINER_ARGS).replace(
            dataset="folder", dataroot=folder, data_backend="grain")
        with pytest.raises(ImportError):
            make_dataset(cfg)
        return
    sub = linked_folder(str(tmp_path / "grain_jpegs"), list_images(folder)[:GRAIN_IMAGES])
    folder_run("train_glis --data_backend grain",
               ["--dataset", "folder", "--dataroot", sub, "--data_backend", "grain"],
               str(tmp_path / "tp_grain"))
    cfg = TrainGLISConfig.from_args(TRAINER_ARGS).replace(dataset="folder", dataroot=sub)
    epoch = GRAIN_IMAGES // cfg.batch_size
    streams = {b: make_dataset(cfg.replace(data_backend=b)).batches(0) for b in ("grain", "pil")}
    sets = {b: image_multiset(next(it) for _ in range(epoch)) for b, it in streams.items()}
    assert sets["grain"] == sets["pil"], "grain's first epoch is not the PIL stream's images"
