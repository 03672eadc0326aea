"""The port's evaluation CLIs and FID tracking against `gea`'s, in fp32 on
the CPU at a tiny config.

`compute_fid`, `eval_stages` and `eval_chain` run on both sides against
run directories that hold the same jittered weights: `gea`'s as orbax
checkpoints, the port's as `state.pt`, through the `gea_torch.interop`
converters. The port's fake iterators take `gea`'s `jax.random` draws
(`jax_noise`, the key chain of `gea/cli/compute_fid.py:35-42`); the reals
are the same synthetic bytes, preprocessed within 1e-6. The JSON results
have the same keys and agree at rtol 1e-4; precision and recall, fractions
of a few dozen samples, are equal. Each trainer's `fid_fn` is held against
`gea`'s `make_fid_fn` for the same weights and draws, and the port's
tracking (fid.jsonl, best.json, retention, --stop_patience, resume) is
checked on its own.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.cli import compute_fid as jax_compute_fid
from gea.cli import eval_chain as jax_eval_chain
from gea.cli import eval_stages as jax_eval_stages
from gea.cli import train_glis as jax_train_glis
from gea.cli import train_r_iterative as jax_train_r_iterative
from gea.cli import train_r_separate as jax_train_r_separate
from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig
from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig
from gea.eval import fid as jfid
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.train.state import GANTrainState
from gea.utils import checkpoint as jax_ckpt
from gea_torch.cli import compute_fid, eval_chain, eval_stages, train_glis, train_r_iterative
from gea_torch.cli import train_r_separate
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    generator_from_jax_params,
    generator_state_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.train import create_glis_state, create_r_iterative_state, create_r_state
from gea_torch.train.state import generator_config
from gea_torch.utils import checkpoint as ckpt

TINY = dict(image_size=16, code_size=16, num_features=4, max_features=16, dtype="float32",
            batch_size=8, dataset="synthetic", crop_size=32, fid_samples=32)
R_TINY = dict(TINY, r_hidden=32)
STEP = 2  # the checkpoint step of every run directory here
SAMPLES = ["--num_samples", "32", "--batch_size", "8", "--extractor", "random"]

GEA_MAKE_EXTRACTOR = jfid.make_feature_extractor


@functools.cache
def gea_extractor(name):
    return GEA_MAKE_EXTRACTOR(16, name)


@pytest.fixture(autouse=True)
def drawn_once(monkeypatch):
    """`gea` draws its extractors' filters (seconds) once in this process."""
    monkeypatch.setattr(jfid, "make_feature_extractor",
                        lambda image_size, extractor="auto", inception_weights="":
                        gea_extractor("random" if extractor == "auto" else extractor))


def jitter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def jax_noise(generator, seed):
    """`gea`'s draws for the port's iterators: per batch of n,
    rng, z_rng, sn_rng = split(rng, 3) from PRNGKey(seed)."""
    rng = jax.random.PRNGKey(seed)

    def draw(n):
        nonlocal rng
        rng, z_rng, sn_rng = jax.random.split(rng, 3)
        z = np.array(jax.random.normal(z_rng, (n, generator.cfg.code_size), jnp.float32))
        shape = generator.spatial_noise_shape(n)
        sn = None if not shape else np.array(jax.random.normal(sn_rng, shape, jnp.float32))
        return torch.from_numpy(z), None if sn is None else torch.from_numpy(sn)

    return draw


def jax_state(**kw):
    """A `gea` train state with only the given params (the rest empty)."""
    fields = dict(step=jnp.asarray(STEP, jnp.int32), rng=jax.random.PRNGKey(0), params_g={},
                  params_d={}, extras_g={}, extras_d={}, opt_g={}, opt_d={}, params_r={},
                  extras_r={}, opt_r={}, params_g_ema={})
    return GANTrainState(**{**fields, **kw})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run directories of both packages with the same weights: a G-LIS run
    (G with one LIS module, D, and an EMA shadow), an R-separate run
    against it and an R-iterative run."""
    root = tmp_path_factory.mktemp("runs")
    out = {"params": {}}
    glis = JaxTrainGLISConfig(**TINY, r_iterations=1, g_ema=0.5)
    g, d = jitter(init_generator_params(glis, 0), 1), jitter(init_discriminator_params(glis, 1), 2)
    g_ema = jitter(g, 3)
    rsep = JaxTrainRSeparateConfig(**R_TINY, r_iterations=1)
    r = jitter(init_reverter_params(rsep, 2), 4)
    riter = JaxTrainRIterativeConfig(**R_TINY, r_chain_length=2)
    gi = jitter(init_generator_params(generator_config(riter), 5), 6)
    di, ri = jitter(init_discriminator_params(riter, 6), 7), jitter(init_reverter_params(riter, 7), 8)
    out["params"] = {"g": g, "d": d, "g_ema": g_ema, "r": r, "gi": gi, "di": di, "ri": ri}
    for kind, jcfg, state in (
            ("glis", glis, jax_state(params_g=g, params_d=d, params_g_ema=g_ema)),
            ("rsep", rsep, jax_state(params_r=r)),
            ("riter", riter, jax_state(params_g=gi, params_d=di, params_r=ri))):
        run = str(root / "gea" / kind)
        jcfg.save(os.path.join(run, "config.json"))
        jax_ckpt.save_checkpoint(run, STEP, state)
        out[f"gea_{kind}"] = run

    pcfg = TrainGLISConfig(**TINY, r_iterations=1, g_ema=0.5)
    gstate = create_glis_state(pcfg, g, d, device="cpu")
    gstate.g_ema = dict(generator_state_from_jax_params(g_ema, pcfg))
    rcfg = TrainRSeparateConfig(**R_TINY, r_iterations=1)
    icfg = TrainRIterativeConfig(**R_TINY, r_chain_length=2)
    for kind, cfg, state in (
            ("glis", pcfg, gstate),
            ("rsep", rcfg, create_r_state(rcfg, gstate.generator, gstate.discriminator, r,
                                          device="cpu")),
            ("riter", icfg, create_r_iterative_state(icfg, gi, di, ri, device="cpu"))):
        run = str(root / "port" / kind)
        cfg.save(os.path.join(run, "config.json"))
        ckpt.save_checkpoint(run, STEP, state)
        out[f"port_{kind}"] = run
    out["cfgs"] = {"glis": (glis, pcfg), "rsep": (rsep, rcfg), "riter": (riter, icfg)}
    return out


def assert_same_result(got, want, path="result"):
    """Same keys; paths differ by run directory; numbers at rtol 1e-4;
    precision and recall equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same_result(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_result(a, b, f"{path}[{i}]")
    elif path.endswith(("load_path", "r_path")):
        assert os.path.basename(got) == os.path.basename(want), path
    elif isinstance(want, float) and not path.endswith(("precision", "recall")):
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=path)
    else:
        assert got == want, path


COMPUTE_FID = {
    "plain": [],
    "d_filter": ["--d_filter", "--oversample", "2"],
    "r_path": ["--r_path", "{rsep}", "--correction_strength", "0.5"],
    "second_opinion": ["--second_opinion"],
    "repeats_2": ["--repeats", "2", "--seed", "3"],
    "use_ema": ["--use_ema"],
}


@pytest.mark.parametrize("case", list(COMPUTE_FID))
def test_compute_fid_matches_gea(runs, case):
    def argv(side):
        extra = [a.format(rsep=runs[f"{side}_rsep"]) for a in COMPUTE_FID[case]]
        return ["--load_path", runs[f"{side}_glis"], "--dataset", "synthetic"] + SAMPLES + extra

    want = jax_compute_fid.main(argv("gea"))
    got = compute_fid.main(argv("port") + ["--device", "cpu"], noise=jax_noise)
    assert got["metric"] == "proxy-FID(random-cnn)"
    assert_same_result(got, want)


@pytest.mark.parametrize("second_opinion", [False, True], ids=["primary", "second_opinion"])
def test_eval_stages_matches_gea(runs, second_opinion):
    extra = ["--second_opinion"] if second_opinion else []
    want = jax_eval_stages.main(["--load_path", runs["gea_glis"]] + SAMPLES + extra)
    got = eval_stages.main(["--load_path", runs["port_glis"], "--device", "cpu"] + SAMPLES
                           + extra, noise=jax_noise)
    assert [s["stage"] for s in got["stages"]] == [0, 1]
    assert_same_result(got, want)


@pytest.mark.parametrize("links", [None, 3], ids=["trained_length", "extrapolated"])
def test_eval_chain_matches_gea(runs, links):
    extra = [] if links is None else ["--chain_length", str(links)]
    want = jax_eval_chain.main(["--load_path", runs["gea_riter"]] + SAMPLES + extra)
    got = eval_chain.main(["--load_path", runs["port_riter"], "--device", "cpu"] + SAMPLES
                          + extra, noise=jax_noise)
    assert len(got["links"]) == (links or 2) + 1
    assert_same_result(got, want)


def test_step_minus_one_reads_best_json(runs, tmp_path):
    """--step -1 loads the step best.json names; without one it says so."""
    with pytest.raises(FileNotFoundError, match="best.json"):
        compute_fid.main(["--load_path", runs["port_glis"], "--device", "cpu", "--step", "-1"]
                         + SAMPLES)
    ckpt.record_best_step(runs["port_glis"], STEP, 1.0, "fid")
    try:
        got = compute_fid.main(["--load_path", runs["port_glis"], "--device", "cpu", "--step",
                                "-1", "--dataset", "synthetic"] + SAMPLES, noise=jax_noise)
        want = compute_fid.main(["--load_path", runs["port_glis"], "--device", "cpu",
                                 "--dataset", "synthetic"] + SAMPLES, noise=jax_noise)
    finally:
        os.remove(os.path.join(runs["port_glis"], "best.json"))
    assert got == want


def test_use_ema_needs_a_shadow(runs, tmp_path):
    cfg = TrainGLISConfig(**TINY, r_iterations=1)
    run = str(tmp_path / "plain")
    cfg.save(os.path.join(run, "config.json"))
    ckpt.save_checkpoint(run, 1, create_glis_state(cfg, device="cpu"))
    with pytest.raises(SystemExit, match="no EMA params"):
        compute_fid.main(["--load_path", run, "--device", "cpu", "--use_ema"] + SAMPLES)


# --------------------------------------------------------- the trainers' fid_fn


@pytest.mark.parametrize("kind", ["glis", "glis_ema", "r_separate", "r_iterative"])
def test_fid_fn_matches_geas_make_fid_fn(runs, kind):
    """Each trainer's `fid_fn` against `gea`'s for the same weights, the
    same reals and the same draws."""
    p = runs["params"]
    if kind.startswith("glis"):
        jcfg, pcfg = runs["cfgs"]["glis"]
        if kind == "glis":
            jcfg, pcfg = jcfg.replace(g_ema=0.0), pcfg.replace(g_ema=0.0)
        want = jax_train_glis.make_fid_fn(jcfg, JaxGeneratorLIS.from_config(jcfg))(
            jax_state(params_g=p["g"], params_g_ema=p["g_ema"] if jcfg.g_ema else {}))
        state = create_glis_state(pcfg, p["g"], p["d"], device="cpu")
        if pcfg.g_ema:
            state.g_ema = dict(generator_state_from_jax_params(p["g_ema"], pcfg))
        got = train_glis.make_fid_fn(pcfg, "cpu", noise=jax_noise)(state)
    elif kind == "r_separate":
        jcfg, pcfg = runs["cfgs"]["rsep"]
        g_cfg, pg_cfg = runs["cfgs"]["glis"]
        want = jax_train_r_separate.make_fid_fn(
            jcfg, g_cfg, JaxGeneratorLIS.from_config(jcfg), {"params": p["g"]},
            JaxReverter.from_config(jcfg))(jax_state(params_r=p["r"]))
        g = generator_from_jax_params(p["g"], pcfg, device="cpu")
        got = train_r_separate.make_fid_fn(pcfg, pg_cfg, g, noise=jax_noise)(
            create_r_state(pcfg, g, None, p["r"], device="cpu"))
    else:
        jcfg, pcfg = runs["cfgs"]["riter"]
        want = jax_train_r_iterative.make_fid_fn(
            jcfg, JaxGeneratorLIS.from_config(jcfg, r_iterations=0), JaxReverter.from_config(jcfg))(
            jax_state(params_g=p["gi"], params_r=p["ri"]))
        got = train_r_iterative.make_fid_fn(pcfg, "cpu", noise=jax_noise)(
            create_r_iterative_state(pcfg, p["gi"], p["di"], p["ri"], device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ---------------------------------------------------------- tracking in the loop


GLIS = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size", "32",
        "--code_size", "16", "--num_features", "4", "--max_features", "16", "--r_iterations",
        "1", "--batch_size", "4", "--dtype", "float32", "--vis_interval", "0",
        "--log_interval", "2", "--fid_samples", "16"]
R_ARGS = ["--device", "cpu", "--batch_size", "4", "--log_interval", "2", "--r_hidden", "32",
          "--vis_interval", "0", "--fid_samples", "16"]


def fid_rows(run):
    with open(os.path.join(run, "fid.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def g_run(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("glis") / "run")
    train_glis.main(GLIS + ["--save_path", run, "--niter", "2", "--save_interval", "2"])
    return run


@pytest.mark.parametrize("trainer", ["glis", "r_separate", "r_iterative"])
def test_tracked_run_writes_fid_and_best(g_run, tmp_path, trainer):
    """--fid_interval 2 over 4 steps with --keep_checkpoints 1: two finite
    rows in fid.jsonl, and best.json names a checkpoint on disk that
    restores (--step -1)."""
    run = str(tmp_path / "run")
    common = ["--save_path", run, "--niter", "4", "--fid_interval", "2", "--save_interval", "1",
              "--keep_checkpoints", "1"]
    if trainer == "glis":
        state, _ = train_glis.main(GLIS + common)
        fresh = create_glis_state(state.generator.cfg, device="cpu")
    elif trainer == "r_separate":
        state, _ = train_r_separate.main(R_ARGS + common + ["--g_path", g_run])
        fresh = create_r_state(state.reverter.cfg, state.generator, state.discriminator,
                               device="cpu")
    else:
        state, _ = train_r_iterative.main(GLIS + ["--r_hidden", "32"] + common)
        fresh = create_r_iterative_state(state.reverter.cfg, device="cpu")
    rows = fid_rows(run)
    assert [r["step"] for r in rows] == [2, 4] and all(np.isfinite(r["fid"]) for r in rows)
    best = ckpt.best_record(run)
    assert best["label"] == "fid" and best["metric"] == min(r["fid"] for r in rows)
    assert os.path.isdir(os.path.join(run, "checkpoints", str(best["step"])))
    restored = ckpt.restore_checkpoint(run, fresh, step=-1)
    assert restored.step == best["step"]


class Scripted:
    """A fid_fn that returns the given scores in turn."""

    def __init__(self, scores):
        self.scores = iter(scores)

    def __call__(self, *args, **kw):
        return lambda state: next(self.scores)


def test_stop_patience_stops_and_best_survives_retention(tmp_path, monkeypatch):
    """Scores 5, 4, 6, 7, 3 at every step with --keep_checkpoints 1: with
    --stop_patience 2 the run stops at step 4, the second evaluation in a
    row without a new best; the best, step 2, survives retention, which
    prunes the superseded best of step 1, and best.json names it. With
    --stop_patience 1 it stops at step 3."""
    run = str(tmp_path / "run")
    args = GLIS + ["--niter", "10", "--fid_interval", "1", "--save_interval", "1",
                   "--keep_checkpoints", "1"]
    monkeypatch.setattr(train_glis, "make_fid_fn", Scripted([5.0, 4.0, 6.0, 7.0, 3.0]))
    state, _ = train_glis.main(args + ["--save_path", run, "--stop_patience", "2"])
    assert state.step == 4
    assert [r["fid"] for r in fid_rows(run)] == [5.0, 4.0, 6.0, 7.0]
    assert ckpt.best_record(run) == {"step": 2, "metric": 4.0, "label": "fid"}
    on_disk = ckpt._steps_on_disk(os.path.join(run, "checkpoints"))
    assert 2 in on_disk and 4 in on_disk and 1 not in on_disk
    assert ckpt.load_checkpoint(run, -1)["step"] == 2
    monkeypatch.setattr(train_glis, "make_fid_fn", Scripted([5.0, 4.0, 6.0, 7.0]))
    state, _ = train_glis.main(args + ["--save_path", str(tmp_path / "p1"), "--stop_patience",
                                       "1"])
    assert state.step == 3


def test_resume_keeps_the_recorded_best(tmp_path, monkeypatch):
    """A relaunch compares against best.json: 3, 2 then, resumed, 2.5, 2.4
    keep step 2 as the best; a fresh run into the same directory does not
    adopt it."""
    run = str(tmp_path / "run")
    args = GLIS + ["--save_path", run, "--fid_interval", "1", "--save_interval", "1"]
    monkeypatch.setattr(train_glis, "make_fid_fn", Scripted([3.0, 2.0]))
    train_glis.main(args + ["--niter", "2"])
    monkeypatch.setattr(train_glis, "make_fid_fn", Scripted([2.5, 2.4]))
    state, _ = train_glis.main(args + ["--niter", "4"])
    assert state.step == 4
    assert [r["fid"] for r in fid_rows(run)] == [3.0, 2.0, 2.5, 2.4]
    assert ckpt.best_record(run)["step"] == 2
    other = str(tmp_path / "other")
    os.makedirs(other)
    with open(os.path.join(other, "best.json"), "w") as f:
        json.dump({"step": 99, "metric": 0.1, "label": "fid"}, f)
    monkeypatch.setattr(train_glis, "make_fid_fn", Scripted([9.0]))
    train_glis.main(GLIS + ["--save_path", other, "--fid_interval", "1", "--niter", "1"])
    assert ckpt.best_record(other) == {"step": 1, "metric": 9.0, "label": "fid"}


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts each kernel's forward calls on the CPU (the plain versions)."""
    from gea_torch.ops import lis, seed, tprelu

    calls = dict.fromkeys(("fused_tprelu", "lis_residual_mlp", "fused_seed"), 0)
    for mod, name in ((tprelu, "fused_tprelu"), (lis, "lis_residual_mlp"), (seed, "fused_seed")):
        def counted(*args, _f=mod._forward, _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(mod, "_forward", counted)
    return calls


@pytest.mark.parametrize("cli,want", [
    ("plain", (1, 1, 1)), ("d_filter", (2, 1, 1)), ("r_path", (4, 2, 2)),
    ("eval_stages", (2, 1, 1)), ("eval_chain", (8, 0, 3))])
def test_kernel_calls_per_batch(runs, kernel_calls, cli, want):
    """Kernel forwards (TPReLU, LIS, seed) per batch of each evaluator,
    which `tests/test_torch_port_trainers_card.py` asserts as launches: 4 batches here.
    At this config a G render has 1 TPReLU and 1 LIS link, D's trunk 1
    TPReLU, R 2; the real side runs none. At flagship width (3 TPReLUs a
    render and a trunk, 3 links) a batch is 3/3/1, 6/3/1, 10/6/2, 6/3/1 and
    20/0/3."""
    if cli == "eval_stages":
        eval_stages.main(["--load_path", runs["port_glis"], "--device", "cpu"] + SAMPLES)
    elif cli == "eval_chain":
        eval_chain.main(["--load_path", runs["port_riter"], "--device", "cpu"] + SAMPLES)
    else:
        extra = {"plain": [], "d_filter": ["--d_filter"],
                 "r_path": ["--r_path", runs["port_rsep"]]}[cli]
        compute_fid.main(["--load_path", runs["port_glis"], "--device", "cpu", "--dataset",
                          "synthetic"] + SAMPLES + extra)
    assert tuple(kernel_calls.values()) == tuple(4 * w for w in want)
