"""The port's R-separate step and trainer against `gea`'s
(`gea/train/steps_r.py::build_r_separate_step`,
`gea/cli/train_r_separate.py`), in fp32 on the CPU at a tiny config.

Both sides start from the same jittered params of the frozen G and D and
of R, with fresh Adam for R. `gea` draws z and spatial noise inside its
step from `fold_in(state.rng, state.step)`; the test draws them the same
way and feeds them to the port's step. After 1 and after 3 steps the
metrics agree to rtol 1e-5, R's parameters to atol 1e-5 and Adam's first
moments to atol 1e-6 + rtol 1e-5 (the tolerances of the G-LIS step's
test, `tests/test_torch_port_train.py`, which says why the moments are
compared too).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig
from gea.interop.torch_port import reverter_to_torch_state
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.train.state import GANTrainState
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step
from gea_torch.cli import sample, train_glis, train_r_separate
from gea_torch.config import TrainRSeparateConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
    r_separate_state_from_jax,
)
from gea_torch.train import build_r_separate_step, create_r_state
from gea_torch.utils import checkpoint as ckpt

TINY = dict(image_size=16, code_size=16, r_iterations=1, norm="weight", num_features=4,
            max_features=16, dtype="float32", batch_size=8, lr=1e-3, r_hidden=32)
CASES = {
    "mse_without_d": {"no_d": True},
    "d_feedback": {},
    "mining": {"r_mine_weight": 0.5},
    "spatial_code": {"spatial_code": 3},
    "grad_accum": {"grad_accum": 2},
    "remat": {"remat": True},
    "cosine": {"lr_schedule": "cosine", "niter": 3, "lr_final": 0.1},
}
STEPS = 3


def jitter(params, seed):
    """Move every param off its init value (scales off 1, slopes off 0.25)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        params,
    )


def configs(kw):
    kw = {k: v for k, v in kw.items() if k != "no_d"}
    return (JaxTrainRSeparateConfig(**{**TINY, **kw}, dataset="synthetic"),
            TrainRSeparateConfig(**{**TINY, **kw}))


def params(cfg):
    """Jittered params of the frozen G and D and of R, in `gea`'s layout."""
    return (jitter(init_generator_params(cfg, 0), 1), jitter(init_discriminator_params(cfg, 1), 2),
            jitter(init_reverter_params(cfg, 2), 3))


def draws(state, cfg, generator):
    """z and spatial noise exactly as `gea/train/steps_r.py` draws them."""
    z_rng, sn_rng = jax.random.split(jax.random.fold_in(state.rng, state.step))
    z = np.array(jax.random.normal(z_rng, (cfg.batch_size, cfg.code_size), jnp.float32))
    sn_shape = generator.spatial_noise_shape(cfg.batch_size)
    sn = None if not sn_shape else np.array(jax.random.normal(sn_rng, sn_shape, jnp.float32))
    return z, sn


def gea_run(kw, steps=STEPS):
    """`gea`'s step: per step, (metrics, R's params and first moments in
    the port's layout, the whole state) and the draws fed."""
    cfg, pcfg = configs(kw)
    g_params, d_params, r_params = params(pcfg)
    g, r = JaxGeneratorLIS.from_config(cfg), JaxReverter.from_config(cfg)
    d = None if kw.get("no_d") else JaxDiscriminator.from_config(cfg)
    tx = jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2, schedule=cfg.lr_schedule,
                            total_steps=cfg.niter, lr_final=cfg.lr_final)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                          params_g={}, params_d={}, extras_g={}, extras_d={}, opt_g={},
                          opt_d={}, params_r=r_params, extras_r={}, opt_r=tx.init(r_params))
    step = jax.jit(jax_build_r_separate_step(
        cfg, g, r, {"params": g_params}, tx, discriminator=d,
        frozen_d_variables=None if d is None else {"params": d_params}))
    out = {"params": (g_params, d_params, r_params), "draws": [], "steps": []}
    for _ in range(steps):
        out["draws"].append(draws(state, cfg, g))
        state, metrics = step(state, jnp.zeros(()))
        host = jax.device_get(state)
        out["steps"].append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "r": reverter_to_torch_state(host.params_r, cfg),
            "mu_r": reverter_to_torch_state(host.opt_r[0].mu, cfg),
            "state": host,
        })
    return out


def frozen(pcfg, ref, no_d=False):
    g_params, d_params, _ = ref["params"]
    g = generator_from_jax_params(g_params, pcfg, device="cpu")
    d = None if no_d else discriminator_from_jax_params(d_params, pcfg, device="cpu")
    return g, d


def port_run(kw, ref, steps=STEPS):
    _, pcfg = configs(kw)
    g, d = frozen(pcfg, ref, kw.get("no_d"))
    state = create_r_state(pcfg, g, d, ref["params"][2], device="cpu")
    step = build_r_separate_step(pcfg)
    out = []
    for z, sn in ref["draws"][:steps]:
        metrics = step(state, None, z, sn)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "r": {k: v.detach().clone() for k, v in state.reverter.state_dict().items()},
            "mu_r": {n: state.opt_r.state[p]["exp_avg"].clone()
                     for n, p in state.reverter.named_parameters()},
            "state": state,
        })
    return out


@functools.cache
def runs(case):
    ref = gea_run(CASES[case])
    return ref, port_run(CASES[case], ref)


def assert_matches(got, want):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k in want["mu_r"]:
        np.testing.assert_allclose(got["mu_r"][k].numpy(), np.asarray(want["mu_r"][k]),
                                   atol=1e-6, rtol=1e-5, err_msg=f"mu_r {k}")
    for k in want["r"]:
        np.testing.assert_allclose(got["r"][k].numpy(), np.asarray(want["r"][k]), atol=1e-5,
                                   rtol=0, err_msg=f"R {k}")


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_gea(case, after):
    ref, port = runs(case)
    assert_matches(port[after - 1], ref["steps"][after - 1])
    assert set(port[after - 1]["metrics"]) == set(ref["steps"][after - 1]["metrics"])


def test_only_r_is_trained():
    """The frozen G and D are unchanged bit for bit, have no gradient, and
    every parameter of R has a finite, non-zero one."""
    ref, port = runs("d_feedback")
    state = port[-1]["state"]
    g, d = frozen(state.reverter.cfg, ref)
    for live, fresh in ((state.generator, g), (state.discriminator, d)):
        for (n, p), q in zip(live.named_parameters(), fresh.parameters()):
            assert not p.requires_grad and p.grad is None, n
            assert torch.equal(p, q), n
    for n, p in state.reverter.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, n


def test_state_carried_from_gea_takes_the_same_step():
    """`gea`'s state after 2 steps (R's params, optax's Adam state with its
    count, the step), carried into the port by `r_separate_state_from_jax`,
    takes step 3 from the same draws as `gea` did."""
    case = "cosine"
    ref, _ = runs(case)
    _, pcfg = configs(CASES[case])
    g, d = frozen(pcfg, ref)
    state = r_separate_state_from_jax(ref["steps"][1]["state"], pcfg, g, d, device="cpu")
    assert state.step == 2
    assert all(float(state.opt_r.state[p]["step"]) == 2 for p in state.reverter.parameters())
    z, sn = ref["draws"][2]
    metrics = build_r_separate_step(pcfg)(state, None, z, sn)
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "r": state.reverter.state_dict(),
           "mu_r": {n: state.opt_r.state[p]["exp_avg"]
                    for n, p in state.reverter.named_parameters()}}
    assert_matches(got, ref["steps"][2])


def test_own_draws_are_seeded():
    """Without z given, the step draws from the state's generator: two
    states with one seed take the same step, two seeds different ones."""
    _, pcfg = configs({})
    ref = {"params": params(pcfg)}
    loss = []
    for seed in (0, 0, 1):
        state = create_r_state(pcfg, *frozen(pcfg, ref), seed=seed, device="cpu")
        loss.append(float(build_r_separate_step(pcfg)(state)["loss_r"]))
    assert loss[0] == loss[1] != loss[2]


def test_config_has_geas_flags():
    """Every flag of `gea`'s TrainRSeparateConfig, with its default, plus
    --device."""
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainRSeparateConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(TrainRSeparateConfig)}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


# ---------------------------------------------------------------- the CLI

GLIS = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size", "32",
        "--code_size", "16", "--num_features", "4", "--max_features", "16", "--r_iterations",
        "1", "--batch_size", "4", "--dtype", "float32", "--vis_interval", "0",
        "--log_interval", "2"]
RSEP = ["--device", "cpu", "--batch_size", "4", "--log_interval", "1", "--vis_rows", "2",
        "--r_hidden", "32"]


@pytest.fixture(scope="module")
def g_run(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("glis") / "run")
    train_glis.main(GLIS + ["--save_path", run, "--niter", "2", "--save_interval", "2"])
    return run


def test_cli_trains_writes_and_resumes(g_run, tmp_path, capsys):
    """Against a port G-LIS run: the architecture comes from its config,
    the run directory has config.json, checkpoints/<step>/state.pt holding
    R only, and before/after grids; a relaunch resumes."""
    run = str(tmp_path / "r")
    args = RSEP + ["--g_path", g_run, "--save_path", run, "--vis_interval", "2",
                   "--save_interval", "2", "--image_size", "32"]
    state, stats = train_r_separate.main(args + ["--niter", "4"])
    assert state.step == 4 and stats["images_per_sec"] > 0
    cfg = TrainRSeparateConfig.load(os.path.join(run, "config.json"))
    assert (cfg.image_size, cfg.r_iterations, cfg.code_size) == (16, 1, 16)
    assert ckpt.latest_step(run) == 4
    saved = ckpt.load_checkpoint(run, 2)
    assert set(saved) == {"step", "reverter", "opt_r", "sched_r", "rng"}
    for s in (2, 4):
        for stage in (0, 1):
            assert os.path.isfile(os.path.join(run, "samples", f"samples_{s:08d}_stage{stage}.png"))
    assert state.discriminator is not None
    capsys.readouterr()
    state, _ = train_r_separate.main(args + ["--niter", "6"])
    assert f"resumed from {run} at step 4" in capsys.readouterr().out
    assert state.step == 6 and ckpt.latest_step(run) == 6


def test_cli_resume_is_bit_identical(g_run, tmp_path):
    """4 steps straight against 2, a resume and 2 more: R's state bit for
    bit."""
    def cli(name, niter):
        return train_r_separate.main(RSEP + ["--g_path", g_run, "--save_path",
                                             str(tmp_path / name), "--niter", str(niter),
                                             "--vis_interval", "0", "--save_interval", "2"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight, _ = cli("straight", 4)
        cli("resumed", 2)
        resumed, _ = cli("resumed", 4)
    finally:
        torch.set_num_threads(n)
    a, b = ckpt.state_dict(straight), ckpt.state_dict(resumed)
    assert a.keys() == b.keys()
    for name in ("reverter",):
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), k
    for k, v in a["opt_r"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(v[m], b["opt_r"]["state"][k][m])
    assert torch.equal(a["rng"], b["rng"]) and a["step"] == b["step"] == 4


def test_cli_without_d_falls_back_to_mse(g_run, tmp_path, capsys, monkeypatch):
    """A G checkpoint without a discriminator: `gea`'s fallback to pure
    code-reconstruction MSE, with a message."""
    real_read = sample.read_run

    def no_d(*a, **kw):
        cfg, state = real_read(*a, **kw)
        return cfg, {k: v for k, v in state.items() if k != "discriminator"}

    monkeypatch.setattr(train_r_separate, "read_run", no_d)
    state, stats = train_r_separate.main(RSEP + ["--g_path", g_run, "--save_path",
                                                 str(tmp_path / "r"), "--niter", "1"])
    assert "falling back to pure code-reconstruction MSE" in capsys.readouterr().out
    assert state.discriminator is None and stats["metrics"]["loss_r_adv"] == 0.0


def test_loaders_read_a_port_run_and_refuse_others(g_run, tmp_path):
    """`load_generator` / `load_discriminator` read a port G-LIS run (the
    latest step; -1 needs best.json); a directory without state.pt raises
    an error that says what it expected."""
    g, cfg = sample.load_generator(g_run, device="cpu")
    assert cfg.r_iterations == 1 and not g.training
    want = ckpt.load_checkpoint(g_run)["generator"]
    for k, v in g.state_dict().items():
        assert torch.equal(v, want[k]), k
    sample.load_discriminator(g_run, step=2, device="cpu")
    with pytest.raises(FileNotFoundError, match="best.json"):
        sample.load_generator(g_run, step=-1, device="cpu")
    (tmp_path / "orbax" / "checkpoints" / "2").mkdir(parents=True)
    (tmp_path / "orbax" / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="state.pt"):
        sample.load_generator(str(tmp_path / "orbax"), device="cpu")
    with pytest.raises(SystemExit, match="g_path"):
        train_r_separate.main(RSEP + ["--save_path", str(tmp_path / "x")])


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts each kernel's forward calls on the CPU (where the wrappers run
    their plain versions and count no launch)."""
    from gea_torch.ops import lis, seed, tprelu

    calls = dict.fromkeys(("fused_tprelu", "lis_residual_mlp", "fused_seed"), 0)
    for mod, name in ((tprelu, "fused_tprelu"), (lis, "lis_residual_mlp"), (seed, "fused_seed")):
        def counted(*args, _f=mod._forward, _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(mod, "_forward", counted)
    return calls


@pytest.mark.parametrize("kw,want", [
    ({}, (5, 2, 2)),
    ({"r_mine_weight": 0.5}, (6, 2, 2)),
    ({"remat": True}, (7, 3, 3)),
    ({"no_d": True}, (3, 1, 1)),
], ids=["default", "mining", "remat", "without_d"])
def test_kernel_calls_per_step(kernel_calls, kw, want):
    """Kernel forwards per step (TPReLU, LIS, seed), which
    `tests/test_torch_port_trainers_card.py` asserts as launches on the card. At this config a G render has 1 TPReLU
    and 1 LIS link, D's trunk 1 TPReLU, R 2: frozen render + R + corrected
    render + D; mining scores the frozen render with D once more; remat
    runs the corrected render and its scoring again in the backward; with
    no D there is no corrected render. At flagship width (3 TPReLUs a
    render and a trunk, 3 links) the default step is 13, 6, 2."""
    ref = {"params": params(configs({})[1])}
    _, pcfg = configs(kw)
    state = create_r_state(pcfg, *frozen(pcfg, ref, kw.get("no_d")), device="cpu")
    build_r_separate_step(pcfg)(state)
    assert tuple(kernel_calls.values()) == want
