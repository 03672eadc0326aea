"""The port's R-iterative step and trainer against `gea`'s
(`gea/train/steps_r.py::build_r_iterative_step`,
`gea/cli/train_r_iterative.py`), in fp32 on the CPU at a tiny config.

Both sides start from the same jittered params of G (single-stage,
r_iterations=0), D and R, with fresh Adam for each. `gea` draws z_0 and
spatial noise inside its step from `fold_in(state.rng, state.step)`; the
test draws them the same way and feeds them to the port's step. After 1
and after 3 steps the metrics agree to rtol 1e-5, every parameter of G, D
and R to atol 1e-5 and Adam's first moments to atol 1e-6 + rtol 1e-5 (the
tolerances of the G-LIS step's test, `tests/test_torch_port_train.py`).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig
from gea.interop.torch_port import (
    discriminator_to_torch_state,
    generator_to_torch_state,
    reverter_to_torch_state,
)
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.train.state import GANTrainState
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step
from gea_torch.cli import train_r_iterative
from gea_torch.config import UNPORTED, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
    r_iterative_state_from_jax,
)
from gea_torch.train import build_r_iterative_step, create_r_iterative_state, losses
from gea_torch.train.state import generator_config
from gea_torch.train.steps_r import link_weights
from gea_torch.utils import checkpoint as ckpt

TINY = dict(image_size=16, code_size=16, norm="weight", num_features=4, max_features=16,
            dtype="float32", batch_size=8, lr=1e-3, r_hidden=32)
CASES = {
    "chain_2": {},
    "spatial_code": {"spatial_code": 3},
    "grad_accum": {"grad_accum": 2},
    "remat": {"remat": True},
    "cosine": {"lr_schedule": "cosine", "niter": 3, "lr_final": 0.1},
}
STEPS = 3
PLAYERS = {"g": generator_to_torch_state, "d": discriminator_to_torch_state,
           "r": reverter_to_torch_state}


def jitter(params, seed):
    """Move every param off its init value (scales off 1, slopes off 0.25)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        params,
    )


def configs(kw):
    return (JaxTrainRIterativeConfig(**{**TINY, **kw}, dataset="synthetic"),
            TrainRIterativeConfig(**{**TINY, **kw}))


def real_batch(cfg):
    return np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def draws(state, cfg, generator):
    """z_0 and spatial noise exactly as `gea/train/steps_r.py` draws them."""
    z_rng, sn_rng = jax.random.split(jax.random.fold_in(state.rng, state.step))
    z = np.array(jax.random.normal(z_rng, (cfg.batch_size, cfg.code_size), jnp.float32))
    sn_shape = generator.spatial_noise_shape(cfg.batch_size)
    sn = None if not sn_shape else np.array(jax.random.normal(sn_rng, sn_shape, jnp.float32))
    return z, sn


def _port_layout(host, cfg):
    """Params and Adam's first moments of G, D and R in the port's layout."""
    g_cfg = cfg.replace(r_iterations=0)
    out = {}
    for tag, to_torch in PLAYERS.items():
        c = g_cfg if tag == "g" else cfg
        out[tag] = to_torch(getattr(host, f"params_{tag}"), c)
        out[f"mu_{tag}"] = to_torch(getattr(host, f"opt_{tag}")[0].mu, c)
    return out


def gea_run(kw, steps=STEPS):
    cfg, pcfg = configs(kw)
    params = {"g": jitter(init_generator_params(generator_config(pcfg), 0), 1),
              "d": jitter(init_discriminator_params(pcfg, 1), 2),
              "r": jitter(init_reverter_params(pcfg, 2), 3)}
    g = JaxGeneratorLIS.from_config(cfg, r_iterations=0)
    d, r = JaxDiscriminator.from_config(cfg), JaxReverter.from_config(cfg)
    txs = {k: jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2, schedule=cfg.lr_schedule,
                                 total_steps=cfg.niter, lr_final=cfg.lr_final) for k in "gdr"}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=params["g"],
        params_d=params["d"], extras_g={}, extras_d={}, opt_g=txs["g"].init(params["g"]),
        opt_d=txs["d"].init(params["d"]), params_r=params["r"], extras_r={},
        opt_r=txs["r"].init(params["r"]))
    step = jax.jit(jax_build_r_iterative_step(cfg, g, d, r, txs["g"], txs["d"], txs["r"]))
    real = real_batch(cfg)
    out = {"params": params, "draws": [], "steps": []}
    for _ in range(steps):
        out["draws"].append(draws(state, cfg, g))
        state, metrics = step(state, jnp.asarray(real))
        host = jax.device_get(state)
        out["steps"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                             **_port_layout(host, cfg), "state": host})
    return out


def snapshot(state, metrics):
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "state": state}
    for tag, module in (("g", state.generator), ("d", state.discriminator),
                        ("r", state.reverter)):
        opt = getattr(state, f"opt_{tag}")
        out[tag] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        out[f"mu_{tag}"] = {n: opt.state[p]["exp_avg"].clone()
                            for n, p in module.named_parameters()}
    return out


def port_run(kw, ref, steps=STEPS):
    _, pcfg = configs(kw)
    p = ref["params"]
    state = create_r_iterative_state(pcfg, p["g"], p["d"], p["r"], device="cpu")
    step = build_r_iterative_step(pcfg)
    real = real_batch(pcfg)
    return [snapshot(state, step(state, real, z, sn)) for z, sn in ref["draws"][:steps]]


@functools.cache
def runs(case):
    ref = gea_run(CASES[case])
    return ref, port_run(CASES[case], ref)


def assert_matches(got, want):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for tag in PLAYERS:
        for k in want[f"mu_{tag}"]:
            np.testing.assert_allclose(got[f"mu_{tag}"][k].numpy(),
                                       np.asarray(want[f"mu_{tag}"][k]), atol=1e-6, rtol=1e-5,
                                       err_msg=f"mu_{tag} {k}")
        for k in want[tag]:
            np.testing.assert_allclose(got[tag][k].numpy(), np.asarray(want[tag][k]), atol=1e-5,
                                       rtol=0, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_gea(case, after):
    ref, port = runs(case)
    assert_matches(port[after - 1], ref["steps"][after - 1])


def test_state_carried_from_gea_takes_the_same_step():
    """`gea`'s state after 2 steps (G, D and R with optax's Adam states and
    their count, the step), carried into the port by
    `r_iterative_state_from_jax`, takes step 3 from the same draws as
    `gea` did."""
    case = "cosine"
    ref, _ = runs(case)
    _, pcfg = configs(CASES[case])
    state = r_iterative_state_from_jax(ref["steps"][1]["state"], pcfg, device="cpu")
    assert state.step == 2
    for tag in "gdr":
        opt = getattr(state, f"opt_{tag}")
        assert all(float(s["step"]) == 2 for s in opt.state.values())
        factor = getattr(state, f"sched_{tag}").lr_lambdas[0]
        np.testing.assert_allclose(opt.param_groups[0]["lr"], pcfg.lr * factor(2), rtol=1e-9)
    z, sn = ref["draws"][2]
    metrics = build_r_iterative_step(pcfg)(state, real_batch(pcfg), z, sn)
    assert_matches(snapshot(state, metrics), ref["steps"][2])


def test_every_player_gets_a_gradient():
    """After a step every parameter of G, D and R has a finite, non-zero
    gradient (D's from its own update, G's and R's from the joint one)."""
    _, port = runs("chain_2")
    state = port[-1]["state"]
    for m in (state.generator, state.discriminator, state.reverter):
        for n, p in m.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), n
            assert p.grad.abs().max() > 0, n
    assert state.generator.cfg.r_iterations == 0 and len(state.generator.lis) == 0


def test_link_weights_and_staged_loss_match_gea(rng):
    """The link weights 0.5 + 0.5 i / (n - 1), normalised (not
    `stage_weights`), and `staged_loss` against `gea`'s."""
    from gea.train import losses as jax_losses

    assert link_weights(2) == pytest.approx((0.5 / 2.25, 0.75 / 2.25, 1.0 / 2.25), rel=1e-12)
    assert link_weights(0) == (1.0,)
    logits = rng.standard_normal((3, 6)).astype(np.float32)
    for target in (0.0, 1.0):
        want = jax_losses.staged_loss(jnp.asarray(logits), link_weights(2), target)
        got = losses.staged_loss(torch.from_numpy(logits), link_weights(2), target)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("cls", [TrainRIterativeConfig, TrainRSeparateConfig])
def test_r_configs_refuse_unported_flags(cls):
    """Each R config refuses every flag on the list (which G-LIS shares:
    --use_pallas alone), and accepts the FID flags and the flags of tensor
    parallelism, LSUN and grain."""
    from gea_torch.config import refuse_unported

    assert set(UNPORTED) <= {f.name for f in dataclasses.fields(cls)}
    assert not {"fid_interval", "fid_samples", "stop_patience"} & set(UNPORTED)
    refuse_unported(cls(fid_interval=5, fid_samples=64))
    with pytest.raises(SystemExit, match="use_pallas"):
        refuse_unported(cls(use_pallas=True))
    refuse_unported(cls(data_backend="grain", lsun_classes="tower", dataset="lsun",
                        model_shards=2, tp_min_width=8))
    refuse_unported(cls(num_devices=1, norm="none", data_backend="pil"))
    refuse_unported(cls(norm="batch", data_backend="native"))


def test_config_has_geas_flags():
    """Every flag of `gea`'s TrainRIterativeConfig, with its default, plus
    --device."""
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainRIterativeConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(TrainRIterativeConfig)}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


# ---------------------------------------------------------------- the CLI

TINY_CLI = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size",
            "32", "--code_size", "16", "--num_features", "4", "--max_features", "16",
            "--r_hidden", "32", "--batch_size", "4", "--dtype", "float32", "--log_interval", "1",
            "--vis_rows", "2"]


def test_cli_trains_writes_and_resumes(tmp_path, capsys):
    """config.json, checkpoints/<step>/state.pt with G, D and R, one grid
    per chain link; a relaunch resumes."""
    run = str(tmp_path / "run")
    args = TINY_CLI + ["--save_path", run, "--vis_interval", "2", "--save_interval", "2"]
    state, stats = train_r_iterative.main(args + ["--niter", "4"])
    assert state.step == 4 and stats["images_per_sec"] > 0
    assert TrainRIterativeConfig.load(os.path.join(run, "config.json")) == \
        TrainRIterativeConfig.from_args(args + ["--niter", "4"])
    saved = ckpt.load_checkpoint(run, 2)
    assert {"generator", "discriminator", "reverter", "opt_g", "opt_d", "opt_r"} <= set(saved)
    assert "g_ema" not in saved
    for s in (2, 4):
        for link in range(3):
            assert os.path.isfile(os.path.join(run, "samples", f"samples_{s:08d}_stage{link}.png"))
    capsys.readouterr()
    state, _ = train_r_iterative.main(args + ["--niter", "6"])
    assert f"resumed from {run} at step 4" in capsys.readouterr().out
    assert state.step == 6 and ckpt.latest_step(run) == 6


@pytest.mark.parametrize("extra", [[], ["--synthetic_on_device", "true"]],
                         ids=["host_synthetic", "synthetic_on_device"])
def test_cli_resume_is_bit_identical(tmp_path, extra):
    """4 steps straight against 2, a resume and 2 more: G, D, R, their
    Adams and the generator's state bit for bit."""
    def cli(name, niter):
        return train_r_iterative.main(TINY_CLI + extra + [
            "--save_path", str(tmp_path / name), "--niter", str(niter), "--vis_interval", "0",
            "--save_interval", "2"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight, _ = cli("straight", 4)
        cli("resumed", 2)
        resumed, _ = cli("resumed", 4)
    finally:
        torch.set_num_threads(n)
    a, b = ckpt.state_dict(straight), ckpt.state_dict(resumed)
    assert a.keys() == b.keys() and a["step"] == b["step"] == 4
    for name in ("generator", "discriminator", "reverter"):
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), f"{name} {k}"
    for tag in "gdr":
        for k, v in a[f"opt_{tag}"]["state"].items():
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(v[m], b[f"opt_{tag}"]["state"][k][m])
    assert torch.equal(a["rng"], b["rng"])


def test_glis_checkpoint_is_refused(tmp_path):
    """A G-LIS checkpoint does not restore into an R-iterative state."""
    from gea_torch.train import create_glis_state
    from gea_torch.config import TrainGLISConfig

    gcfg = TrainGLISConfig(**{k: v for k, v in TINY.items() if k != "r_hidden"},
                           r_iterations=0)
    ckpt.save_checkpoint(str(tmp_path), 1, create_glis_state(gcfg, device="cpu"))
    _, pcfg = configs({})
    with pytest.raises(ValueError, match="another trainer"):
        ckpt.restore_checkpoint(str(tmp_path), create_r_iterative_state(pcfg, device="cpu"))


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


@pytest.mark.parametrize("kw,want", [({}, (17, 0, 6)), ({"remat": True}, (24, 0, 9))],
                         ids=["default", "remat"])
def test_kernel_calls_per_step(kernel_calls, kw, want):
    """Kernel forwards per step (TPReLU, LIS, seed), which `chip_smoke.py`
    asserts as launches on the card. At this config a render has 1 TPReLU,
    R 2, D's trunk 1: two unrolls of 3 renders and 2 R's, and 3 D forwards;
    remat runs the joint unroll's first render and both links again in the
    backward. At flagship width (3 TPReLUs a render and a trunk) the
    default step is 43, 0, 6."""
    _, pcfg = configs(kw)
    state = create_r_iterative_state(pcfg, device="cpu")
    build_r_iterative_step(pcfg)(state, real_batch(pcfg))
    assert tuple(kernel_calls.values()) == want
