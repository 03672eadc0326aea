"""The port's data-parallel train steps (`gea_torch.parallel`, the steps'
`dp`) against `gea`'s `make_parallel_step` on `make_mesh(2)`, in fp32 on
the CPU at the tiny configs of the step tests.

`gea` runs its step under `shard_map` on two of the eight virtual CPU
devices: each device takes half the batch and draws its noise from
`fold_in(fold_in(rng, step), device)`, and the gradients and metrics are
`pmean`'d. The port runs two gloo processes (`gea_torch.parallel.spawn`,
with a timeout that fails the test on a hang); each rank takes its half of
the real batch and is fed its device's draws. After 1 and 3 steps the
metrics agree to rtol 1e-5, every parameter to atol 1e-5 and Adam's first
moments to atol 1e-6 + rtol 1e-5 (`tests/test_torch_port_train.py`'s
tolerances, which say why the moments are compared and why WGAN-GP's D
head bias is compared by its moment), for G-LIS (BCE, `--grad_accum 2`,
WGAN-GP), R-separate and R-iterative.

The port's world-2 step also equals its own world-1 step on the whole
batch with the two ranks' draws joined, within the same tolerances; the
two ranks hold the same parameters after every run; and at world size 1
the step with `dp` is the step without it, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_port_dp_workers as workers
from test_torch_port_r_iterative import configs as rit_configs
from test_torch_port_r_separate import configs as rsep_configs
from test_torch_port_r_separate import params as rsep_params
from test_torch_port_train import TINY as GLIS_TINY
from test_torch_port_train import jitter

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.interop.torch_port import (
    discriminator_to_torch_state,
    generator_to_torch_state,
    reverter_to_torch_state,
)
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.parallel import make_mesh
from gea.parallel.dp import make_parallel_step, replicate_state, shard_batch
from gea.parallel.mesh import DATA_AXIS
from gea.train.state import GANTrainState
from gea.train.state import create_glis_state as jax_create_glis_state
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step
from gea_torch.config import TrainGLISConfig
from gea_torch.interop import init_discriminator_params, init_generator_params, init_reverter_params
from gea_torch.parallel import DataParallel, join, spawn
from gea_torch.parallel.mesh import Launch, free_port
from gea_torch.train.state import generator_config

STEPS, WORLD, SPAWN_TIMEOUT_S = 3, 2, 240
# case -> (trainer, flags)
CASES = {
    "glis": ("glis", {}),
    "glis_grad_accum": ("glis", {"grad_accum": 2}),
    "glis_wgan_gp": ("glis", {"gan_loss": "wgan-gp"}),
    "r_separate": ("r_separate", {}),
    "r_iterative": ("r_iterative", {}),
}
NOISE_BIAS = ("glis_wgan_gp",)  # D's head bias has a gradient zero up to rounding


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in the spawned ranks: tiny ops run
    faster so, and runs compared bit for bit take one path through torch's
    CPU kernels."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def real_batches(cfg):
    """STEPS different real batches of the global batch, in [-1, 1]."""
    return [np.random.default_rng(20 + i).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        for i in range(STEPS)]


def device_draws(state, cfg, generator, device: int, gp: bool) -> dict:
    """One device's draws of a step, exactly as `gea`'s steps make them
    under `shard_map` (the device index folded into the step's key)."""
    rng = jax.random.fold_in(jax.random.fold_in(state.rng, state.step), device)
    keys = jax.random.split(rng, 3 if gp else 2)
    local = cfg.batch_size // WORLD
    sn_shape = generator.spatial_noise_shape(local)
    out = {"z": np.array(jax.random.normal(keys[0], (local, cfg.code_size), jnp.float32)),
           "spatial_noise": None if not sn_shape else np.array(
               jax.random.normal(keys[1], sn_shape, jnp.float32))}
    if gp:
        out["gp_eps"] = np.array(jax.random.uniform(keys[2], (local, 1, 1, 1), jnp.float32))
    return out


def gea_steps(state, pstep, inputs, cfg, generator, gp: bool, to_port) -> dict:
    """STEPS of `gea`'s 2-device step: the draws fed, and after each step
    the metrics and the players' params and first moments in the port's
    layout."""
    mesh = make_mesh(WORLD)
    state = replicate_state(state, mesh)
    out = {"draws": [], "steps": []}
    for raw in inputs:
        out["draws"].append([device_draws(state, cfg, generator, i, gp) for i in range(WORLD)])
        state, metrics = pstep(state, shard_batch(raw, mesh))
        host = jax.device_get(state)
        snap = {"metrics": {k: float(v) for k, v in metrics.items()}}
        for tag, fn in to_port.items():
            snap[tag] = fn(getattr(host, f"params_{tag}"))
            snap[f"mu_{tag}"] = fn(getattr(host, f"opt_{tag}")[0].mu)
        out["steps"].append(snap)
    return out


def gea_glis(kw):
    cfg = JaxTrainGLISConfig(**{**GLIS_TINY, **kw}, dataset="synthetic")
    g, d = JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg)
    txs = [jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for _ in range(2)]
    state = jax_create_glis_state(cfg, g, d, *txs, seed=0)
    pg, pd = jitter(state.params_g, 1), jitter(state.params_d, 2)
    state = state.replace(params_g=pg, params_d=pd, opt_g=txs[0].init(pg),
                          opt_d=txs[1].init(pd))
    pstep = make_parallel_step(
        jax_build_glis_train_step(cfg, g, d, *txs, axis_name=DATA_AXIS), make_mesh(WORLD))
    reals = real_batches(cfg)
    to = {"g": lambda t: generator_to_torch_state(t, cfg),
          "d": lambda t: discriminator_to_torch_state(t, cfg)}
    ref = gea_steps(state, pstep, reals, cfg, g, cfg.gan_loss == "wgan-gp", to)
    return {**ref, "cfg": TrainGLISConfig(**{**GLIS_TINY, **kw}), "init": (pg, pd),
            "reals": reals}


def gea_r_separate(kw):
    cfg, pcfg = rsep_configs(kw)
    g_params, d_params, r_params = rsep_params(pcfg)
    g, r, d = (JaxGeneratorLIS.from_config(cfg), JaxReverter.from_config(cfg),
               JaxDiscriminator.from_config(cfg))
    tx = jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                          params_g={}, params_d={}, extras_g={}, extras_d={}, opt_g={},
                          opt_d={}, params_r=r_params, extras_r={}, opt_r=tx.init(r_params))
    pstep = make_parallel_step(jax_build_r_separate_step(
        cfg, g, r, {"params": g_params}, tx, axis_name=DATA_AXIS, discriminator=d,
        frozen_d_variables={"params": d_params}), make_mesh(WORLD))
    inputs = [np.zeros((WORLD,), np.float32)] * STEPS
    ref = gea_steps(state, pstep, inputs, cfg, g, False,
                    {"r": lambda t: reverter_to_torch_state(t, cfg)})
    return {**ref, "cfg": pcfg, "init": (g_params, d_params, r_params), "reals": [None] * STEPS}


def gea_r_iterative(kw):
    cfg, pcfg = rit_configs(kw)
    init = {"g": jitter(init_generator_params(generator_config(pcfg), 0), 1),
            "d": jitter(init_discriminator_params(pcfg, 1), 2),
            "r": jitter(init_reverter_params(pcfg, 2), 3)}
    g = JaxGeneratorLIS.from_config(cfg, r_iterations=0)
    d, r = JaxDiscriminator.from_config(cfg), JaxReverter.from_config(cfg)
    txs = {k: jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for k in "gdr"}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=init["g"],
        params_d=init["d"], extras_g={}, extras_d={}, opt_g=txs["g"].init(init["g"]),
        opt_d=txs["d"].init(init["d"]), params_r=init["r"], extras_r={},
        opt_r=txs["r"].init(init["r"]))
    pstep = make_parallel_step(jax_build_r_iterative_step(
        cfg, g, d, r, txs["g"], txs["d"], txs["r"], axis_name=DATA_AXIS), make_mesh(WORLD))
    g_cfg = cfg.replace(r_iterations=0)
    reals = real_batches(cfg)
    ref = gea_steps(state, pstep, reals, cfg, g, False,
                    {"g": lambda t: generator_to_torch_state(t, g_cfg),
                     "d": lambda t: discriminator_to_torch_state(t, cfg),
                     "r": lambda t: reverter_to_torch_state(t, cfg)})
    return {**ref, "cfg": pcfg, "init": init, "reals": reals}


GEA = {"glis": gea_glis, "r_separate": gea_r_separate, "r_iterative": gea_r_iterative}


@functools.cache
def references() -> dict:
    out = {}
    for case, (trainer, kw) in CASES.items():
        out[case] = {"trainer": trainer, **GEA[trainer](kw)}
        if case in NOISE_BIAS:
            out[case]["bias"] = [np.asarray(s["d"]["head.bias"], np.float32)
                                 for s in out[case]["steps"]]
    return out


@functools.cache
def port_world2() -> dict:
    """Every case on two gloo ranks, fed `gea`'s per-device draws."""
    cases = {case: {k: ref[k] for k in ("trainer", "cfg", "init", "reals", "draws", "bias")
                    if k in ref} for case, ref in references().items()}
    return spawn(workers.parity, WORLD, torch.device("cpu"), args=(cases,),
                 timeout=SPAWN_TIMEOUT_S)


def assert_close(got: dict, want: dict, case: str) -> None:
    metrics = dict(got["metrics"])
    atol = dict.fromkeys(metrics, 0.0)
    if case in NOISE_BIAS:
        bias = lambda s: float(np.asarray(s["d"]["head.bias"])[0])  # noqa: E731
        metrics["loss_g"] += bias(got) - bias(want)
        atol["loss_g"] = 1e-6
    assert set(metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=atol[k], err_msg=k)
    for tag in [k for k in want if k in ("g", "d", "r")]:
        for k, v in want[f"mu_{tag}"].items():
            np.testing.assert_allclose(got[f"mu_{tag}"][k].numpy(), np.asarray(v), atol=1e-6,
                                       rtol=1e-5, err_msg=f"mu_{tag} {k}")
        for k, v in want[tag].items():
            if case in NOISE_BIAS and (tag, k) == ("d", "head.bias"):
                continue
            np.testing.assert_allclose(got[tag][k].numpy(), np.asarray(v), atol=1e-5, rtol=0,
                                       err_msg=f"{tag} {k}")


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_geas_two_device_step(case, after):
    got = port_world2()[case]["steps"][after - 1]
    assert_close(got, references()[case]["steps"][after - 1], case)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_the_same_parameters(case):
    assert port_world2()[case]["spread"] == 0.0


def joined(per_rank: list) -> dict:
    """The ranks' draws of one step joined into the whole batch's."""
    return {k: None if per_rank[0][k] is None else np.concatenate([d[k] for d in per_rank])
            for k in per_rank[0]}


@pytest.mark.parametrize("case", [c for c in CASES if c not in NOISE_BIAS])
def test_world2_equals_world1_on_the_whole_batch(case):
    """`gea`'s tests/test_train_step.py:191 and test_dp_r_and_cifar.py:148
    for the port: the world-1 step on the whole batch, fed both ranks'
    draws joined, takes the step the two ranks take together."""
    ref = references()[case]
    state, step = workers.port_state(ref["trainer"], ref["cfg"], ref["init"])
    reals = [None if r is None else torch.from_numpy(r) for r in ref["reals"]]
    whole = workers.run_steps(state, step, reals, [joined(d) for d in ref["draws"]])
    for got, want in zip(whole, port_world2()[case]["steps"]):
        assert_close(got, want, case)


@pytest.fixture
def world1():
    """A gloo group of world size 1 in this process."""
    join(torch.device("cpu"), Launch(0, 1, 0, f"tcp://127.0.0.1:{free_port()}"))
    try:
        yield DataParallel(torch.device("cpu"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_world1_is_the_single_process_step_bit_for_bit(case, world1):
    """At world size 1 the step with `dp` (its flat gradient buffers, its
    all-reduces, its draws of the whole batch's rows) is today's step:
    parameters, Adam's moments, metrics and the generator's state equal
    bit for bit, with the step's own draws."""
    ref = references()[case]
    runs = []
    for dp in (None, world1):
        state, step = workers.port_state(ref["trainer"], ref["cfg"], ref["init"], dp)
        reals = [None if r is None else torch.from_numpy(r) for r in ref["reals"]]
        runs.append((workers.run_steps(state, step, reals, [{}] * STEPS), state))
    (plain, plain_state), (ranked, ranked_state) = runs
    for a, b in zip(plain, ranked):
        assert a["metrics"] == b["metrics"]
        for key in a:
            if key != "metrics":
                assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    assert torch.equal(plain_state.rng.get_state(), ranked_state.rng.get_state())
