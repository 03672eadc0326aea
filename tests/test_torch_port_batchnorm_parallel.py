"""The port's data-parallel train steps under `--norm batch` against
`gea`'s `make_parallel_step` on `make_mesh(2)`, in fp32 on the CPU, for
G-LIS, R-separate and R-iterative (`tests/test_torch_port_parallel.py`
runs the same for weight norm and says how the two sides are fed).

Each of `gea`'s devices normalises with its own shard's batch statistics
and the running statistics are `pmean`ed after the step; each port rank
does the same over gloo, through one flat buffer a player
(`DataParallel.stats_buffer`). After 1 and 3 steps the metrics, the
parameters, Adam's first moments and the running statistics agree within
`tests/test_torch_port_batchnorm_steps.py`'s tolerances (which say why the
conv biases that feed a batch norm are compared through their moments and
copied from `gea` after each step); the two ranks then hold the same
parameters and running statistics, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_dp_workers as workers
from test_torch_port_batchnorm_steps import (
    R_TINY,
    RI_TINY,
    TINY,
    TO_PORT,
    assert_matches,
    bn_fed_biases,
    jitter_stats,
    port_layout,
)
from test_torch_port_parallel import WORLD, device_draws, real_batches
from test_torch_port_train import jitter

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig
from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.parallel import make_mesh
from gea.parallel.dp import make_parallel_step, replicate_state, shard_batch
from gea.parallel.mesh import DATA_AXIS
from gea.train.state import GANTrainState
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
)
from gea_torch.parallel import spawn

STEPS, SPAWN_TIMEOUT_S = 3, 240
KEY = jax.random.PRNGKey(0)
IMAGE = jnp.zeros((1, 16, 16, 3))


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gea_steps(state, pstep, inputs, cfgs, generator, tags) -> dict:
    mesh = make_mesh(WORLD)
    state = replicate_state(state, mesh)
    out = {"draws": [], "steps": []}
    for raw in inputs:
        out["draws"].append([device_draws(state, cfgs["run"], generator, i, False)
                             for i in range(WORLD)])
        state, metrics = pstep(state, shard_batch(raw, mesh))
        host = jax.device_get(state)
        snap = {"metrics": {k: float(v) for k, v in metrics.items()}}
        for tag in tags:
            snap.update(port_layout(host, tag, cfgs[tag]))
        out["steps"].append(snap)
    # The conv biases that feed a batch norm, copied into the port after
    # each step.
    out["sync"] = [{tag: {k: np.asarray(s[tag][k], np.float32) for k in bn_fed_biases(s[tag])}
                    for tag in tags} for s in out["steps"]]
    return out


def gea_glis():
    cfg = JaxTrainGLISConfig(**TINY, dataset="synthetic")
    pcfg = TrainGLISConfig(**TINY)
    g, d = JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg)
    init = (jitter(init_generator_params(pcfg, 0), 1), jitter(init_discriminator_params(pcfg, 1), 2))
    stats = {"g": jitter_stats(g.init(KEY, jnp.zeros((1, 16)))["batch_stats"], 3),
             "d": jitter_stats(d.init(KEY, IMAGE)["batch_stats"], 4)}
    txs = [jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for _ in range(2)]
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=init[0], params_d=init[1],
        extras_g={"batch_stats": stats["g"]}, extras_d={"batch_stats": stats["d"]},
        opt_g=txs[0].init(init[0]), opt_d=txs[1].init(init[1]))
    pstep = make_parallel_step(
        jax_build_glis_train_step(cfg, g, d, *txs, axis_name=DATA_AXIS), make_mesh(WORLD))
    reals = real_batches(cfg)
    ref = gea_steps(state, pstep, reals, {"run": cfg, "g": cfg, "d": cfg}, g, "gd")
    return {**ref, "trainer": "glis", "cfg": pcfg, "init": init, "stats": stats,
            "reals": reals, "tags": "gd"}


def gea_r_separate():
    cfg = JaxTrainRSeparateConfig(**R_TINY, dataset="synthetic")
    pcfg = TrainRSeparateConfig(**R_TINY)
    g, d, r = (JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg),
               JaxReverter.from_config(cfg))
    init = (jitter(init_generator_params(pcfg, 0), 1), jitter(init_discriminator_params(pcfg, 1), 2),
            jitter(init_reverter_params(pcfg, 2), 3))
    stats = {"g": jitter_stats(g.init(KEY, jnp.zeros((1, 16)))["batch_stats"], 3),
             "d": jitter_stats(d.init(KEY, IMAGE)["batch_stats"], 4),
             "r": jitter_stats(r.init(KEY, IMAGE)["batch_stats"], 5)}
    tx = jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g={}, params_d={},
                          extras_g={}, extras_d={}, opt_g={}, opt_d={}, params_r=init[2],
                          extras_r={"batch_stats": stats["r"]}, opt_r=tx.init(init[2]))
    pstep = make_parallel_step(jax_build_r_separate_step(
        cfg, g, r, {"params": init[0], "batch_stats": stats["g"]}, tx, axis_name=DATA_AXIS,
        discriminator=d, frozen_d_variables={"params": init[1], "batch_stats": stats["d"]}),
        make_mesh(WORLD))
    inputs = [np.zeros((WORLD,), np.float32)] * STEPS
    ref = gea_steps(state, pstep, inputs, {"run": cfg, "r": cfg}, g, "r")
    return {**ref, "trainer": "r_separate", "cfg": pcfg, "init": init, "stats": stats,
            "reals": [None] * STEPS, "tags": "r"}


def gea_r_iterative():
    cfg = JaxTrainRIterativeConfig(**RI_TINY, dataset="synthetic")
    pcfg = TrainRIterativeConfig(**RI_TINY)
    g = JaxGeneratorLIS.from_config(cfg, r_iterations=0)
    d, r = JaxDiscriminator.from_config(cfg), JaxReverter.from_config(cfg)
    init = {"g": jitter(init_generator_params(pcfg, 0), 1),
            "d": jitter(init_discriminator_params(pcfg, 1), 2),
            "r": jitter(init_reverter_params(pcfg, 2), 3)}
    stats = {"g": jitter_stats(g.init(KEY, jnp.zeros((1, 16)))["batch_stats"], 3),
             "d": jitter_stats(d.init(KEY, IMAGE)["batch_stats"], 4),
             "r": jitter_stats(r.init(KEY, IMAGE)["batch_stats"], 5)}
    txs = {k: jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for k in "gdr"}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=init["g"], params_d=init["d"],
        extras_g={"batch_stats": stats["g"]}, extras_d={"batch_stats": stats["d"]},
        opt_g=txs["g"].init(init["g"]), opt_d=txs["d"].init(init["d"]), params_r=init["r"],
        extras_r={"batch_stats": stats["r"]}, opt_r=txs["r"].init(init["r"]))
    pstep = make_parallel_step(jax_build_r_iterative_step(
        cfg, g, d, r, txs["g"], txs["d"], txs["r"], axis_name=DATA_AXIS), make_mesh(WORLD))
    reals = real_batches(cfg)
    ref = gea_steps(state, pstep, reals, {"run": cfg, "g": cfg, "d": cfg, "r": cfg}, g, "gdr")
    return {**ref, "trainer": "r_iterative", "cfg": pcfg, "init": init, "stats": stats,
            "reals": reals, "tags": "gdr"}


CASES = {"glis": gea_glis, "r_separate": gea_r_separate, "r_iterative": gea_r_iterative}


@functools.cache
def references() -> dict:
    return {case: build() for case, build in CASES.items()}


@functools.cache
def port_world2() -> dict:
    keys = ("trainer", "cfg", "init", "stats", "reals", "draws", "sync")
    cases = {case: {k: ref[k] for k in keys} for case, ref in references().items()}
    return spawn(workers.parity, WORLD, torch.device("cpu"), args=(cases,),
                 timeout=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("case", list(CASES))
def test_world2_matches_geas_two_device_step(case, after):
    ref = references()[case]
    got = port_world2()[case]["steps"][after - 1]
    assert_matches(got, ref["steps"][after - 1], ref["tags"])


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_the_same_parameters_and_stats(case):
    assert port_world2()[case]["spread"] == 0.0


def test_players_carry_batch_norm():
    assert set(TO_PORT) == {"g", "d", "r"}
    assert all(ref["stats"] for ref in references().values())
