"""The port's chunked dispatch (`gea_torch.train.dispatch`, `--steps_per_dispatch`)
against `gea`'s `jax.jit(chunk_steps(step, k))` (`gea/train/runner.py`), in
fp32 on the CPU at the tiny configs of the step tests.

Both sides start from the same jittered params with fresh Adam and a cosine
schedule over 6 steps, so that the lr changes inside the chunk. `gea`'s
chunk draws each step's z, spatial noise and gradient-penalty eps from
`fold_in(state.rng, state.step)`; the test draws them the same way and
hands them to the port's dispatcher in place of its own draws
(`step.noise`). The chunk's real batches differ from step to step. After
the chunk the (k,) metrics agree to rtol 1e-5, every parameter to atol 1e-5
and Adam's first moments to atol 1e-6 + rtol 1e-5: the tolerances of
`tests/test_torch_port_train.py`, which says why the moments are compared.

On the CPU the dispatcher runs the body it captures on the card eagerly,
on the same static buffers; that body must equal k eager steps of the port
bit for bit, schedules, step count and generator state included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_r_iterative import configs as rit_configs
from test_torch_port_r_iterative import draws as rit_draws
from test_torch_port_r_separate import configs as rsep_configs
from test_torch_port_r_separate import draws as rsep_draws
from test_torch_port_r_separate import frozen
from test_torch_port_r_separate import params as rsep_params
from test_torch_port_runner import assert_states_equal
from test_torch_port_train import TINY as GLIS_TINY
from test_torch_port_train import draws as glis_draws
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
from gea.train.runner import chunk_steps
from gea.train.state import GANTrainState
from gea.train.state import create_glis_state as jax_create_glis_state
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step
from gea_torch.config import TrainGLISConfig
from gea_torch.interop import init_discriminator_params, init_generator_params, init_reverter_params
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.dispatch import StepDispatcher, build_step_fn
from gea_torch.train.state import generator_config, lr_factor
from gea_torch.utils import checkpoint as ckpt

COSINE = {"lr_schedule": "cosine", "niter": 6, "lr_final": 0.1}
# case -> (trainer, config, k)
CASES = {
    "glis": ("glis", COSINE, 3),
    "glis_spatial_code": ("glis", {**COSINE, "spatial_code": 3}, 3),
    "glis_grad_accum": ("glis", {**COSINE, "grad_accum": 2}, 2),
    "r_separate": ("r_separate", COSINE, 3),
    "r_iterative": ("r_iterative", COSINE, 3),
}
NOISE_KEYS = {"glis": ("z", "spatial_noise", "gp_eps"), "r_separate": ("z", "spatial_noise"),
              "r_iterative": ("z", "spatial_noise")}


def reals(cfg, k):
    """k different real batches, (k, B, H, W, 3) in [-1, 1]."""
    return np.stack([np.random.default_rng(10 + i).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
        for i in range(k)])


def optimizers(cfg, n):
    return [jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2, schedule=cfg.lr_schedule,
                               total_steps=cfg.niter, lr_final=cfg.lr_final) for _ in range(n)]


def run_chunk(step, state, raws, k):
    new, metrics = jax.jit(chunk_steps(lambda s, raw, rng: step(s, raw), k))(
        state, jnp.asarray(raws), jax.random.PRNGKey(0))
    return jax.device_get(new), {key: np.asarray(v) for key, v in metrics.items()}


def gea_glis(kw, k):
    cfg = JaxTrainGLISConfig(**{**GLIS_TINY, **kw}, dataset="synthetic")
    g, d = JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg)
    txs = optimizers(cfg, 2)
    state = jax_create_glis_state(cfg, g, d, *txs, seed=0)
    pg, pd = jitter(state.params_g, 1), jitter(state.params_d, 2)
    state = state.replace(params_g=pg, params_d=pd, opt_g=txs[0].init(pg),
                          opt_d=txs[1].init(pd))
    fed = [glis_draws(state.replace(step=i), cfg, g) for i in range(k)]
    host, metrics = run_chunk(jax_build_glis_train_step(cfg, g, d, *txs), state,
                              reals(cfg, k), k)
    to = {"g": generator_to_torch_state, "d": discriminator_to_torch_state}
    return {"init": (pg, pd), "draws": fed, "metrics": metrics, "reals": reals(cfg, k),
            **port_layout(host, cfg, to)}


def gea_r_separate(kw, k):
    cfg, pcfg = rsep_configs(kw)
    g_params, d_params, r_params = rsep_params(pcfg)
    g, r, d = (JaxGeneratorLIS.from_config(cfg), JaxReverter.from_config(cfg),
               JaxDiscriminator.from_config(cfg))
    (tx,) = optimizers(cfg, 1)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                          params_g={}, params_d={}, extras_g={}, extras_d={}, opt_g={},
                          opt_d={}, params_r=r_params, extras_r={}, opt_r=tx.init(r_params))
    step = jax_build_r_separate_step(cfg, g, r, {"params": g_params}, tx, discriminator=d,
                                     frozen_d_variables={"params": d_params})
    fed = [rsep_draws(state.replace(step=i), cfg, g) for i in range(k)]
    host, metrics = run_chunk(step, state, np.zeros((k,), np.float32), k)
    return {"init": (g_params, d_params, r_params), "draws": fed, "metrics": metrics,
            "reals": [None] * k, **port_layout(host, cfg, {"r": reverter_to_torch_state})}


def gea_r_iterative(kw, k):
    cfg, pcfg = rit_configs(kw)
    params = {"g": jitter(init_generator_params(generator_config(pcfg), 0), 1),
              "d": jitter(init_discriminator_params(pcfg, 1), 2),
              "r": jitter(init_reverter_params(pcfg, 2), 3)}
    g = JaxGeneratorLIS.from_config(cfg, r_iterations=0)
    d, r = JaxDiscriminator.from_config(cfg), JaxReverter.from_config(cfg)
    txs = dict(zip("gdr", optimizers(cfg, 3)))
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=params["g"],
        params_d=params["d"], extras_g={}, extras_d={}, opt_g=txs["g"].init(params["g"]),
        opt_d=txs["d"].init(params["d"]), params_r=params["r"], extras_r={},
        opt_r=txs["r"].init(params["r"]))
    step = jax_build_r_iterative_step(cfg, g, d, r, txs["g"], txs["d"], txs["r"])
    fed = [rit_draws(state.replace(step=i), cfg, g) for i in range(k)]
    host, metrics = run_chunk(step, state, reals(cfg, k), k)
    g_cfg = cfg.replace(r_iterations=0)
    to = {"g": lambda t, c: generator_to_torch_state(t, g_cfg), "d": discriminator_to_torch_state,
          "r": reverter_to_torch_state}
    return {"init": params, "draws": fed, "metrics": metrics, "reals": reals(cfg, k),
            **port_layout(host, cfg, to)}


def port_layout(host, cfg, to: dict) -> dict:
    """Each player's params and Adam's first moments in the port's layout."""
    out = {}
    for tag, fn in to.items():
        out[tag] = fn(getattr(host, f"params_{tag}"), cfg)
        out[f"mu_{tag}"] = fn(getattr(host, f"opt_{tag}")[0].mu, cfg)
    return out


GEA = {"glis": gea_glis, "r_separate": gea_r_separate, "r_iterative": gea_r_iterative}


def port_state(trainer, kw, k, init):
    """The port's state and step for `trainer` from `gea`'s initial params."""
    if trainer == "glis":
        cfg = TrainGLISConfig(**{**GLIS_TINY, **kw}, steps_per_dispatch=k)
        return cfg, create_glis_state(cfg, *init, device="cpu"), build_glis_train_step(cfg)
    if trainer == "r_separate":
        _, cfg = rsep_configs(kw)
        cfg = cfg.replace(steps_per_dispatch=k)
        g, d = frozen(cfg, {"params": init})
        return cfg, create_r_state(cfg, g, d, init[2], device="cpu"), build_r_separate_step(cfg)
    _, cfg = rit_configs(kw)
    cfg = cfg.replace(steps_per_dispatch=k)
    state = create_r_iterative_state(cfg, init["g"], init["d"], init["r"], device="cpu")
    return cfg, state, build_r_iterative_step(cfg)


def fed_noise(trainer, drawn):
    """`gea`'s draws of one step as the port step's noise arguments."""
    return {key: None if v is None else torch.from_numpy(np.asarray(v))
            for key, v in zip(NOISE_KEYS[trainer], drawn)}


def inject(step, trainer, draws):
    """Hand `draws` to the dispatcher, step by step, in place of its own."""
    it = iter(draws)
    step.noise = lambda state: fed_noise(trainer, next(it))


def port_reals(ref):
    return [None if r is None else torch.from_numpy(r) for r in ref["reals"]]


@functools.cache
def runs(case):
    trainer, kw, k = CASES[case]
    ref = GEA[trainer](kw, k)
    cfg, state, step = port_state(trainer, kw, k, ref["init"])
    inject(step, trainer, ref["draws"])
    metrics = build_step_fn(cfg, step)(state, port_reals(ref))
    return ref, state, metrics


def trained(state):
    """{tag: (module, optimizer)} of the state's trained players."""
    return {tag: (getattr(state, name), getattr(state, f"opt_{tag}"))
            for name, tag in state.PLAYERS}


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_matches_geas_chunk_steps(case):
    ref, state, metrics = runs(case)
    k = CASES[case][2]
    assert set(metrics) == set(ref["metrics"])
    for key, want in ref["metrics"].items():
        assert metrics[key].shape == want.shape == (k,), key
        np.testing.assert_allclose(metrics[key].numpy(), want, rtol=1e-5, err_msg=key)
    assert state.step == k
    for tag, (module, opt) in trained(state).items():
        for name, p in module.named_parameters():
            np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(),
                                       np.asarray(ref[f"mu_{tag}"][name]), atol=1e-6,
                                       rtol=1e-5, err_msg=f"mu_{tag} {name}")
        for name, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref[tag][name]), atol=1e-5,
                                       rtol=0, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_equals_eager_steps(case):
    """The dispatcher's K-step body on its static buffers, with the lr
    copied per inner step from its (K,) buffer into the Adam's lr tensor
    and the schedules advanced after, is k eager steps of a state made
    for K = 1 (a float lr)."""
    trainer, kw, k = CASES[case]
    ref = runs(case)[0]
    cfg, chunked, step = port_state(trainer, kw, k, ref["init"])
    inject(step, trainer, ref["draws"])
    build_step_fn(cfg, step)(chunked, port_reals(ref))
    _, eager, step = port_state(trainer, kw, 1, ref["init"])
    for real, drawn in zip(port_reals(ref), ref["draws"]):
        step(eager, real, **fed_noise(trainer, drawn))
    assert_states_equal(chunked, eager)
    for tag, (_, opt) in trained(chunked).items():
        lr = opt.param_groups[0]["lr"]
        assert torch.is_tensor(lr) and lr.dtype == torch.float64
        assert lr.item() == trained(eager)[tag][1].param_groups[0]["lr"]


def test_ragged_tail_and_refusals():
    """A chunk shorter than K (the tail of a run, a misaligned resume)
    stacks what it ran; a longer one is refused; K = 1 is the eager step
    with 0-d metrics."""
    cfg = TrainGLISConfig(**GLIS_TINY, steps_per_dispatch=3)
    state = create_glis_state(cfg, device="cpu")
    real = torch.from_numpy(reals(cfg, 1)[0])
    dispatch = build_step_fn(cfg, build_glis_train_step(cfg))
    assert {v.shape for v in dispatch(state, [real] * 2).values()} == {(2,)}
    assert state.step == 2
    assert {v.shape for v in dispatch(state, [real] * 3).values()} == {(3,)}
    assert state.step == 5
    with pytest.raises(ValueError, match="chunk of 4 steps"):
        dispatch(state, [real] * 4)
    one = StepDispatcher(cfg.replace(steps_per_dispatch=0), build_glis_train_step(cfg))
    assert one.k_cfg == 1
    assert {v.shape for v in one(state, [real]).values()} == {()}
    assert state.step == 6


def test_dispatcher_draws_in_the_eager_order():
    """Without injected draws, a chunk draws from the state's generator
    exactly what k eager steps draw: the same states after."""
    cfg = TrainGLISConfig(**{**GLIS_TINY, "spatial_code": 3, "gan_loss": "wgan-gp"},
                          steps_per_dispatch=3)
    real = [torch.from_numpy(r) for r in reals(cfg, 3)]
    chunked = create_glis_state(cfg, device="cpu")
    build_step_fn(cfg, build_glis_train_step(cfg))(chunked, real)
    eager, step = create_glis_state(cfg, device="cpu"), build_glis_train_step(cfg)
    for r in real:
        step(eager, r)
    assert_states_equal(chunked, eager)


@pytest.mark.parametrize("kw", [
    {"gan_loss": "wgan-gp", "g_ema": 0.999, "grad_accum": 2, "remat": True, **COSINE},
    {"gan_loss": "hinge", "g_ema": 0.9, "lr_schedule": "linear", "niter": 5, "lr_final": 0.3},
], ids=["wgan_gp_ema_accum_remat_cosine", "hinge_ema_linear"])
def test_chunk_with_options_equals_eager_steps(kw):
    """A chunk of 3 under a schedule with EMA, and WGAN-GP's double
    backward with --grad_accum and --remat, drawing its own noise, is 3
    eager steps of a state made for K = 1, bit for bit."""
    cfg = TrainGLISConfig(**{**GLIS_TINY, **kw}, steps_per_dispatch=3)
    real = [torch.from_numpy(r) for r in reals(cfg, 3)]
    chunked = create_glis_state(cfg, device="cpu")
    build_step_fn(cfg, build_glis_train_step(cfg))(chunked, real)
    eager_cfg = cfg.replace(steps_per_dispatch=1)
    eager, step = create_glis_state(eager_cfg, device="cpu"), build_glis_train_step(eager_cfg)
    for r in real:
        step(eager, r)
    assert_states_equal(chunked, eager)
    assert chunked.sched_g.last_epoch == eager.sched_g.last_epoch == 3


def test_chunked_state_lr_form():
    """A state made for K > 1 under a schedule holds its lr in a 0-d
    tensor (float64 on the CPU, exact), which the dispatcher fills; a
    scheduled state made for K = 1 is refused by a chunked dispatcher."""
    cfg = TrainGLISConfig(**{**GLIS_TINY, **COSINE}, steps_per_dispatch=2)
    state = create_glis_state(cfg, device="cpu")
    for opt in (state.opt_g, state.opt_d):
        group = opt.param_groups[0]
        assert torch.is_tensor(group["lr"]) and group["lr"].dim() == 0
        assert group["lr"].dtype == torch.float64 and not group["capturable"]
        assert group["lr"].item() == cfg.lr
    constant = create_glis_state(cfg.replace(lr_schedule="constant"), device="cpu")
    assert isinstance(constant.opt_g.param_groups[0]["lr"], float)
    plain = create_glis_state(cfg.replace(steps_per_dispatch=1), device="cpu")
    real = torch.from_numpy(reals(cfg, 1)[0])
    with pytest.raises(ValueError, match="tensor lr under a schedule"):
        build_step_fn(cfg, build_glis_train_step(cfg))(plain, [real] * 2)


def test_checkpoints_restore_across_adam_forms(tmp_path):
    """A capturable Adam (the card's chunked form: lr an fp32 tensor, step
    counts where the params are) and a plain one write the same
    checkpoint, and each restores the other's, keeping its own form."""
    cfg = TrainGLISConfig(**{**GLIS_TINY, **COSINE})
    plain = create_glis_state(cfg, device="cpu")
    step = build_glis_train_step(cfg)
    for r in reals(cfg, 2):
        step(plain, torch.from_numpy(r))
    ckpt.save_checkpoint(str(tmp_path / "plain"), 2, plain)

    graphed = create_glis_state(cfg, device="cpu")
    for name, tag in graphed.PLAYERS:
        module = getattr(graphed, name)
        opt = torch.optim.Adam(module.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
                               eps=1e-8, capturable=True)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lr_factor(cfg.lr_schedule, cfg.niter, cfg.lr_final))
        opt.param_groups[0]["lr"] = torch.tensor(cfg.lr)
        setattr(graphed, f"opt_{tag}", opt)
        setattr(graphed, f"sched_{tag}", sched)
    lr = graphed.opt_g.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and graphed.opt_g.param_groups[0]["capturable"]
    ckpt.restore_checkpoint(str(tmp_path / "plain"), graphed)
    group = graphed.opt_g.param_groups[0]
    assert group["lr"] is lr and group["capturable"]
    assert float(lr) == float(torch.tensor(plain.opt_g.param_groups[0]["lr"]))  # in fp32
    assert_states_equal(graphed, plain)
    ckpt.save_checkpoint(str(tmp_path / "graphed"), 2, graphed)

    fresh = create_glis_state(cfg, device="cpu")
    ckpt.restore_checkpoint(str(tmp_path / "graphed"), fresh)
    group = fresh.opt_g.param_groups[0]
    assert isinstance(group["lr"], float) and not group["capturable"]
    assert_states_equal(fresh, plain)
    a = ckpt.load_checkpoint(str(tmp_path / "plain"))
    b = ckpt.load_checkpoint(str(tmp_path / "graphed"))
    assert a["opt_g"]["param_groups"] == b["opt_g"]["param_groups"]
