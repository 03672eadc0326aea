"""The port's G-LIS train step against `gea`'s `build_glis_train_step`, in
fp32 on the CPU, at the tiny config of `tests/test_train_step.py`.

Both sides start from the same jittered params with fresh Adam. `gea`
draws z, spatial noise and the gradient penalty's eps inside its step from
`fold_in(state.rng, state.step)`; the test draws them the same way and
feeds them to the port's step. After 1 and after 3 steps the metrics agree
to rtol 1e-5 and every parameter of G and D (and the EMA shadow) to atol
1e-5, `gea`'s mapped through `gea.interop.torch_port`.

Adam's first update is about lr * sign(g) wherever |g| >> eps = 1e-8, so
after one step the parameters show the signs of the gradients and little
more: Adam's first moments (averages of the gradients) are compared too, to
atol 1e-6 beside rtol 1e-5.

A gradient that is zero up to rounding flips the sign of an update on one
side only. Under the hinge and WGAN objectives D's head bias has such a
gradient: the real and the fake terms cancel exactly, as the stage weights
sum to 1. For those two cases the test compares that bias's gradient (its
first moment) and not its value, copies `gea`'s value into the port before
the next step, and compares loss_g + bias, since loss_g = -mean(logits)
moves with the bias one for one. That sum is a mean of logits of about 0.1
that cancels to a few 1e-3, so it gets atol 1e-6 beside rtol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.interop.torch_port import discriminator_to_torch_state, generator_to_torch_state
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.train import losses as jax_losses
from gea.train.state import create_glis_state as jax_create_glis_state
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step
from gea_torch.config import TrainGLISConfig
from gea_torch.interop import glis_state_from_jax
from gea_torch.train import build_glis_train_step, create_glis_state, losses
from gea_torch.train.state import lr_factor

TINY = dict(image_size=16, code_size=16, r_iterations=1, norm="weight", num_features=4,
            max_features=16, dtype="float32", batch_size=8, lr=1e-3)
CASES = {
    "bce": {},
    "hinge": {"gan_loss": "hinge"},
    "wgan-gp": {"gan_loss": "wgan-gp"},
    "spatial_code": {"spatial_code": 3},
    "g_ema": {"g_ema": 0.9},
    "two_forward": {"share_g_forward": False},
    "remat": {"remat": True},
    "grad_accum": {"grad_accum": 2},
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


def real_batch(cfg):
    return np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def draws(state, cfg, generator):
    """z, spatial noise and GP eps exactly as `gea/train/steps.py` draws them."""
    step_rng = jax.random.fold_in(state.rng, state.step)
    z_rng, sn_rng, gp_rng = jax.random.split(step_rng, 3)
    batch = cfg.batch_size
    z = np.array(jax.random.normal(z_rng, (batch, cfg.code_size), jnp.float32))
    sn_shape = generator.spatial_noise_shape(batch)
    sn = None if not sn_shape else np.array(jax.random.normal(sn_rng, sn_shape, jnp.float32))
    eps = np.array(jax.random.uniform(gp_rng, (batch, 1, 1, 1), jnp.float32))
    return z, sn, eps


def _flat_moments(opt_state):
    """Adam's first moments from an optax adam state (with or without a
    schedule)."""
    return opt_state[0].mu


def gea_run(kw, steps=STEPS, dtype="float32", **model_kw):
    """`gea`'s step from jittered params: per step, (metrics, G and D params
    and first moments in the port's layout, the EMA) and the draws fed."""
    kw = dict(kw)
    share = kw.pop("share_g_forward", None)
    cfg = JaxTrainGLISConfig(**{**TINY, "dtype": dtype, **kw}, dataset="synthetic")
    g = JaxGeneratorLIS.from_config(cfg, **model_kw)
    d = JaxDiscriminator.from_config(cfg)
    txs = [jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2, schedule=cfg.lr_schedule,
                              total_steps=cfg.niter, lr_final=cfg.lr_final) for _ in range(2)]
    state = jax_create_glis_state(cfg, g, d, *txs, seed=0)
    params_g = jitter(state.params_g, 1)
    params_d = jitter(state.params_d, 2)
    state = state.replace(
        params_g=params_g, params_d=params_d, opt_g=txs[0].init(params_g),
        opt_d=txs[1].init(params_d),
        params_g_ema=jax.tree_util.tree_map(np.copy, params_g) if cfg.g_ema > 0 else {},
    )
    step = jax.jit(jax_build_glis_train_step(cfg, g, d, *txs, share_g_forward=share))
    real = real_batch(cfg)
    out = {"params_g": params_g, "params_d": params_d, "draws": [], "steps": []}
    for _ in range(steps):
        out["draws"].append(draws(state, cfg, g))
        state, metrics = step(state, jnp.asarray(real))
        out["steps"].append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "g": generator_to_torch_state(jax.device_get(state.params_g), cfg),
            "d": discriminator_to_torch_state(jax.device_get(state.params_d), cfg),
            "mu_g": generator_to_torch_state(jax.device_get(_flat_moments(state.opt_g)), cfg),
            "mu_d": discriminator_to_torch_state(jax.device_get(_flat_moments(state.opt_d)), cfg),
            "ema": (generator_to_torch_state(jax.device_get(state.params_g_ema), cfg)
                    if cfg.g_ema > 0 else {}),
            "state": jax.device_get(state),
        })
    return out


# Cases whose D head bias has a gradient that is zero up to rounding.
NOISE_BIAS = ("hinge", "wgan-gp")


def port_run(kw, ref, steps=STEPS, dtype="float32", sync_head_bias=False):
    """The port's step from the same params, fed `gea`'s draws; with
    `sync_head_bias`, D's head bias takes `gea`'s value after each step."""
    kw = dict(kw)
    share = kw.pop("share_g_forward", True)
    cfg = TrainGLISConfig(**{**TINY, "dtype": dtype, **kw})
    state = create_glis_state(cfg, ref["params_g"], ref["params_d"], device="cpu")
    step = build_glis_train_step(cfg, share_g_forward=share)
    real = real_batch(cfg)
    out = []
    for i, (z, sn, eps) in enumerate(ref["draws"][:steps]):
        metrics = step(state, real, z, sn, eps)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "g": state.generator.state_dict(),
            "d": state.discriminator.state_dict(),
            "mu_g": _moments(state.opt_g, state.generator),
            "mu_d": _moments(state.opt_d, state.discriminator),
            "ema": state.g_ema,
            "state": state,
        })
        out[-1] = {k: (v if k in ("metrics", "state") else _clone(v)) for k, v in out[-1].items()}
        if sync_head_bias:
            with torch.no_grad():
                state.discriminator.head.bias.copy_(ref["steps"][i]["d"]["head.bias"])
    return out


def _clone(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def _moments(opt, module):
    return {n: opt.state[p]["exp_avg"] for n, p in module.named_parameters()}


@functools.cache
def runs(case):
    ref = gea_run(CASES[case])
    return ref, port_run(CASES[case], ref, sync_head_bias=case in NOISE_BIAS)


def assert_state_close(got, want, what, skip=()):
    for k in want:
        if k not in skip:
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_gea(case, after):
    ref, port = runs(case)
    want, got = ref["steps"][after - 1], port[after - 1]
    metrics = dict(got["metrics"])
    atol = dict.fromkeys(metrics, 0.0)
    if case in NOISE_BIAS:
        bias = lambda s: float(np.asarray(s["d"]["head.bias"])[0])  # noqa: E731
        metrics["loss_g"] += bias(got) - bias(want)
        atol["loss_g"] = 1e-6
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=atol[k], err_msg=k)
    for part in ("mu_g", "mu_d"):
        for k in want[part]:
            np.testing.assert_allclose(got[part][k].numpy(), np.asarray(want[part][k]),
                                       atol=1e-6, rtol=1e-5, err_msg=f"{part} {k}")
    assert_state_close(got["g"], want["g"], "G")
    assert_state_close(got["d"], want["d"], "D",
                       skip=("head.bias",) if case in NOISE_BIAS else ())
    if CASES[case].get("g_ema"):
        assert set(got["ema"]) == set(got["g"])
        assert_state_close(got["ema"], want["ema"], "EMA")


@pytest.mark.parametrize("case", ["bce", "cosine", "g_ema", "spatial_code"])
def test_state_carried_from_gea_takes_the_same_step(case):
    """`gea`'s whole state after 2 steps (params, optax's Adam state with
    its count, the step, the EMA), carried into the port by
    `glis_state_from_jax`, takes step 3 from the same draws as `gea` did:
    metrics rtol 1e-5, parameters atol 1e-5, both Adam moments atol 1e-6 +
    rtol 1e-5."""
    ref, _ = runs(case)
    cfg = TrainGLISConfig(**{**TINY, **CASES[case]})
    state = glis_state_from_jax(ref["steps"][1]["state"], cfg, device="cpu")
    assert state.step == 2
    for opt, module in ((state.opt_g, state.generator), (state.opt_d, state.discriminator)):
        assert all(float(opt.state[p]["step"]) == 2 for p in module.parameters())
    z, sn, eps = ref["draws"][2]
    metrics = build_glis_train_step(cfg)(state, real_batch(cfg), z, sn, eps)
    want = ref["steps"][2]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=k)
    assert_state_close(state.generator.state_dict(), want["g"], "G")
    assert_state_close(state.discriminator.state_dict(), want["d"], "D")
    adam = {"g": (want["state"].opt_g[0], state.opt_g, state.generator,
                  generator_to_torch_state),
            "d": (want["state"].opt_d[0], state.opt_d, state.discriminator,
                  discriminator_to_torch_state)}
    for part, (jax_adam, opt, module, to_torch) in adam.items():
        jcfg = JaxTrainGLISConfig(**{**TINY, **CASES[case]}, dataset="synthetic")
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            ref_m = to_torch(getattr(jax_adam, moment), jcfg)
            for n, p in module.named_parameters():
                np.testing.assert_allclose(opt.state[p][key].numpy(), np.asarray(ref_m[n]),
                                           atol=1e-6, rtol=1e-5, err_msg=f"{part} {moment} {n}")
    if cfg.lr_schedule != "constant":
        factor = lr_factor(cfg.lr_schedule, cfg.niter, cfg.lr_final)
        for opt in (state.opt_g, state.opt_d):
            np.testing.assert_allclose(opt.param_groups[0]["lr"], cfg.lr * factor(3), rtol=1e-9)
    if cfg.g_ema > 0:
        assert_state_close(state.g_ema, want["ema"], "EMA")


def test_grad_accum_matches_one_microbatch():
    """grad_accum=2 in the port against the port's own K=1 step on the same
    draws: the same update, summed over two halves."""
    ref, k2 = runs("grad_accum")
    k1 = port_run({}, ref)
    for a, b in zip(k1, k2):
        for k, v in a["metrics"].items():
            np.testing.assert_allclose(b["metrics"][k], v, rtol=1e-5, err_msg=k)
        for part in ("g", "d"):
            for k, v in a[part].items():
                torch.testing.assert_close(b[part][k], v, atol=1e-5, rtol=0)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_lr_factor_matches_optax_schedule(schedule):
    """The LambdaLR factor of update n against optax's schedule at count n,
    past the end of the decay too."""
    import optax

    lr, total, final = 1e-3, 8, 0.1
    sched = (optax.cosine_decay_schedule(lr, total, alpha=final) if schedule == "cosine"
             else optax.linear_schedule(lr, final * lr, total))
    factor = lr_factor(schedule, total, final)
    for n in range(total + 3):
        np.testing.assert_allclose(lr * factor(n), float(sched(n)), rtol=1e-6)


def test_cosine_schedule_drives_the_optimizer():
    """The port's optimizer follows the schedule: after the 3 steps of the
    cosine case, its lr is the factor of update 3 (the end of the decay)."""
    _, port = runs("cosine")
    state = port[-1]["state"]
    for opt in (state.opt_g, state.opt_d):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], TINY["lr"] * 0.1, rtol=1e-9)
    assert state.step == STEPS


def test_every_parameter_gets_a_gradient():
    """After a BCE step every parameter of G and D has a finite, non-zero
    gradient."""
    _, port = runs("bce")
    state = port[0]["state"]
    for m in (state.generator, state.discriminator):
        for n, p in m.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), n
            assert p.grad.abs().max() > 0, n


def test_own_draws_are_seeded():
    """Without z given, the step draws from the state's generator: two
    states with one seed take the same step, two seeds different ones."""
    cfg = TrainGLISConfig(**TINY)
    real = real_batch(cfg)
    loss = []
    for seed in (0, 0, 1):
        state = create_glis_state(cfg, seed=seed, device="cpu")
        loss.append(float(build_glis_train_step(cfg)(state, real)["loss_g"]))
    assert loss[0] == loss[1] != loss[2]


def test_bf16_step_metrics_match_gea_fused_seed():
    """One bf16 step of the port against `gea`'s with `fused_seed=True`
    (whose seed segment rounds where the port's does), on the same params
    and draws. Measured gap (CPU): at most 2.3e-4 on loss_d of 1.34 (1.7e-4
    relative); `gea`'s own bf16 and fp32 steps differ by 3.5e-4 there.
    Tolerance rtol 1e-3."""
    ref = gea_run({}, steps=1, dtype="bfloat16", fused_seed=True)
    got = port_run({}, ref, steps=1, dtype="bfloat16")[0]
    for k, v in ref["steps"][0]["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-3, err_msg=k)
    for m in (got["g"], got["d"]):
        assert all(v.dtype == torch.float32 for v in m.values())


LOSSES = ["d_real_loss", "d_fake_loss", "g_adv_loss", "hinge_d_real", "hinge_d_fake", "hinge_g",
          "wgan_d_real", "wgan_d_fake", "wgan_g", "z_similarity_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_gradient_match_gea(rng, name):
    """Each loss and its gradient on the same logits (some exactly 0 and
    +-1, where max and relu have their ties), in fp32."""
    x = np.concatenate([rng.standard_normal(13), [0.0, 1.0, -1.0]]).astype(np.float32)
    want, want_g = jax.value_and_grad(getattr(jax_losses, name))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = getattr(losses, name)(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-8)


def test_staged_apply_and_gradient_penalty_match_gea(rng):
    """`staged_apply` with the stage weights, and the WGAN-GP penalty of a
    quadratic critic (so its double backward is not constant), with their
    gradients with respect to the critic's weight, against `gea`."""
    logits = rng.standard_normal((4, 6)).astype(np.float32)
    weights = (0.1, 0.2, 0.3, 0.4)
    want = jax_losses.staged_apply(jax_losses.g_adv_loss, jnp.asarray(logits), weights)
    got = losses.staged_apply(losses.g_adv_loss, torch.from_numpy(logits), weights)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    real, fake = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    eps = rng.random((3, 1, 1, 1)).astype(np.float32)
    w = rng.standard_normal((4, 4, 2)).astype(np.float32)

    def gp_jax(w_):
        critic = lambda x: jnp.sum((x * w_) ** 2, axis=(1, 2, 3))  # noqa: E731
        return jax_losses.gradient_penalty(critic, jnp.asarray(real), jnp.asarray(fake),
                                           eps=jnp.asarray(eps))

    want, want_g = jax.value_and_grad(gp_jax)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = losses.gradient_penalty(lambda x: ((x * wt) ** 2).sum(dim=(1, 2, 3)),
                                  torch.from_numpy(real), torch.from_numpy(fake),
                                  torch.from_numpy(eps))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_norm_batch_accum_is_refused():
    with pytest.raises(ValueError, match="grad_accum"):
        build_glis_train_step(TrainGLISConfig(**{**TINY, "norm": "batch", "grad_accum": 2}))
