"""The port's three train steps under `--norm batch` against `gea`'s, in
fp32 on the CPU at the tiny configs of the step tests.

Both sides start from the same jittered params and running statistics
(means off 0, variances off 1), with fresh Adam. `gea` draws its noise
inside its step; the test draws it the same way and feeds the port's step
(`tests/test_torch_port_train.py` says how, and why Adam's first moments
are compared and WGAN-GP's D head bias by its moment). After 1 and after 3
steps the metrics agree to rtol 1e-5, every parameter to atol 1e-5, every
running mean and variance to atol 1e-6 + rtol 1e-5, and Adam's first
moments to rtol 1e-5 + atol 1e-6 times the tensor's largest magnitude (at
least 1): WGAN-GP's critic moments reach about 10, where the fp32 rounding
of its double backward through the batch statistics alone is 1e-6. The running statistics are what this file adds: G's move once a G-LIS
step (a second update would put them at 0.81 r + 0.19 s instead of 0.9 r +
0.1 s), D's twice (real, then fakes), R-separate's R once, R-iterative's G
1 + T times and R's T times.

A conv's bias that feeds a batch norm (every `ups.i.conv`, every
`downs.i.conv` after the first) has a gradient that is zero up to rounding
in train mode: the norm subtracts each channel's batch mean. (`project`'s
bias has one entry per position and channel, and keeps a gradient.) Adam's first update is
about lr * sign(gradient), so such a bias moves by lr one way or the other
on either side. The test holds these biases' first moments to zero up to
rounding on both sides (below 1e-5) and not their values, and copies
`gea`'s values into the port after each step (they enter the running
means).

Also: K = 4 steps through the dispatcher equal 4 eager steps; a
checkpoint resume restores the running statistics; `--grad_accum 2` is
refused with `gea`'s error.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train import draws as glis_draws
from test_torch_port_train import jitter, real_batch

from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.config import TrainRIterativeConfig as JaxTrainRIterativeConfig
from gea.config import TrainRSeparateConfig as JaxTrainRSeparateConfig
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.train.state import GANTrainState
from gea.train.state import create_glis_state as jax_create_glis_state
from gea.train.state import make_optimizer as jax_make_optimizer
from gea.train.steps import _check_accum as jax_check_accum
from gea.train.steps import build_glis_train_step as jax_build_glis_train_step
from gea.train.steps_r import build_r_iterative_step as jax_build_r_iterative_step
from gea.train.steps_r import build_r_separate_step as jax_build_r_separate_step
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    discriminator_state_from_jax_params,
    generator_from_jax_params,
    generator_state_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
    reverter_state_from_jax_params,
)
from gea_torch.ops.layers import batch_norms
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train.dispatch import StepDispatcher
from gea_torch.train.state import generator_config
from gea_torch.utils import checkpoint as ckpt

TINY = dict(image_size=16, code_size=16, r_iterations=1, norm="batch", num_features=4,
            max_features=16, dtype="float32", batch_size=8, lr=1e-3)
GLIS_CASES = {
    "bce": {},
    "wgan-gp": {"gan_loss": "wgan-gp"},
    "remat": {"remat": True},
    "g_ema": {"g_ema": 0.9},
}
STEPS = 3
TO_PORT = {"g": generator_state_from_jax_params, "d": discriminator_state_from_jax_params,
           "r": reverter_state_from_jax_params}
STAT_KEYS = (".mean", ".var")


def is_stat(key: str) -> bool:
    return key.endswith(STAT_KEYS)


def jitter_stats(stats, seed):
    """Running means off 0 and variances off 1 (kept positive)."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        noise = 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
        x = np.asarray(x, np.float32)
        return x * np.exp(noise) if path[-1].key == "var" else x + noise

    return jax.tree_util.tree_map_with_path(move, stats)


def port_layout(host, tag, cfg):
    """A `gea` state's params and running statistics of player `tag`, and
    Adam's first moments, in the port's layout."""
    to_port = TO_PORT[tag]
    stats = (getattr(host, f"extras_{tag}") or {}).get("batch_stats")
    mu = to_port(getattr(host, f"opt_{tag}")[0].mu, cfg)
    return {tag: to_port(getattr(host, f"params_{tag}"), cfg, stats),
            f"mu_{tag}": {k: v for k, v in mu.items() if not is_stat(k)}}


def bn_fed_biases(keys) -> list:
    """The biases of the convs whose output a batch norm takes."""
    keys = set(keys)
    return sorted(k for k in keys if k.endswith(".conv.bias")
                  and k.replace(".conv.bias", ".act.mean") in keys)


def sync_biases(module, want: dict) -> None:
    """Copy `gea`'s values of the batch-norm-fed biases into `module`."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        for k in bn_fed_biases(module.state_dict()):
            params[k].copy_(torch.as_tensor(np.asarray(want[k])))


def port_snapshot(state, metrics, tags):
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    names = dict((tag, name) for name, tag in state.PLAYERS)
    for tag in tags:
        module, opt = getattr(state, names[tag]), getattr(state, f"opt_{tag}")
        out[tag] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        out[f"mu_{tag}"] = {n: opt.state[p]["exp_avg"].clone()
                            for n, p in module.named_parameters()}
    return out


def assert_matches(got, want, tags, skip=()):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for tag in tags:
        assert set(got[tag]) == set(want[tag])
        fed = bn_fed_biases(want[tag])
        assert fed
        for k, v in want[tag].items():
            if k in skip or k in fed:
                continue
            tol = dict(atol=1e-6, rtol=1e-5) if is_stat(k) else dict(atol=1e-5, rtol=0)
            np.testing.assert_allclose(got[tag][k].numpy(), np.asarray(v), **tol,
                                       err_msg=f"{tag} {k}")
        for k, v in want[f"mu_{tag}"].items():
            v = np.asarray(v)
            if k in fed:  # a gradient that is zero up to rounding
                assert max(np.abs(v).max(), got[f"mu_{tag}"][k].abs().max()) < 1e-5, k
                continue
            atol = 1e-6 * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(got[f"mu_{tag}"][k].numpy(), v, atol=atol, rtol=1e-5,
                                       err_msg=f"mu_{tag} {k}")


# ------------------------------------------------------------------ G-LIS


def glis_init():
    cfg = TrainGLISConfig(**TINY)
    return {"g": jitter(init_generator_params(cfg, 0), 1),
            "d": jitter(init_discriminator_params(cfg, 1), 2)}


def gea_glis(kw, steps=STEPS):
    cfg = JaxTrainGLISConfig(**{**TINY, **kw}, dataset="synthetic")
    g, d = JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg)
    txs = [jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for _ in range(2)]
    state = jax_create_glis_state(cfg, g, d, *txs, seed=0)
    init = glis_init()
    stats = {"g": jitter_stats(state.extras_g["batch_stats"], 3),
             "d": jitter_stats(state.extras_d["batch_stats"], 4)}
    state = state.replace(
        params_g=init["g"], params_d=init["d"], extras_g={"batch_stats": stats["g"]},
        extras_d={"batch_stats": stats["d"]}, opt_g=txs[0].init(init["g"]),
        opt_d=txs[1].init(init["d"]),
        params_g_ema=jax.tree_util.tree_map(np.copy, init["g"]) if cfg.g_ema > 0 else {})
    step = jax.jit(jax_build_glis_train_step(cfg, g, d, *txs))
    real = real_batch(cfg)
    out = {"init": init, "stats": stats, "draws": [], "steps": []}
    for _ in range(steps):
        out["draws"].append(glis_draws(state, cfg, g))
        state, metrics = step(state, jnp.asarray(real))
        host = jax.device_get(state)
        snap = {"metrics": {k: float(v) for k, v in metrics.items()}, "state": host,
                **port_layout(host, "g", cfg), **port_layout(host, "d", cfg)}
        if cfg.g_ema > 0:
            snap["ema"] = generator_state_from_jax_params(host.params_g_ema, cfg)
        out["steps"].append(snap)
    return out


def port_glis_state(kw, ref):
    cfg = TrainGLISConfig(**{**TINY, **kw})
    state = create_glis_state(cfg, ref["init"]["g"], ref["init"]["d"], device="cpu",
                              g_stats=ref["stats"]["g"], d_stats=ref["stats"]["d"])
    return cfg, state


def port_glis(kw, ref, sync_head_bias=False):
    cfg, state = port_glis_state(kw, ref)
    step = build_glis_train_step(cfg)
    real = real_batch(cfg)
    out = []
    for i, (z, sn, eps) in enumerate(ref["draws"]):
        snap = port_snapshot(state, step(state, real, z, sn, eps), "gd")
        snap["ema"] = {k: v.clone() for k, v in state.g_ema.items()}
        out.append(snap)
        sync_biases(state.generator, ref["steps"][i]["g"])
        sync_biases(state.discriminator, ref["steps"][i]["d"])
        if sync_head_bias:
            with torch.no_grad():
                state.discriminator.head.bias.copy_(ref["steps"][i]["d"]["head.bias"])
    return out, state


@functools.cache
def glis_runs(case):
    ref = gea_glis(GLIS_CASES[case])
    return ref, port_glis(GLIS_CASES[case], ref, sync_head_bias=case == "wgan-gp")[0]


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("case", list(GLIS_CASES))
def test_glis_step_matches_gea(case, after):
    ref, port = glis_runs(case)
    want, got = ref["steps"][after - 1], port[after - 1]
    skip = ()
    if case == "wgan-gp":
        # D's head bias: a gradient zero up to rounding (compared through
        # its first moment); loss_g moves with it one for one.
        bias = lambda s: float(np.asarray(s["d"]["head.bias"])[0])  # noqa: E731
        got = {**got, "metrics": {**got["metrics"],
                                  "loss_g": got["metrics"]["loss_g"] + bias(got) - bias(want)}}
        skip = ("head.bias",)
    assert_matches(got, want, "gd", skip)
    fed = bn_fed_biases(want["g"])
    for k, v in want.get("ema", {}).items():
        if not is_stat(k) and k not in fed:
            np.testing.assert_allclose(got["ema"][k].numpy(), np.asarray(v), atol=1e-5,
                                       err_msg=f"ema {k}")


def test_glis_running_stats_move_once_a_step():
    """G's statistics after one step are 0.9 r + 0.1 s, s the batch
    statistics of the step's G forward (a second update would leave 0.81 r
    + 0.19 s); D's moved twice, so they differ from one update of either
    population's statistics."""
    ref, port = glis_runs("bce")
    r0 = ref["stats"]["g"]["core"]["project_act"]["BatchNorm_0"]["mean"]
    r1 = port[0]["g"]["project_act.mean"].numpy()
    cfg, state = port_glis_state({}, ref)
    z = torch.from_numpy(ref["draws"][0][0])
    # The S*B batch of the step's render: z0 and z1 stacked.
    with torch.no_grad():
        zs = [z, state.generator.lis[0](z)]
        proj = state.generator.project(torch.cat(zs)).view(-1, state.generator.c0)
    s = proj.mean(0).numpy()
    np.testing.assert_allclose(r1, 0.9 * np.asarray(r0) + 0.1 * s, atol=1e-6, rtol=1e-5)
    assert not np.allclose(r1, 0.81 * np.asarray(r0) + 0.19 * s, atol=1e-6, rtol=1e-5)


def test_glis_k4_dispatch_matches_eager():
    """4 steps as one chunk (`StepDispatcher`, eager body on the CPU) equal
    4 eager steps, running statistics included, bit for bit."""
    ref, _ = glis_runs("bce")
    cfg, eager = port_glis_state({"steps_per_dispatch": 4}, ref)
    _, chunked = port_glis_state({"steps_per_dispatch": 4}, ref)
    step = build_glis_train_step(cfg)
    real = torch.from_numpy(real_batch(cfg))
    torch.manual_seed(0)
    want = [step(eager, real) for _ in range(4)]
    got = StepDispatcher(cfg, step)(chunked, [real] * 4)
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([m[k] for m in want])), k
    for a, b in ((eager.generator, chunked.generator),
                 (eager.discriminator, chunked.discriminator)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert chunked.step == eager.step == 4


def test_checkpoint_resume_restores_running_stats(tmp_path):
    """A saved state's running statistics come back on restore, bit for
    bit, and the restored state takes the next step as the saved one."""
    ref, _ = glis_runs("bce")
    cfg, state = port_glis_state({}, ref)
    step = build_glis_train_step(cfg)
    real = real_batch(cfg)
    step(state, real, *ref["draws"][0])
    ckpt.save_checkpoint(str(tmp_path), 1, state)
    _, fresh = port_glis_state({}, ref)
    restored = ckpt.restore_checkpoint(str(tmp_path), fresh)
    for a, b in ((state.generator, restored.generator),
                 (state.discriminator, restored.discriminator)):
        stats = [k for k in a.state_dict() if is_stat(k)]
        assert stats
        for k in stats:
            assert torch.equal(a.state_dict()[k], b.state_dict()[k]), k
    m1 = step(state, real, *ref["draws"][1])
    m2 = step(restored, real, *ref["draws"][1])
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k


def test_grad_accum_is_refused_with_geas_error():
    kw = {**TINY, "grad_accum": 2}
    with pytest.raises(ValueError) as want:
        jax_check_accum(JaxTrainGLISConfig(**kw, dataset="synthetic"))
    for build, cls in ((build_glis_train_step, TrainGLISConfig),
                       (build_r_separate_step, TrainRSeparateConfig),
                       (build_r_iterative_step, TrainRIterativeConfig)):
        with pytest.raises(ValueError) as got:
            build(cls(**kw))
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------- R-separate


R_TINY = {**TINY, "r_hidden": 32}


def gea_r_separate(steps=STEPS):
    cfg = JaxTrainRSeparateConfig(**R_TINY, dataset="synthetic")
    pcfg = TrainRSeparateConfig(**R_TINY)
    g, d, r = (JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg),
               JaxReverter.from_config(cfg))
    ref = gea_glis({}, steps=0)  # the frozen G and D with moved statistics
    r_params = jitter(init_reverter_params(pcfg, 2), 3)
    r_vars = r.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    r_stats = jitter_stats(r_vars["batch_stats"], 5)
    tx = jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2)
    state = GANTrainState(step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
                          params_g={}, params_d={}, extras_g={}, extras_d={}, opt_g={},
                          opt_d={}, params_r=r_params, extras_r={"batch_stats": r_stats},
                          opt_r=tx.init(r_params))
    step = jax.jit(jax_build_r_separate_step(
        cfg, g, r, {"params": ref["init"]["g"], "batch_stats": ref["stats"]["g"]}, tx,
        discriminator=d,
        frozen_d_variables={"params": ref["init"]["d"], "batch_stats": ref["stats"]["d"]}))
    out = {"frozen": ref, "r": (r_params, r_stats), "draws": [], "steps": []}
    for _ in range(steps):
        z_rng, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))
        out["draws"].append(np.array(jax.random.normal(z_rng, (8, 16), jnp.float32)))
        state, metrics = step(state, jnp.zeros(()))
        host = jax.device_get(state)
        out["steps"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                             **port_layout(host, "r", cfg)})
    return out


@functools.cache
def r_separate_runs():
    ref = gea_r_separate()
    pcfg = TrainRSeparateConfig(**R_TINY)
    frozen = ref["frozen"]
    g = generator_from_jax_params(frozen["init"]["g"], pcfg, device="cpu",
                                  batch_stats=frozen["stats"]["g"])
    d = discriminator_from_jax_params(frozen["init"]["d"], pcfg, device="cpu",
                                      batch_stats=frozen["stats"]["d"])
    before = {k: v.clone() for m in (g, d) for k, v in m.state_dict().items()}
    state = create_r_state(pcfg, g, d, ref["r"][0], device="cpu", r_stats=ref["r"][1])
    step = build_r_separate_step(pcfg)
    port = []
    for z, want in zip(ref["draws"], ref["steps"]):
        port.append(port_snapshot(state, step(state, None, z), "r"))
        sync_biases(state.reverter, want["r"])
    return ref, port, state, before


@pytest.mark.parametrize("after", [1, STEPS])
def test_r_separate_step_matches_gea(after):
    ref, port, _, _ = r_separate_runs()
    assert_matches(port[after - 1], ref["steps"][after - 1], "r")


def test_r_separate_frozen_models_keep_their_stats():
    """The frozen G and D render and score on their running statistics
    and leave them, bit for bit."""
    _, _, state, before = r_separate_runs()
    assert not state.generator.training and not state.discriminator.training
    after = {k: v for m in (state.generator, state.discriminator)
             for k, v in m.state_dict().items()}
    for k, v in before.items():
        assert torch.equal(after[k], v), k


# ------------------------------------------------------------ R-iterative


RI_TINY = {**R_TINY, "r_iterations": 0, "r_chain_length": 2}


def gea_r_iterative(steps=STEPS):
    cfg = JaxTrainRIterativeConfig(**RI_TINY, dataset="synthetic")
    pcfg = TrainRIterativeConfig(**RI_TINY)
    g = JaxGeneratorLIS.from_config(cfg, r_iterations=0)
    d, r = JaxDiscriminator.from_config(cfg), JaxReverter.from_config(cfg)
    params = {"g": jitter(init_generator_params(generator_config(pcfg), 0), 1),
              "d": jitter(init_discriminator_params(pcfg, 1), 2),
              "r": jitter(init_reverter_params(pcfg, 2), 3)}
    key = jax.random.PRNGKey(0)
    stats = {"g": g.init(key, jnp.zeros((1, 16)))["batch_stats"],
             "d": d.init(key, jnp.zeros((1, 16, 16, 3)))["batch_stats"],
             "r": r.init(key, jnp.zeros((1, 16, 16, 3)))["batch_stats"]}
    stats = {k: jitter_stats(v, i) for i, (k, v) in enumerate(stats.items())}
    txs = {k: jax_make_optimizer(cfg.lr, cfg.beta1, cfg.beta2) for k in "gdr"}
    state = GANTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0), params_g=params["g"],
        params_d=params["d"], extras_g={"batch_stats": stats["g"]},
        extras_d={"batch_stats": stats["d"]}, opt_g=txs["g"].init(params["g"]),
        opt_d=txs["d"].init(params["d"]), params_r=params["r"],
        extras_r={"batch_stats": stats["r"]}, opt_r=txs["r"].init(params["r"]))
    step = jax.jit(jax_build_r_iterative_step(cfg, g, d, r, txs["g"], txs["d"], txs["r"]))
    real = real_batch(cfg)
    out = {"params": params, "stats": stats, "draws": [], "steps": []}
    g_cfg = cfg.replace(r_iterations=0)
    for _ in range(steps):
        z_rng, _ = jax.random.split(jax.random.fold_in(state.rng, state.step))
        out["draws"].append(np.array(jax.random.normal(z_rng, (8, 16), jnp.float32)))
        state, metrics = step(state, jnp.asarray(real))
        host = jax.device_get(state)
        out["steps"].append({"metrics": {k: float(v) for k, v in metrics.items()},
                             **port_layout(host, "g", g_cfg), **port_layout(host, "d", cfg),
                             **port_layout(host, "r", cfg)})
    return out


@functools.cache
def r_iterative_runs():
    ref = gea_r_iterative()
    pcfg = TrainRIterativeConfig(**RI_TINY)
    p, s = ref["params"], ref["stats"]
    state = create_r_iterative_state(pcfg, p["g"], p["d"], p["r"], device="cpu",
                                     g_stats=s["g"], d_stats=s["d"], r_stats=s["r"])
    step = build_r_iterative_step(pcfg)
    real = real_batch(pcfg)
    port = []
    for z, want in zip(ref["draws"], ref["steps"]):
        port.append(port_snapshot(state, step(state, real, z), "gdr"))
        for module, tag in ((state.generator, "g"), (state.discriminator, "d"),
                            (state.reverter, "r")):
            sync_biases(module, want[tag])
    return ref, port


@pytest.mark.parametrize("after", [1, STEPS])
def test_r_iterative_step_matches_gea(after):
    ref, port = r_iterative_runs()
    assert_matches(port[after - 1], ref["steps"][after - 1], "gdr")


def test_every_player_has_running_stats():
    """The tiny configs hold batch norm in every model the steps train."""
    cfg, state = port_glis_state({}, glis_runs("bce")[0])
    assert len(list(batch_norms(state.generator))) == 2
    assert len(list(batch_norms(state.discriminator))) == 1


def test_dispatch_warm_up_puts_the_running_stats_back():
    """The tensors a capture's warm-up restores (`updated_tensors`) hold
    every running statistic of the trained players, so the warm-up step's
    statistics are undone with its parameters."""
    from gea_torch.train.dispatch import updated_tensors

    _, state = port_glis_state({}, glis_runs("bce")[0])
    kept = {id(t) for t in updated_tensors(state)}
    stats = [getattr(b, n) for m in (state.generator, state.discriminator)
             for b in batch_norms(m) for n in ("mean", "var")]
    assert len(stats) == 6 and all(id(t) in kept for t in stats)
