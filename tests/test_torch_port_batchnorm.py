"""`--norm batch` in the port's layers, models and entry points against
`gea`'s, on the CPU at tiny configs.

* `BatchNormAct` against `gea`'s `NormAct(norm="batch")` (flax
  `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` + `leaky_relu(0.2)`) in its
  three modes: batch statistics with the running ones updated, batch
  statistics with nothing updated, running statistics. fp32: outputs and
  the new running statistics atol 1e-5. bf16: the outputs atol 1.5e-2 (the
  bf16 render tolerance of `tests/test_torch_port_bf16.py`), the running
  statistics (fp32 in both) atol 1e-5.
* G, D and R from the same flax trees (params and batch_stats, through the
  port's `gea_torch.interop` map, since `gea`'s own bridge refuses batch
  norm), in train mode (outputs and new statistics) and in eval mode: atol
  1e-5 (statistics 1e-6 + rtol 1e-5).
* A sampler's render (`GeneratorLIS.render` in eval mode) against `gea`'s
  `render_all_stages` (`GeneratorLIS.render`, train=False): atol 1e-5.
* The trainer loop's sample grids and FID tracking run every model in
  eval mode, leave the running statistics bit for bit as they were, and
  put the modes back.
* The three trainer CLIs, `sample` and `export_model` with `--norm batch`:
  the artifact renders what the live eval-mode model renders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gea.config import TrainGLISConfig as JaxTrainGLISConfig
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.ops.layers import NormAct as JaxNormAct
from gea_torch.cli import export_model, sample, train_glis, train_r_iterative, train_r_separate
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig
from gea_torch.interop import (
    discriminator_state_from_jax_params,
    generator_state_from_jax_params,
    reverter_state_from_jax_params,
)
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.ops.layers import BatchNormAct, eval_mode, frozen_stats
from gea_torch.serve import ServingModel, load
from gea_torch.train import create_glis_state
from gea_torch.train.runner import TrainLoop, no_input

TINY = dict(image_size=16, code_size=16, r_iterations=2, norm="batch", num_features=4,
            max_features=16, dtype="float32", batch_size=8)
BF16_ATOL = 1.5e-2


def moved(tree, seed):
    """Every leaf moved off its init value (variances kept positive)."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        noise = 0.2 * rng.standard_normal(np.shape(x)).astype(np.float32)
        x = np.asarray(x, np.float32)
        return x * np.exp(noise) if path[-1].key == "var" else x + noise

    return jax.tree_util.tree_map_with_path(move, tree)


# --------------------------------------------------------------- NormAct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["update", "frozen", "eval"])
def test_norm_act_matches_flax(mode, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.random.default_rng(0).standard_normal((6, 5, 5, 8)).astype(np.float32) * 2 + 0.5
    xj = jnp.asarray(x).astype(jdt)
    m = JaxNormAct(norm="batch", dtype=jdt)
    variables = moved(m.init(jax.random.PRNGKey(0), xj, train=True), 1)
    want, new = m.apply(variables, xj, train=mode != "eval", mutable=["batch_stats"])
    bn = variables["params"]["BatchNorm_0"]
    stats = variables["batch_stats"]["BatchNorm_0"]
    port = BatchNormAct(8)
    with torch.no_grad():
        for name, v in (("scale", bn["scale"]), ("bias", bn["bias"]), ("mean", stats["mean"]),
                        ("var", stats["var"])):
            getattr(port, name).copy_(torch.from_numpy(np.asarray(v)))
    xt = torch.from_numpy(x).to(tdt)
    if mode == "eval":
        port.eval()
    with frozen_stats(port) if mode == "frozen" else torch.no_grad():
        got = port(xt)
    assert got.dtype == tdt
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               atol=atol)
    moved_stats = new["batch_stats"]["BatchNorm_0"] if mode == "update" else stats
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(moved_stats[name]),
                                   atol=1e-5, err_msg=name)


def test_norm_act_gradient_matches_flax():
    """The gradient through the batch statistics, w.r.t. the input and the
    scale and bias, in fp32."""
    x = np.random.default_rng(2).standard_normal((4, 3, 3, 8)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal((4, 3, 3, 8)).astype(np.float32)
    m = JaxNormAct(norm="batch")
    variables = moved(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)

    def loss(params, xj):
        out, _ = m.apply({**variables, "params": params}, xj, mutable=["batch_stats"])
        return jnp.sum(out * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    port = BatchNormAct(8)
    bn = variables["params"]["BatchNorm_0"]
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(np.asarray(bn["scale"])))
        port.bias.copy_(torch.from_numpy(np.asarray(bn["bias"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(port.scale.grad.numpy(), np.asarray(gp["BatchNorm_0"]["scale"]),
                               atol=1e-5)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(gp["BatchNorm_0"]["bias"]),
                               atol=1e-5)


def test_eval_mode_puts_modes_back():
    g = GeneratorLIS(TrainGLISConfig(**TINY), device="cpu")
    g.project_act.eval()  # a mixed state comes back as it was
    with eval_mode(g, None):
        assert not any(m.training for m in g.modules())
    assert g.training and not g.project_act.training and g.ups[0].act.training


# ---------------------------------------------------------------- models


def jax_models(norm="batch"):
    cfg = JaxTrainGLISConfig(**{**TINY, "norm": norm}, dataset="synthetic")
    return cfg, (JaxGeneratorLIS.from_config(cfg), JaxDiscriminator.from_config(cfg),
                 JaxReverter.from_config(cfg, hidden=32))


def model_pairs():
    """(gea module, its moved variables, port module, example input) for
    G, D and R."""
    cfg, (g, d, r) = jax_models()
    pcfg = TrainRIterativeConfig(**TINY, r_hidden=32)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4, 16)).astype(np.float32)
    img = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    out = []
    for i, (jm, to_port, cls, x) in enumerate((
            (g, generator_state_from_jax_params, GeneratorLIS, z),
            (d, discriminator_state_from_jax_params, Discriminator, img),
            (r, reverter_state_from_jax_params, Reverter, img))):
        variables = moved(jm.init(key, jnp.asarray(x)), 10 + i)
        pm = cls(pcfg, device="cpu")
        pm.load_state_dict(to_port(variables["params"], pcfg, variables["batch_stats"]),
                           strict=True)
        out.append((jm, variables, pm, x, to_port, pcfg))
    return out


def outputs(o):
    return o[0] if isinstance(o, tuple) else o


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("which", ["generator", "discriminator", "reverter"])
def test_model_forward_matches_gea(which, train):
    jm, variables, pm, x, to_port, pcfg = model_pairs()[
        ["generator", "discriminator", "reverter"].index(which)]
    want, new = jm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])
    pm.train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(outputs(got).float().numpy(), np.asarray(outputs(want)),
                               atol=1e-5)
    want_sd = to_port(variables["params"], pcfg, new["batch_stats"])
    for k, v in pm.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=k)


def test_sampler_render_matches_gea_render_all_stages():
    jm, variables, pm, z, _, _ = model_pairs()[0]
    want_images, want_zs = jm.render(variables, jnp.asarray(z))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with eval_mode(pm), torch.no_grad():
        images, zs = pm.render(torch.from_numpy(z))
    assert images.shape == (3, 4, 16, 16, 3)
    np.testing.assert_allclose(images.numpy(), np.asarray(want_images), atol=1e-5)
    np.testing.assert_allclose(zs.numpy(), np.asarray(want_zs), atol=1e-5)
    assert all(torch.equal(v, pm.state_dict()[k]) for k, v in before.items())


# ------------------------------------------------------- the trainer loop


def test_grids_and_tracking_leave_the_running_stats(tmp_path):
    """Two loop iterations whose step trains nothing, with sample grids
    and FID tracking at each: the running statistics come out bit for bit
    as they went in, and every model is back in train mode."""
    cfg = TrainGLISConfig(**{**TINY, "dataset": "synthetic", "crop_size": 32, "niter": 2,
                             "vis_interval": 1, "fid_interval": 1, "fid_samples": 16,
                             "log_interval": 1, "save_interval": 0, "vis_rows": 2,
                             "save_path": str(tmp_path / "run")})
    state = create_glis_state(cfg, device="cpu")
    with torch.no_grad():
        for m in state.generator.modules():
            if isinstance(m, BatchNormAct):
                m.mean.add_(0.3)
                m.var.mul_(1.7)
    before = {k: v.clone() for m in (state.generator, state.discriminator)
              for k, v in m.state_dict().items()}
    calls = []

    def idle_step(st, reals):
        calls.append(st.generator.training)
        st.step += len(reals)
        return {"loss_d": torch.zeros(()), "loss_g": torch.zeros(())}

    loop = TrainLoop(cfg, cfg.save_path, state, idle_step, no_input(), lambda b, s: None,
                     vis_fn=train_glis.make_vis_fn(cfg, state.generator, cfg.save_path),
                     fid_fn=train_glis.make_fid_fn(cfg, torch.device("cpu")))
    loop.run(0)
    assert calls == [True, True]
    after = {k: v for m in (state.generator, state.discriminator)
             for k, v in m.state_dict().items()}
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert all(m.training for mod in (state.generator, state.discriminator)
               for m in mod.modules())


# ------------------------------------------------------------------ CLIs


COMMON = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size",
          "32", "--code_size", "16", "--num_features", "4", "--max_features", "16",
          "--batch_size", "4", "--dtype", "float32", "--norm", "batch", "--log_interval", "2",
          "--vis_interval", "2", "--save_interval", "2", "--vis_rows", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bn_runs")
    glis = str(root / "glis")
    state, _ = train_glis.main(COMMON + ["--r_iterations", "1", "--niter", "2",
                                         "--save_path", glis])
    rsep = str(root / "rsep")
    train_r_separate.main(["--device", "cpu", "--g_path", glis, "--batch_size", "4",
                           "--niter", "2", "--log_interval", "2", "--vis_interval", "2",
                           "--save_interval", "2", "--vis_rows", "2", "--r_hidden", "16",
                           "--save_path", rsep])
    riter = str(root / "riter")
    train_r_iterative.main(COMMON + ["--r_hidden", "16", "--niter", "2",
                                     "--save_path", riter])
    return {"glis": glis, "rsep": rsep, "riter": riter, "state": state, "root": root}


def test_trainers_train_with_batch_norm(runs):
    """G-LIS moved its running statistics off their initial values; each
    run holds a checkpoint at step 2."""
    import os

    state = runs["state"]
    assert state.step == 2
    assert not torch.equal(state.generator.project_act.mean,
                           torch.zeros_like(state.generator.project_act.mean))
    for name in ("glis", "rsep", "riter"):
        assert os.path.isfile(os.path.join(runs[name], "checkpoints", "2", "state.pt")), name


def test_sample_and_export_with_batch_norm(runs):
    """`sample` writes its grids; `export_model` writes an artifact (its
    selfcheck holds it to the live render), which renders what the live
    eval-mode G renders."""
    sample.main(["--load_path", runs["glis"], "--device", "cpu", "--count", "4",
                 "--batch_size", "4"])
    out = str(runs["root"] / "art")
    export_model.main(["--load_path", runs["glis"], "--out", out, "--device", "cpu",
                       "--platforms", "cpu", "--all_stages", "1"])
    g, _ = sample.load_generator(runs["glis"], device="cpu")
    live = ServingModel.from_modules(g, all_stages=True)
    art = load(out, device="cpu")
    z = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    got, want = art(z), live(z)
    assert np.abs(got["images"].astype(int) - want["images"].astype(int)).max() <= 1


def test_render_is_inference_mode(runs):
    """`GeneratorLIS.render` in train mode renders on the running
    statistics, as `gea`'s `render` (train=False) does, updates none and
    leaves the module in train mode."""
    g, _ = sample.load_generator(runs["glis"], device="cpu")
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32))
    with torch.no_grad():
        want = g.render(z)[0]
        g.train()
        before = {k: v.clone() for k, v in g.state_dict().items()}
        got = g.render(z)[0]
    assert g.training and torch.equal(got, want)
    assert all(torch.equal(v, g.state_dict()[k]) for k, v in before.items())


def test_convert_checkpoint_refuses_batch_norm_as_gea(runs):
    from gea.interop.torch_port import _check_norm as gea_check_norm
    from gea_torch.cli import convert_checkpoint

    with pytest.raises(ValueError) as want:
        gea_check_norm("batch")
    with pytest.raises(SystemExit) as got:
        convert_checkpoint.main(["--load_path", runs["glis"], "--out",
                                 str(runs["root"] / "x.pt")])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("norm", ["batch", "weight", "none"])
def test_interop_maps_both_ways(norm):
    """`*_state_to_jax` inverts `*_state_from_jax_params` on every model,
    and gives the flax tree shapes `gea`'s modules initialise (params and,
    under batch norm, batch_stats)."""
    from gea_torch.interop import (
        discriminator_state_to_jax,
        generator_state_to_jax,
        reverter_state_to_jax,
    )

    _, (g, d, r) = jax_models(norm)
    pcfg = TrainRIterativeConfig(**{**TINY, "norm": norm}, r_hidden=32)
    key = jax.random.PRNGKey(0)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    for jm, x, cls, to_port, to_jax in (
            (g, jnp.zeros((1, 16)), GeneratorLIS, generator_state_from_jax_params,
             generator_state_to_jax),
            (d, jnp.zeros((1, 16, 16, 3)), Discriminator, discriminator_state_from_jax_params,
             discriminator_state_to_jax),
            (r, jnp.zeros((1, 16, 16, 3)), Reverter, reverter_state_from_jax_params,
             reverter_state_to_jax)):
        variables = moved(jm.init(key, x), 3)
        stats = variables.get("batch_stats")
        state = to_port(variables["params"], pcfg, stats)
        cls(pcfg, device="cpu").load_state_dict(state, strict=True)
        params, back_stats = to_jax(state, pcfg)
        assert shapes(params) == shapes(variables["params"])
        assert shapes(back_stats) == shapes(stats or {})
        again = to_port(params, pcfg, back_stats or None)
        assert all(torch.equal(again[k], v) for k, v in state.items())
