"""The port's LISModule, GeneratorLIS.render, Discriminator and Reverter
(with `iterative_chain` and `blend_correction`) against `gea`'s on the same
params (flax init, jittered, converted through `gea_torch.interop`), in
fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.interop.torch_port import (
    discriminator_to_torch_state,
    generator_to_torch_state,
    reverter_to_torch_state,
)
from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.models import Reverter as JaxReverter
from gea.models import reverter as jax_reverter
from gea.models.generator import LISModule as JaxLISModule
from gea_torch import ModelConfig
from gea_torch.config import TrainRIterativeConfig, generator_plan
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
    reverter_state_from_jax_params,
)
from gea_torch.models import Discriminator, GeneratorLIS, LISModule, Reverter
from gea_torch.models import reverter

SMALL = dict(image_size=32, code_size=16, r_iterations=2, num_features=8,
             max_features=32, dtype="float32")


def small_cfg(**kw):
    return ModelConfig(**{**SMALL, **kw})


def jax_models(cfg):
    g = JaxGeneratorLIS(
        image_size=cfg.image_size, code_size=cfg.code_size,
        r_iterations=cfg.r_iterations, norm=cfg.norm,
        num_features=cfg.num_features, max_features=cfg.max_features,
        spatial_code=cfg.spatial_code, dtype=jnp.float32,
    )
    d = JaxDiscriminator(
        image_size=cfg.image_size, norm=cfg.norm,
        num_features=cfg.num_features, max_features=cfg.max_features,
        dtype=jnp.float32,
    )
    return g, d


def jitter(params, seed):
    """Move every param off its init value (scales off 1, slopes off 0.25)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        params,
    )


def spatial_noise(rng, cfg, batch):
    if cfg.spatial_code == 0:
        return None
    s0, _ = generator_plan(cfg.image_size)
    return rng.standard_normal(
        (batch, 2 * s0, 2 * s0, cfg.spatial_code)
    ).astype(np.float32)


@pytest.mark.parametrize("norm", ["weight", "none"])
def test_lis_module_matches_gea(rng, norm):
    code = 16
    z = rng.standard_normal((5, code)).astype(np.float32)
    m = JaxLISModule(code_size=code, norm=norm)
    params = jitter(m.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"], 1)
    want = np.asarray(m.apply({"params": params}, jnp.asarray(z)))

    port = LISModule(code, norm=norm)
    sd = {"fc1.weight_v" if norm == "weight" else "fc1.weight":
          torch.from_numpy(params["fc1_kernel"].T.copy()),
          "fc1.bias": torch.from_numpy(params["fc1_bias"]),
          "fc2.weight_v" if norm == "weight" else "fc2.weight":
          torch.from_numpy(params["fc2_kernel"].T.copy()),
          "fc2.bias": torch.from_numpy(params["fc2_bias"])}
    if norm == "weight":
        sd.update({
            "fc1.weight_g": torch.from_numpy(params["fc1_scale"]).view(-1, 1),
            "fc2.weight_g": torch.from_numpy(params["fc2_scale"]).view(-1, 1),
            "act.a": torch.from_numpy(params["slope"]),
            "act.b": torch.from_numpy(params["translation"]),
        })
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("norm,spatial_code,image_size", [
    ("weight", 0, 32), ("weight", 3, 32), ("none", 0, 32), ("none", 3, 32),
    ("weight", 0, 8),  # one doubling: no up1, so no seed kernel
])
def test_generator_render_matches_gea(rng, norm, spatial_code, image_size):
    cfg = small_cfg(norm=norm, spatial_code=spatial_code, image_size=image_size)
    g, _ = jax_models(cfg)
    z = rng.standard_normal((3, cfg.code_size)).astype(np.float32)
    sn = spatial_noise(rng, cfg, 3)
    sn_j = None if sn is None else jnp.asarray(sn)
    params = jitter(init_generator_params(cfg, 0), 2)
    want_imgs, want_zs = g.render({"params": params}, jnp.asarray(z), sn_j)

    port = generator_from_jax_params(params, cfg, device="cpu")
    with torch.no_grad():
        imgs, zs = port.render(
            torch.from_numpy(z), None if sn is None else torch.from_numpy(sn)
        )
    assert imgs.dtype == torch.float32 and imgs.shape == want_imgs.shape
    np.testing.assert_allclose(imgs.numpy(), np.asarray(want_imgs), atol=1e-4)
    np.testing.assert_allclose(zs.numpy(), np.asarray(want_zs), atol=1e-4)


@pytest.mark.parametrize("norm", ["weight", "none"])
def test_discriminator_matches_gea(rng, norm):
    cfg = small_cfg(norm=norm)
    _, d = jax_models(cfg)
    x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    params = jitter(init_discriminator_params(cfg, 1), 3)
    want = np.asarray(d.apply({"params": params}, jnp.asarray(x), train=False))

    port = discriminator_from_jax_params(params, cfg, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("spatial_code", [0, 3])
def test_gea_torch_state_loads_strict(spatial_code):
    """`gea.interop.torch_port`'s state_dicts load into the port's modules
    with strict=True and give the same forward as the port's own mapping."""
    cfg = small_cfg(spatial_code=spatial_code)
    g_params = jitter(init_generator_params(cfg, 0), 4)
    d_params = jitter(init_discriminator_params(cfg, 1), 5)

    port_g = GeneratorLIS(cfg, device="cpu")
    port_g.load_state_dict(generator_to_torch_state(g_params, cfg), strict=True)
    port_d = Discriminator(cfg, device="cpu")
    port_d.load_state_dict(discriminator_to_torch_state(d_params, cfg), strict=True)

    ours = generator_from_jax_params(g_params, cfg, device="cpu")
    for k, v in ours.state_dict().items():
        torch.testing.assert_close(port_g.state_dict()[k], v, rtol=0, atol=0)
    ours_d = discriminator_from_jax_params(d_params, cfg, device="cpu")
    for k, v in ours_d.state_dict().items():
        torch.testing.assert_close(port_d.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("spatial_code", [0, 3])
def test_init_params_have_flax_tree(spatial_code):
    """The seeded numpy trees have the structure and shapes of flax's, so
    the parity tests above can feed them to `gea`'s modules."""
    cfg = small_cfg(spatial_code=spatial_code)
    g, d = jax_models(cfg)
    z = jnp.zeros((1, cfg.code_size))
    sn = None if spatial_code == 0 else jnp.zeros((1, 8, 8, spatial_code))
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    key = jax.random.PRNGKey(0)
    assert shapes(init_generator_params(cfg, 0)) == shapes(
        jax.eval_shape(g.init, key, z, sn)["params"]
    )
    assert shapes(init_discriminator_params(cfg, 0)) == shapes(
        jax.eval_shape(d.init, key, jnp.zeros((1, 32, 32, 3)))["params"]
    )


def test_norm_batch_is_not_ported():
    """The name predates the port of `norm=batch`: G and D now build with
    batch norm (no longer raising), G's seed off the fused kernel as in
    `gea`, and load the interop's batch-norm state_dicts strictly."""
    from gea_torch.interop import (
        discriminator_state_from_jax_params,
        generator_state_from_jax_params,
    )
    from gea_torch.ops.layers import BatchNormAct, batch_norms

    cfg = small_cfg(norm="batch")
    g = GeneratorLIS(cfg, device="cpu")
    d = Discriminator(cfg, device="cpu")
    assert not g.seed_kernel and isinstance(g.project_act, BatchNormAct)
    assert len(list(batch_norms(g))) == g.d and len(list(batch_norms(d))) == g.d - 1
    g.load_state_dict(generator_state_from_jax_params(init_generator_params(cfg, 0), cfg),
                      strict=True)
    d.load_state_dict(discriminator_state_from_jax_params(init_discriminator_params(cfg, 0),
                                                          cfg), strict=True)


def test_default_device_needs_cuda(monkeypatch):
    """Built with the default device, the models run on CUDA or raise; they
    never fall back to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GeneratorLIS(small_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Discriminator(small_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Reverter(small_cfg())


def jax_reverter_model(cfg, hidden):
    return JaxReverter(image_size=cfg.image_size, code_size=cfg.code_size, norm=cfg.norm,
                       num_features=cfg.num_features, max_features=cfg.max_features,
                       hidden=hidden, dtype=jnp.float32)


@pytest.mark.parametrize("norm", ["weight", "none"])
def test_reverter_matches_gea(rng, norm):
    """The port's Reverter (trunk, fc1, the head's TPReLU on (B, hidden),
    fc2) against `gea`'s, from its own mapping and from `gea`'s
    `reverter_to_torch_state` loaded with strict=True; fp32 output."""
    cfg = TrainRIterativeConfig(**{**SMALL, "norm": norm, "r_hidden": 24})
    x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    params = jitter(init_reverter_params(cfg, 2), 3)
    want = np.asarray(jax_reverter_model(cfg, 24).apply({"params": params}, jnp.asarray(x)))

    ours, theirs = Reverter(cfg, device="cpu"), Reverter(cfg, device="cpu")
    ours.load_state_dict(reverter_state_from_jax_params(params, cfg), strict=True)
    theirs.load_state_dict(reverter_to_torch_state(params, cfg), strict=True)
    for port in (ours, theirs):
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (4, cfg.code_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("norm", ["weight", "none"])
def test_init_reverter_params_have_flax_tree(norm):
    cfg = small_cfg(norm=norm)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    want = jax.eval_shape(jax_reverter_model(cfg, 512).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))["params"]
    assert shapes(init_reverter_params(cfg, 0)) == shapes(want)


def test_blend_correction_matches_gea(rng):
    z, z_hat = (rng.standard_normal((5, 16)).astype(np.float32) for _ in range(2))
    for strength, renorm in ((0.3, True), (0.7, False)):
        want = jax_reverter.blend_correction(jnp.asarray(z), jnp.asarray(z_hat), strength, renorm)
        got = reverter.blend_correction(torch.from_numpy(z), torch.from_numpy(z_hat), strength,
                                        renorm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spatial_code", [0, 3])
def test_iterative_chain_matches_gea(rng, spatial_code):
    """The unrolled chain z_t = z_{t-1} + R(G(z_{t-1})) of a single-stage
    generator, 2 links: every link's image."""
    cfg = small_cfg(r_iterations=0, spatial_code=spatial_code)
    g, _ = jax_models(cfg)
    r = jax_reverter_model(cfg, 512)
    z = rng.standard_normal((3, cfg.code_size)).astype(np.float32)
    sn = spatial_noise(rng, cfg, 3)
    g_params = jitter(init_generator_params(cfg, 0), 4)
    r_params = jitter(init_reverter_params(cfg, 1), 5)
    want = jax_reverter.iterative_chain(g, r, {"params": g_params}, {"params": r_params},
                                        jnp.asarray(z), None if sn is None else jnp.asarray(sn),
                                        2)
    port_g = generator_from_jax_params(g_params, cfg, device="cpu")
    port_r = Reverter(cfg, device="cpu")
    port_r.load_state_dict(reverter_state_from_jax_params(r_params, cfg), strict=True)
    with torch.no_grad():
        got = reverter.iterative_chain(port_g, port_r, torch.from_numpy(z),
                                       None if sn is None else torch.from_numpy(sn), 2)
    assert got.shape == (3, 3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
