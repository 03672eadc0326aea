"""The port's serving slice as a whole: `ServingModel.from_modules(...)
.sample_filtered` against `gea` (live `GeneratorLIS.render`, sigmoid of
`Discriminator.apply`, `to_uint8` and `gea.serve.topk_rounds`) from the same
params and seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.models import Discriminator as JaxDiscriminator
from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.serve import topk_rounds as jax_topk_rounds
from gea_torch import ModelConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.serve import ServingModel, topk_rounds

CFG = ModelConfig(image_size=32, code_size=16, r_iterations=2, num_features=8,
                  max_features=32, dtype="float32")


def jitter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        params,
    )


@pytest.fixture(scope="module")
def models():
    g_params = jitter(init_generator_params(CFG, 0), 1)
    d_params = jitter(init_discriminator_params(CFG, 2), 3)
    port = ServingModel.from_modules(
        generator_from_jax_params(g_params, CFG, device="cpu"),
        discriminator_from_jax_params(d_params, CFG, device="cpu"),
    )
    return port, g_params, d_params


def gea_sample_filtered(g_params, d_params, count, seed, batch_size, oversample):
    """What `gea` serves for the same request: `gea.serve`'s draw order,
    the export's render/score/uint8 functions and `topk_rounds`."""
    g = JaxGeneratorLIS(
        image_size=CFG.image_size, code_size=CFG.code_size,
        r_iterations=CFG.r_iterations, num_features=CFG.num_features,
        max_features=CFG.max_features, dtype=jnp.float32,
    )
    d = JaxDiscriminator(
        image_size=CFG.image_size, num_features=CFG.num_features,
        max_features=CFG.max_features, dtype=jnp.float32,
    )

    def to_uint8(x):
        return jnp.clip((x + 1.0) * 127.5, 0, 255).astype(jnp.uint8)

    @jax.jit
    def serve_fn(z):
        images, _ = g.render({"params": g_params}, z)
        scores = jax.nn.sigmoid(
            d.apply({"params": d_params}, images[-1], train=False)
        ).astype(jnp.float32)
        return {"images": to_uint8(images[-1]), "stages": to_uint8(images),
                "scores": scores}

    def draw(r):
        rng = np.random.default_rng(seed + r)
        n_cand, chunks, done = count * oversample, [], 0
        while done < n_cand:
            n = min(batch_size, n_cand - done)
            z = rng.standard_normal((n, CFG.code_size)).astype(np.float32)
            chunks.append({k: np.asarray(v) for k, v in serve_fn(z).items()})
            done += n
        return {k: np.concatenate([c[k] for c in chunks],
                                  axis=1 if k == "stages" else 0)
                for k in chunks[0]}

    best, _ = jax_topk_rounds(draw, count)
    return best


def test_sample_filtered_matches_gea(models):
    port, g_params, d_params = models
    count, seed, batch_size, oversample = 6, 7, 8, 4
    got = port.sample_filtered(count, seed=seed, batch_size=batch_size,
                               oversample=oversample)
    want = gea_sample_filtered(g_params, d_params, count, seed, batch_size, oversample)
    assert got["images"].dtype == np.uint8
    assert got["images"].shape == (count, 32, 32, 3)
    assert got["stages"].shape == (CFG.r_iterations + 1, count, 32, 32, 3)
    assert got["scores"].dtype == np.float32
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5, rtol=1e-5)
    for k in ("images", "stages"):
        diff = np.abs(got[k].astype(np.int16) - want[k].astype(np.int16))
        assert diff.max() <= 1, k


def test_call_and_sample_shapes(models):
    port = models[0]
    z = np.random.default_rng(0).standard_normal((5, CFG.code_size))
    out = port(z)
    assert out["images"].shape == (5, 32, 32, 3)
    assert out["stages"].shape == (3, 5, 32, 32, 3)
    assert out["scores"].shape == (5,)
    assert ((out["scores"] >= 0) & (out["scores"] <= 1)).all()
    # count not a multiple of the batch: the last batch is short.
    assert port.sample(11, seed=1, batch_size=4)["images"].shape[0] == 11
    with pytest.raises(ValueError, match="z must be"):
        port(np.zeros((2, CFG.code_size + 1)))


@pytest.mark.parametrize("kwargs,match", [
    (dict(count=0), "count"),
    (dict(count=2, oversample=0), "oversample"),
    (dict(count=2, max_rounds=0), "max_rounds"),
])
def test_sample_filtered_argument_checks(models, kwargs, match):
    with pytest.raises(ValueError, match=match):
        models[0].sample_filtered(**kwargs)


def test_sample_filtered_needs_discriminator(models):
    port = ServingModel.from_modules(models[0].exported.generator)
    assert "scores" not in port(np.zeros((1, CFG.code_size)))
    with pytest.raises(ValueError, match="no discriminator"):
        port.sample_filtered(2)


def test_threshold_rounds_keep_the_best(models):
    port = models[0]
    best = port.sample_filtered(4, seed=3, batch_size=8, oversample=2,
                                threshold=1.1, max_rounds=3)
    assert best["images"].shape[0] == 4
    assert np.all(np.diff(best["scores"]) <= 0)


class TiedScores(torch.nn.Module):
    """A stub serve function: images and stages from z, and scores on three
    levels, so that most candidates tie."""

    def forward(self, z):
        images = ((z[:, :12] + 4.0) * 30.0).clamp(0, 255).to(torch.uint8).reshape(-1, 2, 2, 3)
        return {"images": images, "stages": torch.stack([images, 255 - images]),
                "scores": torch.round(torch.sigmoid(z[:, 0]) * 2.0) / 2.0}


@pytest.fixture(scope="module")
def served(models):
    port = models[0]
    g, d = port.exported.generator, port.exported.discriminator
    tied = ServingModel(TiedScores(), {"code_size": CFG.code_size, "batch": 0,
                                       "spatial_noise_shape": None, "gan_loss": "bce",
                                       "outputs": ["images", "stages", "scores"]}, device="cpu")
    return {"stages": port, "final": ServingModel.from_modules(g, d, all_stages=False),
            "ties": tied, "replicas": port.sharded(["cpu", "cpu"]),
            "pinned": ServingModel(port.exported, {**port.manifest, "batch": 4}, device="cpu")}


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("kind", ["stages", "final", "ties", "replicas", "pinned"])
def test_sample_filtered_equals_the_host_composition(served, kind, rounds):
    """The winners chosen and gathered on the device are, bit for bit and in
    order, `topk_rounds` over `sample`'s renders joined on the host: with
    and without every stage, over one round or three (a threshold no score
    clears), with tied scores, on two replicas (a short last batch padded
    to an even split) and with a pinned batch (the last render cut)."""
    model = served[kind]
    count, seed, batch, oversample = 5, 13, 4, 3
    threshold = 0.0 if rounds == 1 else 1.1
    got = model.sample_filtered(count, seed=seed, batch_size=batch, oversample=oversample,
                                threshold=threshold, max_rounds=rounds)
    want, ran = topk_rounds(
        lambda r: model.sample(count * oversample, seed=seed + r, batch_size=batch),
        count, threshold=threshold, max_rounds=rounds)
    assert ran == rounds
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    if kind == "ties":
        assert np.unique(got["scores"]).size < count


def test_dispatch_copies_only_the_named_outputs_to_the_host(served):
    model = served["stages"]
    z = np.random.default_rng(5).standard_normal((3, CFG.code_size)).astype(np.float32)
    some = model.dispatch(z, to_host=("scores",))
    every = model.dispatch(z)
    for k in ("images", "stages"):
        assert isinstance(some[k], torch.Tensor) and some[k].device == model.device, k
    assert not any(isinstance(v, torch.Tensor) for v in every.values())
    assert not isinstance(some["scores"], torch.Tensor)
    for k, v in every.items():
        host = np.asarray(v)
        assert isinstance(host, np.ndarray)
        assert np.array_equal(host, np.asarray(some[k]) if k == "scores" else some[k].numpy()), k
