"""The plain reference against `gea_torch`'s plain path on the CPU at a tiny
size, in fp32: the generator's every stage, D's logits, the served answer
(final-stage uint8 images and scores), the synthetic batches, and three
alternating train steps with Adam's moments. The test may import both;
the reference imports neither `gea` nor `gea_torch`."""

import numpy as np
import pytest
import torch

import benchcopy
from portbench import compare, reference
from portbench.loops import build_models

M = dict(benchcopy.TINY)


def models(m, seed=3):
    from gea_torch.config import ModelConfig

    names = set(ModelConfig.__dataclass_fields__)
    cfg = ModelConfig(**{k: v for k, v in m.items() if k in names})
    return (cfg, *build_models(cfg, seed, torch.device("cpu")))


@pytest.mark.parametrize("spatial_code", [0, 2])
def test_generator_and_discriminator(spatial_code):
    m = dict(M, spatial_code=spatial_code)
    cfg, g, d, w = models(m)
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((5, m["code_size"]), generator=gen)
    sn_shape = g.spatial_noise_shape(5)
    sn = torch.randn(sn_shape, generator=gen) if sn_shape else None
    with torch.no_grad():
        images, _ = g(z, sn)
        want = reference.generator(w["g"], z, sn, m)
        torch.testing.assert_close(images, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(d(images[-1]), reference.discriminator(w["d"], want[-1], m),
                                   rtol=1e-4, atol=1e-5)


def test_served_answer():
    from gea_torch.serve import ServingModel

    m = dict(M, spatial_code=2)
    cfg, g, d, w = models(m)
    served = ServingModel.from_modules(g, d, all_stages=False)
    rng = np.random.default_rng(7)
    z = rng.standard_normal((6, m["code_size"])).astype(np.float32)
    sn = rng.standard_normal((6, *served.spatial_noise_shape)).astype(np.float32)
    out = served(z, sn)
    with torch.no_grad():
        x = reference.render_final(w["g"], torch.from_numpy(z), torch.from_numpy(sn), m)
        want_u8 = reference.to_uint8(x).numpy()
        want_s = reference.score(w["d"], x, m).numpy()
    assert np.abs(out["images"].astype(int) - want_u8.astype(int)).max() <= 1
    np.testing.assert_allclose(out["scores"], want_s, rtol=1e-5, atol=1e-6)


def test_top_k_matches_served_filter():
    from gea_torch.serve import ServingModel

    m = dict(M, spatial_code=2)
    cfg, g, d, w = models(m)
    served = ServingModel.from_modules(g, d, all_stages=False)
    out = served.sample_filtered(4, seed=11, batch_size=4, oversample=3)
    rng = np.random.default_rng(11)
    zs, sns = [], []
    for n in (4, 4, 4):
        zs.append(rng.standard_normal((n, m["code_size"])).astype(np.float32))
        sns.append(rng.standard_normal((n, *served.spatial_noise_shape)).astype(np.float32))
    with torch.no_grad():
        x = reference.render_final(w["g"], torch.from_numpy(np.concatenate(zs)),
                                   torch.from_numpy(np.concatenate(sns)), m)
        scores = reference.score(w["d"], x, m)
    top = reference.top_k(scores, 4)
    numbers = compare.filter_numbers(torch.from_numpy(out["images"]),
                                     torch.from_numpy(out["scores"]),
                                     reference.to_uint8(x), scores, 4)
    assert numbers["structure"] == 0 and numbers["regret"] == 0
    np.testing.assert_allclose(out["scores"], scores[top].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 17])
def test_synthetic_batches(step):
    from gea_torch.config import TrainGLISConfig
    from gea_torch.train.runner import make_input_fn

    cfg = TrainGLISConfig(dataset="synthetic", synthetic_on_device=True, seed=2147483713,
                          batch_size=3, image_size=16, device="cpu")
    got = make_input_fn(cfg, torch.device("cpu"))(None, step)
    want = reference.synthetic_reals(2147483713, step, 3, 16, torch.device("cpu"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_three_train_steps():
    from gea_torch.config import TrainGLISConfig
    from gea_torch.train.state import GLISTrainState, make_optimizer
    from gea_torch.train.steps import build_glis_train_step

    cfg = TrainGLISConfig(**M, device="cpu", seed=5)
    _, g, d, w = models(M, seed=5)
    opt_g, _ = make_optimizer(g.parameters(), cfg.lr, cfg.beta1, cfg.beta2)
    opt_d, _ = make_optimizer(d.parameters(), cfg.lr, cfg.beta1, cfg.beta2)
    state = GLISTrainState(g, d, opt_g, opt_d, None, None, torch.Generator().manual_seed(5))
    step = build_glis_train_step(cfg)
    gen = torch.Generator().manual_seed(9)
    reals = [torch.rand((4, 32, 32, 3), generator=gen) * 2 - 1 for _ in range(3)]
    zs = [torch.randn((4, 16), generator=gen) for _ in range(3)]
    got = [{k: float(v) for k, v in step(state, r, z).items()} for r, z in zip(reals, zs)]
    want = reference.train_steps(w["g"], w["d"], reals, zs, [None] * 3, M, M)
    for a, b in zip(got, want["metrics"]):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-6)
    for who, module, opt in (("g", g, opt_g), ("d", d, opt_d)):
        for n, p in module.named_parameters():
            torch.testing.assert_close(p.detach(), want["params"][who][n], rtol=1e-4, atol=1e-6)
            torch.testing.assert_close(opt.state[p]["exp_avg"], want["moments"][who][n],
                                       rtol=1e-4, atol=1e-7)
