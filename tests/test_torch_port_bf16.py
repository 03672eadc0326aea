"""The bf16 rounding points of the port's plain versions against `gea`'s
Pallas kernels run in interpret mode in bf16, on the same numpy inputs, and
a bf16 render of the port's generator against `gea`'s.

The CUDA kernels are held against these plain versions on the card
(`chip_smoke.py`), so this pins the rounding points that the kernels must
keep: products accumulated in fp32, the TPReLU in fp32, the hidden row (LIS)
or seed map (seed) rounded to bf16 before the second product, and the
result rounded to bf16 (LIS: before the residual add).

Tolerance: |port - gea| <= 1e-3 + 2^-7 |gea|. The two sum in different
orders in fp32, which can flip a rounding to bf16: one bf16 step (2^-8
relative) on an intermediate and one more on the result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.models import GeneratorLIS as JaxGeneratorLIS
from gea.ops.pallas.lis import lis_residual_mlp as jax_lis
from gea.ops.pallas.seed import fused_seed as jax_seed
from gea_torch import ModelConfig, ops
from gea_torch.interop import generator_from_jax_params, init_generator_params

ATOL, RTOL = 1e-3, 2.0**-7


def _bf16_pair(x):
    """The same values as a bf16 jax array and a bf16 torch tensor."""
    return jnp.asarray(x, dtype=jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _f32_pair(x):
    return jnp.asarray(x), torch.from_numpy(x)


def _check(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=ATOL, rtol=RTOL
    )


@pytest.mark.parametrize("batch,code,hidden", [(16, 128, 128), (30, 256, 512)])
def test_lis_bf16_matches_pallas(rng, batch, code, hidden):
    z = rng.standard_normal((batch, code), dtype=np.float32)
    w1 = rng.standard_normal((code, hidden), dtype=np.float32) * 0.1
    b1 = rng.standard_normal(hidden, dtype=np.float32) * 0.1
    slope = rng.random(hidden, dtype=np.float32) * 0.5
    trans = rng.standard_normal(hidden, dtype=np.float32) * 0.1
    w2 = rng.standard_normal((hidden, code), dtype=np.float32) * 0.1
    b2 = rng.standard_normal(code, dtype=np.float32) * 0.1
    (zj, zt), (w1j, w1t), (w2j, w2t) = map(_bf16_pair, (z, w1, w2))
    (b1j, b1t), (aj, at), (tj, tt), (b2j, b2t) = map(_f32_pair, (b1, slope, trans, b2))
    want = jax_lis(zj, w1j, b1j, aj, tj, w2j, b2j, True)
    got = ops.lis_residual_mlp(zt, w1t, b1t, at, tt, w2t, b2t)
    _check(got, want)


@pytest.mark.parametrize("s0,c0,c1,batch,code", [(5, 64, 32, 7, 16), (4, 128, 64, 33, 32)])
def test_seed_bf16_matches_pallas(rng, s0, c0, c1, batch, code):
    z = rng.standard_normal((batch, code), dtype=np.float32)
    wp = rng.standard_normal((code, s0 * s0 * c0), dtype=np.float32) * 0.05
    bp = rng.standard_normal(s0 * s0 * c0, dtype=np.float32) * 0.1
    slope = rng.random(c0, dtype=np.float32) * 0.4 + 0.1
    trans = rng.standard_normal(c0, dtype=np.float32) * 0.1
    wc = rng.standard_normal((4, 4, c0, c1), dtype=np.float32) * 0.05
    bc = rng.standard_normal(c1, dtype=np.float32) * 0.1
    (zj, zt), (wpj, wpt), (wcj, wct) = map(_bf16_pair, (z, wp, wc))
    (bpj, bpt), (aj, at), (tj, tt), (bcj, bct) = map(_f32_pair, (bp, slope, trans, bc))
    want = jax_seed(zj, wpj, bpj, aj, tj, wcj, bcj, s0, True)
    got = ops.fused_seed(zt, wpt, bpt, at, tt, wct, bct, s0)
    assert got.shape == (batch, 2 * s0, 2 * s0, c1)
    _check(got, want)


@pytest.mark.parametrize("size,r_iterations,nf", [(32, 2, 8), (16, 1, 4)])
def test_generator_bf16_render_matches_gea_fused_seed(rng, size, r_iterations, nf):
    """A bf16 render of the port's generator against `gea`'s built with
    `fused_seed=True`, whose seed segment rounds where the port's does (on
    the CPU `gea` runs the seed's XLA reference on bf16 inputs; its LIS
    links round every operation to bf16, the port's accumulate in fp32).

    Measured gap (CPU): images 3.9e-3 and 5.9e-3, zs 3.1e-2 and 1.6e-2
    (|zs| up to about 4, where one bf16 step is 2^-6). Tolerances: images
    1.5e-2 and zs 2^-4, about 2.5x the measured gaps."""
    cfg = ModelConfig(image_size=size, code_size=16, r_iterations=r_iterations,
                      num_features=nf, max_features=4 * nf, dtype="bfloat16")
    g = JaxGeneratorLIS(
        image_size=size, code_size=16, r_iterations=r_iterations, norm="weight",
        num_features=nf, max_features=4 * nf, dtype=jnp.bfloat16, fused_seed=True,
    )
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32),
        init_generator_params(cfg, 0),
    )
    z = rng.standard_normal((5, 16)).astype(np.float32)
    want_imgs, want_zs = g.render({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        imgs, zs = generator_from_jax_params(params, cfg, device="cpu").render(torch.from_numpy(z))
    assert imgs.shape == want_imgs.shape and zs.shape == want_zs.shape
    assert np.abs(imgs.numpy() - np.asarray(want_imgs)).max() <= 1.5e-2
    assert np.abs(zs.numpy() - np.asarray(want_zs)).max() <= 2.0**-4
