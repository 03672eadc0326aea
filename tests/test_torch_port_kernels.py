"""The port's kernels, through their plain PyTorch versions (what the
wrappers run on a CPU tensor), against `gea`'s Pallas kernels run in
interpret mode, on the same numpy inputs. The CUDA and Triton kernels
themselves run only on the card
(`tests/test_torch_port_kernels_card.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.ops.layers import normalize_weight as jax_normalize_weight
from gea.ops.pallas.lis import lis_residual_mlp as jax_lis
from gea.ops.pallas.seed import fused_seed as jax_seed
from gea.ops.pallas.tprelu import fused_tprelu as jax_tprelu
from gea_torch import ops
from gea_torch.ops import build
from gea_torch.ops.layers import normalize_weight


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("shape", [(16, 128), (8, 4, 4, 128), (33, 256)])
def test_tprelu_matches_pallas(rng, shape):
    c = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    a = rng.random(c, dtype=np.float32) * 0.5
    b = rng.standard_normal(c, dtype=np.float32)
    want = np.asarray(jax_tprelu(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), True))
    got = ops.fused_tprelu(_t(x), _t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch,code,hidden", [(16, 128, 128), (30, 256, 512)])
def test_lis_matches_pallas(rng, batch, code, hidden):
    args = [
        rng.standard_normal((batch, code), dtype=np.float32),
        rng.standard_normal((code, hidden), dtype=np.float32) * 0.1,
        rng.standard_normal(hidden, dtype=np.float32) * 0.1,
        rng.random(hidden, dtype=np.float32) * 0.5,
        rng.standard_normal(hidden, dtype=np.float32) * 0.1,
        rng.standard_normal((hidden, code), dtype=np.float32) * 0.1,
        rng.standard_normal(code, dtype=np.float32) * 0.1,
    ]
    want = np.asarray(jax_lis(*map(jnp.asarray, args), True))
    got = ops.lis_residual_mlp(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "s0,c0,c1,batch,code", [(5, 64, 32, 7, 16), (4, 128, 64, 33, 32)]
)
def test_seed_matches_pallas(rng, s0, c0, c1, batch, code):
    args = [
        rng.standard_normal((batch, code), dtype=np.float32),
        rng.standard_normal((code, s0 * s0 * c0), dtype=np.float32) * 0.05,
        rng.standard_normal(s0 * s0 * c0, dtype=np.float32) * 0.1,
        rng.random(c0, dtype=np.float32) * 0.4 + 0.1,
        rng.standard_normal(c0, dtype=np.float32) * 0.1,
        rng.standard_normal((4, 4, c0, c1), dtype=np.float32) * 0.05,
        rng.standard_normal(c1, dtype=np.float32) * 0.1,
    ]
    want = np.asarray(jax_seed(*map(jnp.asarray, args), s0, True))
    got = ops.fused_seed(*map(_t, args), s0).numpy()
    assert got.shape == (batch, 2 * s0, 2 * s0, c1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_cpu_calls_launch_nothing(rng):
    """On a CPU tensor each wrapper runs its plain version and counts no
    launch."""
    ops.reset_launch_counts()
    x = _t(rng.standard_normal((4, 8))).requires_grad_(True)
    ops.fused_tprelu(x, torch.full((8,), 0.25), torch.zeros(8)).sum().backward()
    z = _t(rng.standard_normal((2, 8)))
    w = _t(rng.standard_normal((8, 8)))
    v = torch.zeros(8)
    ops.lis_residual_mlp(z, w, v, v, v, w, v)
    ops.fused_seed(z.requires_grad_(True), _t(rng.standard_normal((8, 4 * 4 * 4))),
                   torch.zeros(64), v[:4], v[:4], _t(rng.standard_normal((4, 4, 4, 2))), v[:2],
                   4).sum().backward()
    assert ops.launch_counts() == {
        "fused_tprelu": 0, "fused_tprelu_backward": 0, "lis_residual_mlp": 0,
        "lis_residual_mlp_backward": 0, "lis_chain_backward": 0, "fused_seed": 0,
        "fused_seed_backward": 0,
    }


@pytest.mark.parametrize("shape,out_dim,axes", [
    ((32, 16), 0, (0,)),            # Dense: torch (out, in) vs flax (in, out)
    ((8, 3, 4, 4), 0, (0, 1, 2)),   # Conv: OIHW vs HWIO
    ((3, 8, 4, 4), 1, (0, 1, 2)),   # ConvT: IOHW vs HWIO
])
def test_normalize_weight_matches_gea(rng, shape, out_dim, axes):
    v = rng.standard_normal(shape, dtype=np.float32)
    g_shape = [1] * len(shape)
    g_shape[out_dim] = shape[out_dim]
    g = rng.random(shape[out_dim], dtype=np.float32) + 0.5
    got = normalize_weight(_t(v), _t(g).view(g_shape), out_dim).numpy()
    # gea's layout: the output channel last.
    if len(shape) == 2:
        v_jax, back = v.T, (1, 0)
    elif out_dim == 0:
        v_jax, back = v.transpose(2, 3, 1, 0), (3, 2, 0, 1)
    else:
        v_jax, back = v.transpose(2, 3, 0, 1), (2, 3, 0, 1)
    want = np.asarray(jax_normalize_weight(jnp.asarray(v_jax), jnp.asarray(g), axes))
    np.testing.assert_allclose(got, want.transpose(back), atol=1e-6, rtol=1e-6)


def test_kernel_sources_and_no_build_at_import():
    """Every CUDA source the build names is in the package, and importing
    the ops built nothing; building without nvcc raises a clear error."""
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    assert build._LIBS == {}
    if build.shutil.which("nvcc") is None and not (
        build.Path(build.os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    ).exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.nvcc_path()
