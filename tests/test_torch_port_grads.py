"""The gradients of the port's three kernels, through their
`torch.autograd.Function`s on the CPU, against `gea`'s `custom_vjp`s of the
Pallas kernels run in interpret mode, on the same numpy inputs: the
gradient of sum(out**2) with respect to every input, as
`tests/test_pallas.py` takes it for the Pallas kernels.

Tolerances (fp32): TPReLU 1e-5; LIS rtol 1e-4 / atol 1e-5; seed atol 2e-4 /
rtol 1e-3, as `tests/test_pallas.py` holds the Pallas seed to its
reference. The two sides sum in different orders; the seed's sums run
over up to 16 * c0 terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.ops.pallas.lis import lis_residual_mlp as jax_lis
from gea.ops.pallas.seed import fused_seed as jax_seed
from gea.ops.pallas.tprelu import fused_tprelu as jax_tprelu
from gea_torch import ops
from gea_torch.ops.lis import LISResidualMLP
from gea_torch.ops.seed import FusedSeed
from gea_torch.ops.tprelu import FusedTPReLU


def _leaves(args):
    return [torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(True) for a in args]


def _port_grads(fn, args, *extra):
    ts = _leaves(args)
    (fn(*ts, *extra) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


def _jax_grads(fn, args, *extra):
    grads = jax.grad(
        lambda *a: jnp.sum(fn(*a, *extra, True) ** 2), argnums=tuple(range(len(args)))
    )(*map(jnp.asarray, args))
    return [np.asarray(g) for g in grads]


def tprelu_args(rng, shape):
    c = shape[-1]
    return [rng.standard_normal(shape, dtype=np.float32),
            rng.random(c, dtype=np.float32) * 0.5,
            rng.standard_normal(c, dtype=np.float32)]


def lis_args(rng, batch, code, hidden):
    return [
        rng.standard_normal((batch, code), dtype=np.float32),
        rng.standard_normal((code, hidden), dtype=np.float32) * 0.1,
        rng.standard_normal(hidden, dtype=np.float32) * 0.1,
        rng.random(hidden, dtype=np.float32) * 0.5,
        rng.standard_normal(hidden, dtype=np.float32) * 0.1,
        rng.standard_normal((hidden, code), dtype=np.float32) * 0.1,
        rng.standard_normal(code, dtype=np.float32) * 0.1,
    ]


def seed_args(rng, s0=5, c0=32, c1=16, batch=8, code=16):
    return [
        rng.standard_normal((batch, code), dtype=np.float32),
        rng.standard_normal((code, s0 * s0 * c0), dtype=np.float32) * 0.05,
        rng.standard_normal(s0 * s0 * c0, dtype=np.float32) * 0.1,
        rng.random(c0, dtype=np.float32) * 0.4 + 0.1,
        rng.standard_normal(c0, dtype=np.float32) * 0.1,
        rng.standard_normal((4, 4, c0, c1), dtype=np.float32) * 0.05,
        rng.standard_normal(c1, dtype=np.float32) * 0.1,
    ]


@pytest.mark.parametrize("shape", [(8, 128), (2, 4, 4, 32)])
def test_tprelu_grads_match_pallas_vjp(rng, shape):
    args = tprelu_args(rng, shape)
    for got, want in zip(_port_grads(ops.fused_tprelu, args), _jax_grads(jax_tprelu, args)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch,code,hidden", [(8, 128, 128), (5, 16, 32)])
def test_lis_grads_match_pallas_vjp(rng, batch, code, hidden):
    args = lis_args(rng, batch, code, hidden)
    for got, want in zip(_port_grads(ops.lis_residual_mlp, args), _jax_grads(jax_lis, args)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("s0,c0,c1,batch,code", [(5, 32, 16, 8, 16), (4, 16, 8, 3, 8)])
def test_seed_grads_match_pallas_vjp(rng, s0, c0, c1, batch, code):
    args = seed_args(rng, s0, c0, c1, batch, code)
    got = _port_grads(ops.fused_seed, args, s0)
    for g, w in zip(got, _jax_grads(jax_seed, args, s0)):
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("bf16_inputs", [False, True], ids=["f32-inputs", "bf16-z-and-weights"])
def test_fused_seed_bf16_cotangent(rng, bf16_inputs):
    """A bf16 consumer downstream sends a bf16 cotangent into the seed's
    backward, whose recomputed output may be fp32: the backward casts it
    first (the fault `tests/test_pallas.py::test_fused_seed_bf16_cotangent`
    pins in `gea`). Every gradient is finite and in its input's dtype."""
    ts = _leaves(seed_args(rng))
    if bf16_inputs:  # z, wp, wc in bf16, as the generator passes them
        ts = [t.detach().to(torch.bfloat16).requires_grad_(True) if i in (0, 1, 5) else t
              for i, t in enumerate(ts)]
    out = ops.fused_seed(*ts, 5)
    (out.to(torch.bfloat16) ** 2).sum().float().backward()
    for t in ts:
        assert t.grad.dtype == t.dtype
        assert torch.isfinite(t.grad.float()).all()


def test_tprelu_double_backward_gradgradcheck():
    """The TPReLU backward is itself differentiable (the WGAN-GP penalty
    differentiates D twice through it)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 2, 5), generator=gen, dtype=torch.float64, requires_grad=True)
    a = (torch.rand(5, generator=gen, dtype=torch.float64) * 0.5).requires_grad_(True)
    b = (torch.randn(5, generator=gen, dtype=torch.float64) * 0.1).requires_grad_(True)
    assert torch.autograd.gradcheck(FusedTPReLU.apply, (x, a, b))
    assert torch.autograd.gradgradcheck(FusedTPReLU.apply, (x, a, b))


@pytest.mark.parametrize("name", ["tprelu", "lis", "seed"])
def test_functions_match_autograd_of_plain(rng, name):
    """What `chip_smoke.py` checks on the card, here on the CPU in fp32:
    each Function's explicit backward against autograd through its plain
    version, for a random cotangent."""
    args, extra, fn, plain, cls = {
        "tprelu": (tprelu_args(rng, (6, 8)), (), ops.fused_tprelu, ops.fused_tprelu_plain,
                   FusedTPReLU),
        "lis": (lis_args(rng, 5, 16, 32), (), ops.lis_residual_mlp,
                ops.lis_residual_mlp_plain, LISResidualMLP),
        "seed": (seed_args(rng, 4, 16, 8, 3, 8), (4,), ops.fused_seed, ops.fused_seed_plain,
                 FusedSeed),
    }[name]
    grads = []
    for f in (fn, plain):
        ts = _leaves(args)
        out = f(*ts, *extra)
        if f is fn:
            assert type(out.grad_fn).__name__ == cls.__name__ + "Backward"
        cot = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape).astype(np.float32))
        out.backward(cot)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("wanted", [(0,), (0, 5), (1, 3), (2, 4, 6), tuple(range(7))],
                         ids=["z", "z-w2", "w1-slope", "b1-trans-b2", "all"])
def test_lis_backward_computes_only_what_is_asked(rng, wanted):
    """With only some inputs requiring a gradient (a frozen link's weights
    need none), those gradients equal the ones of a backward asked for all
    seven, and the others are not computed."""
    args = lis_args(rng, 5, 16, 32)
    full = _port_grads(ops.lis_residual_mlp, args)
    ts = [torch.from_numpy(a).requires_grad_(i in wanted) for i, a in enumerate(args)]
    out = ops.lis_residual_mlp(*ts)
    got = torch.autograd.grad((out**2).sum(), [ts[i] for i in wanted])
    for i, g in zip(wanted, got):
        np.testing.assert_array_equal(g.numpy(), full[i])
    grads = LISResidualMLP.backward(
        type("Ctx", (), {"saved_tensors": ts[:6],
                         "needs_input_grad": tuple(i in wanted for i in range(7))})(),
        2 * out.detach())
    assert [i for i, g in enumerate(grads) if g is not None] == list(wanted)
