"""The seed segment's backward in the port: the custom op
`gea_torch::fused_seed_backward` (CUDA kernels on the card; its plain
version, `fused_seed_backward_plain`, on the CPU, which is what runs here)
and `FusedSeed`, against `gea`'s `custom_vjp` of the Pallas kernel run in
interpret mode, on the same numpy inputs.

Tolerances: against `gea` atol 2e-4 / rtol 1e-3 in fp32, the seed's
tolerance in `tests/test_pallas.py` (the two sum over up to 16 * c1 and
s0 * s0 * c0 terms in other orders). The CPU op runs the plain version, so
the two are equal bit for bit. `FusedSeed` against autograd through
`fused_seed_plain` in float64: atol 1e-10 (the same derivative in another
order). In bf16 the plain version rounds ds, dh through the TPReLU, to bf16
before the two projection products (so that the kernels run them on the
tensor cores), where autograd through `fused_seed_plain` keeps it in fp32:
dz, dwp and dbp then move by up to about one bf16 step of ds (2^-8 of its
size) in each term, and are held within 2^-7 of their max (measured:
1.0e-3 to 3.9e-3 at the three shapes); dwc, rounded to bf16 itself, within
one such step of its max (the fp32 sum under it runs in another order);
dslope, dtrans and dbc, fp32 sums in another order, within 1e-5 of their
max. The kernels themselves run only on the card
(`tests/test_torch_port_kernels_card.py`).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.ops.pallas.seed import fused_seed as jax_seed
from gea_torch import ops
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.ops import seed
from gea_torch.ops.seed import FusedSeed
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)

SHAPES = [(5, 32, 16, 8, 16), (4, 16, 8, 3, 8), (7, 16, 24, 5, 8)]  # s0, c0, c1, batch, code
NEEDS = {"all": (True,) * 7, "dz": (True,) + (False,) * 6, "weights": (False,) + (True,) * 6}
NAMES = ("dz", "dwp", "dbp", "dslope", "dtrans", "dwc", "dbc")


def inputs(shape, dtype=np.float32):
    """z, wp, bp, slope, trans, wc, bc and a cotangent g, from a numpy seed."""
    s0, c0, c1, batch, code = shape
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.standard_normal((batch, code)),
              rng.standard_normal((code, s0 * s0 * c0)) * 0.05,
              rng.standard_normal(s0 * s0 * c0) * 0.1,
              rng.random(c0) * 0.4 + 0.1,
              rng.standard_normal(c0) * 0.1,
              rng.standard_normal((4, 4, c0, c1)) * 0.05,
              rng.standard_normal(c1) * 0.1,
              rng.standard_normal((batch, 2 * s0, 2 * s0, c1))]
    return [a.astype(dtype) for a in arrays]


@functools.cache
def gea_grads(shape):
    """`gea`'s `custom_vjp` of the Pallas kernel (interpret mode) for g."""
    s0 = shape[0]
    arrays = inputs(shape)
    _, vjp = jax.vjp(lambda *a: jax_seed(*a, s0, True), *map(jnp.asarray, arrays[:7]))
    return [np.asarray(w) for w in vjp(jnp.asarray(arrays[7]))]


@pytest.mark.parametrize("need", list(NEEDS))
@pytest.mark.parametrize("shape", SHAPES, ids=["s0-5", "s0-4-ragged", "s0-7-c1-24"])
def test_plain_matches_gea_vjp(shape, need):
    t = [torch.from_numpy(a) for a in inputs(shape)]
    got = ops.fused_seed_backward(*t, shape[0], NEEDS[need])
    for name, n, g, w in zip(NAMES, NEEDS[need], got, gea_grads(shape)):
        if not n:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", list(NEEDS))
def test_cpu_op_is_the_plain_version(need, dtype):
    """The op on the CPU equals the plain version bit for bit, and returns
    empty tensors for the gradients not asked for."""
    shape = SHAPES[1]
    t = [torch.from_numpy(a) for a in inputs(shape)]
    t = [v.to(dtype) if i in (0, 1, 5, 7) else v for i, v in enumerate(t)]
    raw = torch.ops.gea_torch.fused_seed_backward(*t, shape[0], list(NEEDS[need]))
    want = ops.fused_seed_backward_plain(*t, shape[0], NEEDS[need])
    for name, r, w, x in zip(NAMES, raw, want, t):
        if w is None:
            assert r.numel() == 0 and r.dtype == x.dtype, name
        else:
            assert r.dtype == w.dtype == x.dtype and torch.equal(r, w), name


@pytest.mark.parametrize("need", list(NEEDS))
def test_fake_gives_shapes_and_dtypes(need):
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = SHAPES[0]
    t = [torch.from_numpy(a) for a in inputs(shape)]
    t = [v.to(torch.bfloat16) if i in (0, 1, 5, 7) else v for i, v in enumerate(t)]
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(v) for v in t]
        out = torch.ops.gea_torch.fused_seed_backward(*fake, shape[0], list(NEEDS[need]))
    for n, o, x in zip(NEEDS[need], out, t):
        assert o.dtype == x.dtype and o.shape == (x.shape if n else (0,))


@pytest.mark.parametrize("need", ["all", "dz"])
def test_opcheck(need):
    shape = SHAPES[1]
    t = [torch.from_numpy(a) for a in inputs(shape)]
    torch.library.opcheck(torch.ops.gea_torch.fused_seed_backward.default,
                          (*t, shape[0], list(NEEDS[need])))


def _function_and_plain_grads(arrays, s0, wanted, dtype=None):
    grads = []
    for fn in (ops.fused_seed, ops.fused_seed_plain):
        leaves = [torch.from_numpy(a) for a in arrays[:7]]
        if dtype is not None:  # z, wp and wc in bf16, as the generator passes them
            leaves = [v.to(dtype) if i in (0, 1, 5) else v for i, v in enumerate(leaves)]
        leaves = [v.requires_grad_(i in wanted) for i, v in enumerate(leaves)]
        out = fn(*leaves, s0)
        if fn is ops.fused_seed:
            assert type(out.grad_fn).__name__ == "FusedSeedBackward"
        got = torch.autograd.grad(out, [leaves[i] for i in wanted],
                                  torch.from_numpy(arrays[7]).to(out.dtype))
        grads.append(dict(zip(wanted, got)))
    return grads


@pytest.mark.parametrize("need", list(NEEDS))
@pytest.mark.parametrize("shape", SHAPES[:2], ids=["s0-5", "s0-4-ragged"])
def test_function_matches_autograd_of_plain_float64(shape, need):
    wanted = [i for i, n in enumerate(NEEDS[need]) if n]
    got, want = _function_and_plain_grads(inputs(shape, np.float64), shape[0], wanted)
    for i in wanted:
        assert got[i].dtype == torch.float64
        torch.testing.assert_close(got[i], want[i], atol=1e-10, rtol=0, msg=NAMES[i])


@pytest.mark.parametrize("shape", SHAPES, ids=["s0-5", "s0-4-ragged", "s0-7-c1-24"])
def test_bf16_plain_against_autograd_of_plain(shape):
    """The bf16 plain version against autograd through `fused_seed_plain`
    (which keeps ds in fp32): the ds rounding moves dz, dwp and dbp within
    2^-7 of their max; dwc, rounded to bf16, within 2^-8; the fp32 sums
    within 1e-5."""
    got, want = _function_and_plain_grads(inputs(shape), shape[0], range(7), torch.bfloat16)
    for i in range(7):
        scale = want[i].float().abs().max()
        err = (got[i].float() - want[i].float()).abs().max() / scale
        assert got[i].dtype == want[i].dtype, NAMES[i]
        assert err <= {0: 2**-7, 1: 2**-7, 2: 2**-7, 5: 2**-8}.get(i, 1e-5), (NAMES[i], err.item())
    # The rounding is there: without it dz, dwp and dbp would be bit for bit
    # autograd's up to the order of the sums.
    assert any((got[i].float() - want[i].float()).abs().max() > 0 for i in (0, 1, 2))


def test_batch_zero():
    """No codes: zero gradients of the weights, an empty dz."""
    s0, c0, c1, _, code = SHAPES[1]
    arrays = inputs((s0, c0, c1, 0, code))
    t = [torch.from_numpy(a) for a in arrays]
    got = ops.fused_seed_backward(*t, s0)
    for name, g, x in zip(NAMES, got, t):
        assert g.shape == x.shape and not g.any(), name


def test_second_derivative_raises():
    shape = SHAPES[1]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs(shape)[:7]]
    out = ops.fused_seed(*leaves, shape[0])
    (dz,) = torch.autograd.grad((out**2).sum(), [leaves[0]], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dz.sum().backward()


def test_cpu_backward_counts_no_launch():
    """On the CPU the Function's backward runs the plain version through
    the op and counts no launch."""
    shape = SHAPES[1]
    ops.reset_launch_counts()
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs(shape)[:7]]
    (FusedSeed.apply(*leaves, shape[0]) ** 2).sum().backward()
    assert all(v.grad is not None for v in leaves)
    assert ops.launch_counts()["fused_seed_backward"] == 0
    assert all(v == 0 for v in ops.launch_counts().values())


def test_import_without_triton_or_nvcc():
    code = ("import sys, torch, gea_torch.ops.seed as s;"
            "assert 'triton' not in sys.modules, 'triton imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
                   cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))


TINY = dict(image_size=16, code_size=16, num_features=4, max_features=16, dtype="float32",
            batch_size=4, lr=1e-3)


def _real(cfg):
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (cfg.batch_size, cfg.image_size, cfg.image_size, 3)).astype(np.float32))


def _glis(norm):
    cfg = TrainGLISConfig(**TINY, r_iterations=1, norm=norm)
    state, step = create_glis_state(cfg, device="cpu"), build_glis_train_step(cfg)
    return lambda: step(state, _real(cfg))


def _r_separate():
    cfg = TrainRSeparateConfig(**TINY, r_iterations=1, r_hidden=32)
    g = generator_from_jax_params(init_generator_params(cfg, 0), cfg, device="cpu")
    d = discriminator_from_jax_params(init_discriminator_params(cfg, 1), cfg, device="cpu")
    state, step = create_r_state(cfg, g, d, device="cpu"), build_r_separate_step(cfg)
    return lambda: step(state)


def _r_iterative():
    cfg = TrainRIterativeConfig(**TINY, r_hidden=32)
    state, step = create_r_iterative_state(cfg, device="cpu"), build_r_iterative_step(cfg)
    return lambda: step(state, _real(cfg))


ALL, DZ, WEIGHTS = NEEDS["all"], NEEDS["dz"], NEEDS["weights"]


@pytest.mark.parametrize("trainer,want", [
    ("g-lis", [ALL]), ("g-lis batch norm", []), ("r-separate", [DZ]),
    ("r-iterative", [ALL, ALL, WEIGHTS]),
])
def test_backward_calls_per_step(monkeypatch, trainer, want):
    """Seed backwards per train step and what each computes, which the
    card modules (`tests/test_torch_port_*_card.py`) assert as launches: G-LIS differentiates
    its one render, every gradient (the stacked codes pass the LIS links);
    batch norm runs no seed kernel; R-separate's frozen G asks for dz alone;
    R-iterative's joint unroll differentiates its 3 renders, the last two
    from R's codes, the first from a drawn z (no dz)."""
    step = {"g-lis": lambda: _glis("weight"), "g-lis batch norm": lambda: _glis("batch"),
            "r-separate": _r_separate, "r-iterative": _r_iterative}[trainer]()
    calls = []

    def counted(*args, _f=seed._backward):
        calls.append(tuple(args[-1]))
        return _f(*args)

    monkeypatch.setattr(seed, "_backward", counted)
    step()
    assert calls == want
