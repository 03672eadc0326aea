"""The LIS link's backward in the port: the custom op
`gea_torch::lis_residual_mlp_backward` (a CUDA kernel on the card; its plain
version, `lis_residual_mlp_backward_plain`, on the CPU, which is what runs
here) and `LISResidualMLP`, against `gea`'s `custom_vjp` of the Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerances: against `gea` in fp32 rtol 1e-4 / atol 1e-5, as
`tests/test_torch_port_grads.py` holds the Function (the two sum in other
orders). In bf16 (z, the weights and g in bf16, as the generator passes
them) against `gea`'s `_bwd` on the same values in fp32, which rounds
neither h nor dh_pre: the plain version rounds both to bf16 before the
products that take them (2^-9 of each term at most) and rounds dz, dw1 and
dw2 to bf16, so those are held within 2^-6 of their max; db1, dslope,
dtrans and db2, fp32 sums of unrounded terms in another order, within 1e-5
of their max. The CPU op runs the plain version, so the two are equal bit
for bit. The kernel itself runs only on the card (`chip_smoke.py`).
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.ops.pallas.lis import lis_residual_mlp as jax_lis
from gea_torch import ops
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.ops import lis
from gea_torch.ops.lis import LISResidualMLP
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)

SHAPES = [(5, 16, 32), (8, 128, 128), (13, 24, 40)]  # batch, code, hidden; the last ragged
IDS = ["5-16-32", "8-128-128", "ragged-13-24-40"]
NEEDS = {"all": (True,) * 7, "dz": (True,) + (False,) * 6, "weights": (False,) + (True,) * 6}
NAMES = ("dz", "dw1", "db1", "dslope", "dtrans", "dw2", "db2")


def inputs(shape, dtype=np.float32):
    """z, w1, b1, slope, trans, w2, b2 and a cotangent g, from a numpy seed."""
    batch, code, hidden = shape
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.standard_normal((batch, code)),
              rng.standard_normal((code, hidden)) * code**-0.5,
              rng.standard_normal(hidden) * 0.1,
              rng.random(hidden) * 0.5,
              rng.standard_normal(hidden) * 0.1,
              rng.standard_normal((hidden, code)) * hidden**-0.5,
              rng.standard_normal(code) * 0.1,
              rng.standard_normal((batch, code))]
    return [a.astype(dtype) for a in arrays]


def backward_args(arrays, dtype=None):
    """The op's inputs (z, w1, b1, slope, trans, w2, g) as tensors; z, the
    weights and g in `dtype` where given."""
    t = [torch.from_numpy(a) for i, a in enumerate(arrays) if i != 6]
    if dtype is not None:
        t = [v.to(dtype) if i in (0, 1, 5, 6) else v for i, v in enumerate(t)]
    return t


@functools.cache
def gea_grads(shape, dtype=None):
    """`gea`'s `custom_vjp` of the Pallas kernel (interpret mode) for g, on
    the inputs rounded to `dtype` (a torch dtype) and held in fp32."""
    arrays = inputs(shape)
    if dtype is not None:
        arrays = [torch.from_numpy(a).to(dtype).float().numpy() if i in (0, 1, 5, 7) else a
                  for i, a in enumerate(arrays)]
    _, vjp = jax.vjp(lambda *a: jax_lis(*a, True), *map(jnp.asarray, arrays[:7]))
    return [np.asarray(w) for w in vjp(jnp.asarray(arrays[7]))]


@pytest.mark.parametrize("need", list(NEEDS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_matches_gea_vjp(shape, need):
    got = ops.lis_residual_mlp_backward(*backward_args(inputs(shape)), NEEDS[need])
    for name, n, g, w in zip(NAMES, NEEDS[need], got, gea_grads(shape)):
        if not n:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bf16_plain_against_gea_vjp(shape):
    """bf16 z, weights and g against `gea`'s fp32 `_bwd` on the same
    values: dz, dw1 and dw2 (the roundings of h, dh_pre and their own)
    within 2^-6 of their max, the fp32 sums within 1e-5."""
    got = ops.lis_residual_mlp_backward(*backward_args(inputs(shape), torch.bfloat16))
    for i, (name, g, w) in enumerate(zip(NAMES, got, gea_grads(shape, torch.bfloat16))):
        assert g.dtype == (torch.bfloat16 if i in (0, 1, 5) else torch.float32), name
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= (2**-6 if i in (0, 1, 5) else 1e-5), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", list(NEEDS))
def test_cpu_op_is_the_plain_version(need, dtype):
    """The op on the CPU equals the plain version bit for bit, and returns
    empty tensors for the gradients not asked for."""
    t = backward_args(inputs(SHAPES[2]), dtype)
    raw = torch.ops.gea_torch.lis_residual_mlp_backward(*t, list(NEEDS[need]))
    want = ops.lis_residual_mlp_backward_plain(*t, NEEDS[need])
    likes = (*t[:6], torch.zeros(0))  # db2 is fp32
    for name, r, w, x in zip(NAMES, raw, want, likes):
        if w is None:
            assert r.numel() == 0 and r.dtype == x.dtype, name
        else:
            assert r.dtype == w.dtype == x.dtype and torch.equal(r, w), name


@pytest.mark.parametrize("need", list(NEEDS))
def test_fake_gives_shapes_and_dtypes(need):
    from torch._subclasses.fake_tensor import FakeTensorMode

    t = backward_args(inputs(SHAPES[0]), torch.bfloat16)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(v) for v in t]
        out = torch.ops.gea_torch.lis_residual_mlp_backward(*fake, list(NEEDS[need]))
    code = t[0].shape[1]
    likes = [(x.dtype, x.shape) for x in t[:6]] + [(torch.float32, (code,))]
    for n, o, (dtype, shape) in zip(NEEDS[need], out, likes):
        assert o.dtype == dtype and o.shape == (shape if n else (0,))


@pytest.mark.parametrize("need", list(NEEDS))
def test_opcheck(need):
    t = backward_args(inputs(SHAPES[2]))
    torch.library.opcheck(torch.ops.gea_torch.lis_residual_mlp_backward.default,
                          (*t, list(NEEDS[need])))


def reference(z, w1, b1, slope, trans, w2, b2):
    """`gea`'s `lis_residual_mlp_reference` in torch, in the inputs' dtype."""
    s = z @ w1 + b1 - trans
    return z + (torch.where(s >= 0, s, slope * s) + trans) @ w2 + b2


@pytest.mark.parametrize("need", list(NEEDS))
def test_function_matches_autograd_of_reference_float64(need):
    """`LISResidualMLP` against autograd through the reference formula in
    float64: the same derivative in another order."""
    arrays = inputs(SHAPES[2], np.float64)
    wanted = [i for i, n in enumerate(NEEDS[need]) if n]
    grads = []
    for fn in (ops.lis_residual_mlp, reference):
        leaves = [torch.from_numpy(a).requires_grad_(i in wanted)
                  for i, a in enumerate(arrays[:7])]
        out = fn(*leaves)
        if fn is ops.lis_residual_mlp:
            assert type(out.grad_fn).__name__ == "LISResidualMLPBackward"
        got = torch.autograd.grad(out, [leaves[i] for i in wanted], torch.from_numpy(arrays[7]))
        grads.append(got)
    for i, g, w in zip(wanted, *grads):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, atol=1e-10, rtol=0, msg=NAMES[i])


def near_zero(shape, dtype=torch.float32):
    """Inputs whose row 0 (and every even row, a copy of it) has s = pre -
    trans within rounding of 0 in every hidden column: b1 = trans - pre
    with pre = z[0] @ w1 exact (fp64, rounded once to fp32)."""
    arrays = inputs(shape)
    z, w1 = arrays[0], arrays[1]
    z[::2] = z[0]
    if dtype is not None:
        z = torch.from_numpy(z).to(dtype).float().numpy()
        w1 = torch.from_numpy(w1).to(dtype).float().numpy()
    pre = (z[0].astype(np.float64) @ w1.astype(np.float64)).astype(np.float32)
    arrays[0], arrays[1], arrays[2] = z, w1, arrays[4] - pre
    return arrays


def reference_neg(arrays):
    """neg = s < 0 of the exact pre, in numpy: the products in float64
    rounded once to float32, then + b1 and - trans in float32."""
    z, w1, b1, _, trans = arrays[:5]
    pre = (z.astype(np.float64) @ w1.astype(np.float64)).astype(np.float32)
    return ((pre + b1) - trans) < 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_near_zero_branch_is_exact(monkeypatch, dtype):
    """Where s lies within rounding of 0, the plain version takes the
    branch the exact pre gives, everywhere; an fp32 product z @ w1 takes
    the other at some elements (the case bites). The neg the plain version
    uses is read from its `torch.where` calls."""
    shape = (16, 128, 96)
    arrays = near_zero(shape, dtype)
    want = reference_neg(arrays)
    z, w1 = (torch.from_numpy(a) for a in arrays[:2])
    b1, trans = torch.from_numpy(arrays[2]), torch.from_numpy(arrays[4])
    s_fp32 = (z @ w1 + b1) - trans
    flipped = ((s_fp32 < 0).numpy() != want).sum()
    assert flipped > 0, "an fp32 product flips no branch: the case does not bite"
    seen = []
    where = torch.where

    def spy(cond, *rest):
        if cond.dtype == torch.bool and cond.shape == want.shape and not seen:
            seen.append(cond.clone())
        return where(cond, *rest)

    monkeypatch.setattr(torch, "where", spy)
    ops.lis_residual_mlp_backward_plain(*backward_args(arrays, dtype))
    assert seen and np.array_equal(seen[0].numpy(), want)


def test_near_zero_gradients_match_exact_reference():
    """The near-zero case's dw1 against a float64 reference that uses the
    exact branch: within fp32 rounding, where the branch an fp32 product
    takes would move whole columns."""
    arrays = near_zero((16, 128, 96))
    got = ops.lis_residual_mlp_backward(*backward_args(arrays))
    z, w1, b1, slope, trans, w2, _, g = (a.astype(np.float64) for a in arrays)
    neg = reference_neg(arrays)
    dh = g @ w2.T
    dh_pre = dh * np.where(neg, slope, 1.0)
    np.testing.assert_allclose(got[1].numpy(), z.T @ dh_pre, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), g + dh_pre @ w1.T, rtol=1e-4, atol=1e-5)


def test_batch_zero():
    """No rows: zero gradients of the weights and vectors, an empty dz."""
    t = backward_args(inputs((0, 16, 32)))
    got = ops.lis_residual_mlp_backward(*t)
    for name, g, x in zip(NAMES, got, (*t[:6], torch.zeros(16))):
        assert g.shape == x.shape and not g.any(), name


def test_second_derivative_raises():
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs(SHAPES[0])[:7]]
    out = ops.lis_residual_mlp(*leaves)
    (dz,) = torch.autograd.grad((out**2).sum(), [leaves[0]], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dz.sum().backward()


def test_cpu_backward_counts_no_launch():
    """On the CPU the Function's backward runs the plain version through
    the op and counts no launch."""
    ops.reset_launch_counts()
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs(SHAPES[0])[:7]]
    (LISResidualMLP.apply(*leaves) ** 2).sum().backward()
    assert all(v.grad is not None for v in leaves)
    assert ops.launch_counts()["lis_residual_mlp_backward"] == 0
    assert all(v == 0 for v in ops.launch_counts().values())


def test_import_without_triton_or_nvcc():
    code = ("import sys, torch, gea_torch.ops.lis as s;"
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
    cfg = TrainGLISConfig(**TINY, r_iterations=2, norm=norm)
    state, step = create_glis_state(cfg, device="cpu"), build_glis_train_step(cfg)
    return lambda: step(state, _real(cfg))


def _r_separate():
    cfg = TrainRSeparateConfig(**TINY, r_iterations=2, r_hidden=32)
    g = generator_from_jax_params(init_generator_params(cfg, 0), cfg, device="cpu")
    d = discriminator_from_jax_params(init_discriminator_params(cfg, 1), cfg, device="cpu")
    state, step = create_r_state(cfg, g, d, device="cpu"), build_r_separate_step(cfg)
    return lambda: step(state)


def _r_iterative():
    cfg = TrainRIterativeConfig(**TINY, r_hidden=32)
    state, step = create_r_iterative_state(cfg, device="cpu"), build_r_iterative_step(cfg)
    return lambda: step(state, _real(cfg))


ALL, DZ, WEIGHTS = NEEDS["all"], NEEDS["dz"], NEEDS["weights"]
NO_TPRELU = (True, True, True, False, False, True, True)  # LeakyReLU's fixed slope, offset


@pytest.mark.parametrize("trainer,want", [
    ("g-lis", [[WEIGHTS, ALL]]), ("g-lis batch norm", [[(False,) + NO_TPRELU[1:], NO_TPRELU]]),
    ("r-separate", [[DZ, DZ]]), ("r-iterative", []),
])
def test_backward_calls_per_step(monkeypatch, trainer, want):
    """LIS backwards per train step (2 links) and what each link of a call
    computes (first link first), which `chip_smoke.py` asserts as launches
    on the card: one chain call a step differentiates both links, every
    gradient but the first link's dz (its z is drawn); batch norm's links
    have no learned slope or offset; R-separate's frozen G asks for dz
    alone; R-iterative's G has no LIS link. No link is differentiated on
    its own."""
    step = {"g-lis": lambda: _glis("weight"), "g-lis batch norm": lambda: _glis("batch"),
            "r-separate": _r_separate, "r-iterative": _r_iterative}[trainer]()
    calls, singles = [], []

    def counted(*args, _f=lis._chain_backward):
        calls.append([tuple(n) for n in args[-1]])
        return _f(*args)

    def single(*args, _f=lis._backward):
        singles.append(tuple(args[-1]))
        return _f(*args)

    monkeypatch.setattr(lis, "_chain_backward", counted)
    monkeypatch.setattr(lis, "_backward", single)
    step()
    assert calls == want and singles == []
