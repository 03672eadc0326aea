"""TPReLU's backward in the port: the custom op
`gea_torch::fused_tprelu_backward` (a Triton kernel on the card; its plain
version, `fused_tprelu_backward_plain`, on the CPU, which is what runs here)
and the `autograd.Function`s around it, against `gea`'s `custom_vjp` of the
Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerances: against `gea` atol 1e-5 / rtol 1e-5 in fp32 (the two sum the
per-channel gradients in different orders). Against the port's own eager
backward of the previous layout (inlined below), and between the op's
flag, the results are equal bit for bit: the CPU op runs the same
operations. The double backward against autograd through the plain version
in float64: atol 1e-10 / rtol 1e-10 (the same derivative in another order).
The kernel itself runs only on the card
(`tests/test_torch_port_kernels_card.py`: dx bit for bit, da and db
within its BWD_SUM_TOL)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.ops.pallas.tprelu import fused_tprelu as jax_tprelu
from gea_torch import ops
from gea_torch.config import TrainGLISConfig, TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.ops import tprelu
from gea_torch.ops.tprelu import FusedTPReLU, FusedTPReLUGrad
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)


def inputs(rng, shape, dtype=np.float32):
    c = shape[-1]
    return (rng.standard_normal(shape).astype(dtype), (rng.random(c) * 0.5).astype(dtype),
            (rng.standard_normal(c) * 0.5).astype(dtype),
            (rng.standard_normal(shape) * 0.1).astype(dtype))


def eager_backward(x, a, b, g, need_a, need_b):
    """`FusedTPReLU.backward` as the port ran it before the kernel: eager
    ops on the saved inputs."""
    s = x - b.to(x.dtype)
    neg = s < 0
    fprime = torch.where(neg, a.to(x.dtype), torch.ones_like(x))
    dx = (g * fprime).to(x.dtype)
    axes = tuple(range(x.dim() - 1))
    acc = torch.promote_types(x.dtype, torch.float32)
    da = db = None
    if need_a:
        da = torch.where(neg, g * s, torch.zeros_like(x)).sum(axes, dtype=acc).to(a.dtype)
    if need_b:
        db = (g * (1 - fprime)).sum(axes, dtype=acc).to(b.dtype)
    return dx, da, db


@pytest.mark.parametrize("shape", [(7, 5), (2, 3, 4, 6), (64, 10, 10, 96), (9, 1)],
                         ids=["2d", "4d", "d-step-like", "one-channel"])
def test_op_matches_gea_vjp(rng, shape):
    x, a, b, g = inputs(rng, shape)
    _, vjp = jax.vjp(lambda x, a, b: jax_tprelu(x, a, b, True), *map(jnp.asarray, (x, a, b)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(v) for v in (x, a, b, g)]
    for got in (torch.ops.gea_torch.fused_tprelu_backward(*t, True),
                ops.fused_tprelu_backward(*t)):
        assert [v.shape for v in got] == [w.shape for w in want]
        for v, w in zip(got, want):
            np.testing.assert_allclose(v.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["fp32", "bf16", "bf16-fp32-cotangent"])
def test_gradients_not_asked_for_are_none(rng, case):
    """need_ab off: da and db are None (empty from the op), and dx equals
    the full call's bit for bit."""
    t = [torch.from_numpy(v) for v in inputs(rng, (12, 7))]
    if case != "fp32":
        t[0] = t[0].to(torch.bfloat16)
    if case == "bf16":
        t[3] = t[3].to(torch.bfloat16)
    full = ops.fused_tprelu_backward(*t, True)
    got = ops.fused_tprelu_backward(*t, False)
    assert torch.equal(got[0], full[0]) and got[1:] == (None, None)
    assert full[1] is not None and full[2] is not None
    raw = torch.ops.gea_torch.fused_tprelu_backward(*t, False)
    assert [v.numel() for v in raw[1:]] == [0, 0]


@pytest.mark.parametrize("case", ["fp32", "fp32-dx-only", "bf16-fp32-cotangent"])
def test_opcheck(rng, case):
    x, a, b, g = (torch.from_numpy(v) for v in inputs(rng, (6, 4, 8)))
    if case == "bf16-fp32-cotangent":
        x = x.to(torch.bfloat16)
    need = case != "fp32-dx-only"
    torch.library.opcheck(torch.ops.gea_torch.fused_tprelu_backward.default,
                          (x, a, b, g, need))


@pytest.mark.parametrize("dtype,train_a,train_b", [
    (torch.float32, True, True), (torch.bfloat16, True, True), (torch.bfloat16, False, False),
    (torch.float32, True, False)], ids=["fp32", "bf16", "bf16-frozen-a-b", "fp32-frozen-b"])
def test_function_gradients_unchanged(rng, dtype, train_a, train_b):
    """`FusedTPReLU`'s gradients through the op equal the eager backward it
    replaced, bit for bit; with a and b frozen (batch norm's LeakyReLU, a
    frozen D) only dx is computed, and with b alone frozen its gradient,
    computed beside a's, is dropped."""
    x, a, b, g = (torch.from_numpy(v) for v in inputs(rng, (5, 3, 16)))
    x, g = x.to(dtype), g.to(dtype)
    leaves = [x.clone().requires_grad_(True), a.clone().requires_grad_(train_a),
              b.clone().requires_grad_(train_b)]
    ops.fused_tprelu(*leaves).backward(g)
    want = eager_backward(x, a, b, g, train_a, train_b)
    for leaf, w in zip(leaves, want):
        if w is None:
            assert leaf.grad is None
        else:
            assert leaf.grad.dtype == w.dtype and torch.equal(leaf.grad, w)


@pytest.mark.parametrize("need_ab,shape", [(True, (4, 3, 6)), (False, (4, 3, 6)),
                                           (True, (9, 1))],
                         ids=["da-db", "dx-only", "da-db-one-channel"])
def test_double_backward_matches_autograd_of_plain(rng, need_ab, shape):
    """`FusedTPReLUGrad`'s eager backward (what WGAN-GP's penalty reaches)
    against autograd through the plain version, in float64, for random
    cotangents of dx, da and db: the gradients of x, a, b and g."""
    arrays = inputs(rng, shape, np.float64)
    grads = []
    for fn in (lambda *t: FusedTPReLUGrad.apply(*t, need_ab),
               lambda *t: ops.fused_tprelu_backward_plain(*t, need_ab)):
        leaves = [torch.from_numpy(v).requires_grad_(True) for v in arrays]
        outs = [o for o in fn(*leaves) if o is not None]
        cots = [torch.from_numpy(np.random.default_rng(i).standard_normal(o.shape))
                for i, o in enumerate(outs)]
        grads.append(torch.autograd.grad(outs, leaves, cots, allow_unused=True))
    for got, want in zip(*grads):
        if want is None:
            assert got is None or not got.any()
        else:
            torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)


def test_cpu_backward_counts_no_launch(rng, monkeypatch):
    """On the CPU the backward runs the plain version through the op: the
    Function calls it, and no launch is counted."""
    calls = []

    def counted(*args, _f=tprelu._backward):
        calls.append(args[-1])
        return _f(*args)

    monkeypatch.setattr(tprelu, "_backward", counted)
    ops.reset_launch_counts()
    x, a, b, _ = (torch.from_numpy(v).requires_grad_(True) for v in inputs(rng, (8, 4)))
    (FusedTPReLU.apply(x, a, b) ** 2).sum().backward()
    assert calls == [True]
    assert ops.launch_counts()["fused_tprelu_backward"] == 0
    assert all(v == 0 for v in ops.launch_counts().values())


def test_import_and_cpu_backward_load_no_triton():
    code = ("import sys, torch, gea_torch.ops.tprelu as t;"
            "x = torch.randn(4, 3, requires_grad=True);"
            "t.fused_tprelu(x, torch.full((3,), 0.25), torch.zeros(3)).sum().backward();"
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


@pytest.mark.parametrize("trainer,want", [
    ("g-lis", (3, 3)), ("g-lis batch norm", (5, 0)), ("r-separate", (4, 2)),
    ("r-iterative", (10, 10)),
])
def test_backward_calls_per_step(monkeypatch, trainer, want):
    """TPReLU backwards per train step, and how many of them compute da and
    db, which the card modules (`tests/test_torch_port_*_card.py`) assert as
    launches. At this config
    (a render and D's trunk have 1 TPReLU each, acts = 1; d = 2 under batch
    norm; R has 2): G-LIS 3 acts (G, D on reals and fakes, D for G's loss);
    batch norm d + 3 (d - 1), none with da/db (a fixed LeakyReLU); R-separate
    3 acts + 1, da/db only in R's acts + 1 (G and D frozen); R-iterative the
    joint unroll (3 renders, 2 R's: 7) and D three times."""
    step = {"g-lis": lambda: _glis("weight"), "g-lis batch norm": lambda: _glis("batch"),
            "r-separate": _r_separate, "r-iterative": _r_iterative}[trainer]()
    calls = []

    def counted(*args, _f=tprelu._backward):
        calls.append(args[-1])
        return _f(*args)

    monkeypatch.setattr(tprelu, "_backward", counted)
    step()
    assert (len(calls), sum(calls)) == want
