"""The kernels' `torch.autograd.Function`s on the card (kernel forward;
the kernel backwards of TPReLU, the seed and LIS's chain) against autograd
through their plain versions, in fp32 and bf16: at every case of the
flagship train step and scored render (the R trainers differentiate
through the scoring and R-only shapes too), and `LISChain` (a kernel
forward a link, one kernel backward) as a G-LIS step differentiates it.
Gradients of every input within `GRAD_TOL` of their largest. Needs an
NVIDIA card and skips without one; imports no JAX, so on the card it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_functions_card.py
"""

import pytest
import torch
from torch_port_card_cases import card  # noqa: F401 -- the session fixture
from torch_port_card_cases import BATCH, KERNEL, PLAIN, cases, lis_chain_args, randn

from gea_torch import FLAGSHIP, ops

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]

# Tolerance on max |Function grad - plain grad| / max |plain grad|, per input
# and dtype. fp32: the same arithmetic in another order. bf16: autograd
# through the plain version rounds intermediate gradients to bf16 where the
# explicit backwards keep fp32 (the TPReLU's per-channel sums, LIS's hidden
# gradient), a few steps of 2^-8 relative.
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def cotangents():
    """One generator for both tests, in file order: the Functions' random
    cotangents, then the chain's inputs."""
    return torch.Generator().manual_seed(2)


def worst_grad_error(label: str, dt, got, want) -> float:
    """Each gradient in its input's dtype and finite; the largest
    max |got - want| / max |want|."""
    rel = 0.0
    for i, (gk, gp) in enumerate(zip(got, want)):
        assert gk.dtype == gp.dtype and torch.isfinite(gk).all(), (
            f"{label} {dt} grad {i}: {gk.dtype} vs {gp.dtype}")
        scale = gp.float().abs().max().item()
        rel = max(rel, (gk.float() - gp.float()).abs().max().item() / max(scale, 1e-30))
    return rel


def test_functions_match_autograd_through_their_plain_versions(cotangents):
    for name, label, _, _, make in cases(FLAGSHIP):
        for dt in (torch.float32, torch.bfloat16):
            args = make(dt)
            grads, cot = [], None
            for fn in (KERNEL[name], PLAIN[name]):
                leaves = [a.detach().clone().requires_grad_(True) if torch.is_tensor(a) else a
                          for a in args]
                out = fn(*leaves)
                if cot is None:
                    cot = (torch.randn(out.shape, generator=cotangents) * 0.1).to("cuda", out.dtype)
                inputs = [t for t in leaves if torch.is_tensor(t)]
                grads.append(torch.autograd.grad(out, inputs, cot, retain_graph=True))
            torch.cuda.synchronize()
            rel = worst_grad_error(f"{name} {label}", dt, *grads)
            print(f"[grad] {name} {label} {str(dt)[6:]}: max|err|/max|grad| {rel:.3e}")
            assert rel <= GRAD_TOL[dt], (f"{name} {label} {dt}: gradients differ by {rel:.3e} of "
                                         f"their max > {GRAD_TOL[dt]}")
            del args, grads


def test_lis_chain_matches_autograd_through_the_plain_links(cotangents):
    """`LISChain` against autograd through the links' plain versions, a
    cotangent on every output, z0 drawn."""
    code, links = FLAGSHIP.code_size, FLAGSHIP.r_iterations
    hidden = code * FLAGSHIP.lis_hidden_mult
    for dt in (torch.float32, torch.bfloat16):
        zs, *weights, gs = lis_chain_args(BATCH, code, hidden, links, dt, cotangents)
        params = [(*w, randn(code, cotangents, 0.1)) for w in zip(*weights[:5])]
        grads = []
        for kernel in (True, False):
            leaves = [[t.detach().clone().requires_grad_(True) for t in link] for link in params]
            if kernel:
                outs = ops.lis_chain(zs[0], leaves)
            else:
                outs, z = [], zs[0]
                for link in leaves:
                    z = ops.lis_residual_mlp_plain(z, *link)
                    outs.append(z)
            flat = [t for link in leaves for t in link]
            grads.append(torch.autograd.grad(outs, flat, gs, retain_graph=True))
        torch.cuda.synchronize()
        rel = worst_grad_error("LIS chain", dt, *grads)
        print(f"[grad] lis_chain {links} x ({BATCH}, {code}) x ({code}, {hidden}) "
              f"{str(dt)[6:]}: max|err|/max|grad| {rel:.3e}")
        assert rel <= GRAD_TOL[dt], (f"LIS chain {dt}: gradients differ by {rel:.3e} of their "
                                     f"max > {GRAD_TOL[dt]}")
