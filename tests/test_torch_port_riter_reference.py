"""The port's R-iterative step (`gea_torch.train.steps_r.build_r_iterative_step`)
against the benchmark's plain reference (`portbench.reference.riter`), in
fp32 on the CPU at a tiny size, from the same seeded weights of G, D and R
(`portbench.weights`, as the benchmark's `riter` loop draws them) and the
same reals and z_0, over 3 steps: each step's losses, and after the last
step each player's Adam first moment and parameters.

Both sides are fp32 and differ only in the order of their sums (the
port's convs, weight norm and fused losses against plain `torch` ops), so
the tolerances are a few hundred fp32 roundings of each number's scale:

* losses: relative 1e-5 (each is a mean of 4 to 48 terms of size 0.1-1);
* first moments: a leaf's max |difference| under 1e-6 plus 1e-4 of its
  largest |value| (a moment is a mean of 3 gradients, each a sum over the
  batch and the image of products of the same order);
* parameters: 1e-6 plus 1e-6 of each |value|, about 8 fp32 roundings of a
  parameter's scale (Adam moves each by at most 3 lr = 3e-3, computed to a
  few roundings on either side, then added to a value of size up to 4).

A chain cut (R's output detached where the G/R loss differentiates it,
`portbench.faults_riter`'s `chain_cut`) must break them, and the reference
must load nothing of JAX, `gea` or `gea_torch`.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gea_torch.config import TrainRIterativeConfig  # noqa: E402
from gea_torch.train.state import RIterativeTrainState, make_optimizer  # noqa: E402
from gea_torch.train.steps_r import build_r_iterative_step  # noqa: E402
from portbench import faults_riter  # noqa: E402
from portbench.loops.riter import build_players  # noqa: E402
from portbench.reference import riter  # noqa: E402

TINY = dict(image_size=16, code_size=16, norm="weight", r_iterations=0, num_features=4,
            max_features=16, dtype="float32", batch_size=4, r_hidden=32, lr=1e-3,
            lambda_r=0.9, beta1=0.5, beta2=0.999)
STEPS = 3
SEED = 2 ** 31 + 77
LOSS_RTOL = 1e-5
MOMENT_ATOL, MOMENT_RTOL = 1e-6, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-6


def run_both(chain: int, remat: bool):
    """(port, reference), each {"metrics": [...], "moments", "params"}."""
    cfg = TrainRIterativeConfig(**TINY, r_chain_length=chain, remat=remat, device="cpu")
    g, d, r, w0 = build_players(cfg, SEED, torch.device("cpu"))
    opts = {who: make_optimizer(m.parameters(), cfg.lr, cfg.beta1, cfg.beta2)[0]
            for who, m in (("g", g), ("d", d), ("r", r))}
    state = RIterativeTrainState(generator=g, discriminator=d, reverter=r, opt_g=opts["g"],
                                 opt_d=opts["d"], opt_r=opts["r"], sched_g=None, sched_d=None,
                                 sched_r=None, rng=torch.Generator().manual_seed(1))
    step = build_r_iterative_step(cfg)
    gen = torch.Generator().manual_seed(SEED)
    reals = [torch.rand((4, 16, 16, 3), generator=gen) * 2 - 1 for _ in range(STEPS)]
    zs = [torch.randn((4, 16), generator=gen) for _ in range(STEPS)]
    metrics = [{k: float(v) for k, v in step(state, real, z=z).items()}
               for real, z in zip(reals, zs)]
    port = {"metrics": metrics,
            "moments": {who: {n: o.state[p].get("exp_avg", torch.zeros_like(p))
                              for n, p in m.named_parameters()}
                        for (who, o), m in zip(opts.items(), (g, d, r))},
            "params": {who: dict(m.named_parameters()) for who, m in (("g", g), ("d", d),
                                                                      ("r", r))}}
    hp = {"r_chain_length": chain, "lambda_r": cfg.lambda_r, "lr": cfg.lr, "beta1": cfg.beta1,
          "beta2": cfg.beta2}
    ref = riter.train_steps(w0["g"], w0["d"], w0["r"], reals, zs, [None] * STEPS, TINY, hp)
    return port, ref


def worst(port, ref):
    """The worst of each compared number, over its tolerance (1 = at it)."""
    loss = max(abs(p[k] - q[k]) / (LOSS_RTOL * abs(q[k]))
               for p, q in zip(port["metrics"], ref["metrics"])
               for k in ("loss_d", "loss_g", "loss_r_sim"))
    moment = param = 0.0
    for who in ("g", "d", "r"):
        for n, m in ref["moments"][who].items():
            got = port["moments"][who][n].detach()
            tol = MOMENT_ATOL + MOMENT_RTOL * float(m.abs().max())
            moment = max(moment, float((got - m).abs().max()) / tol)
            p, q = port["params"][who][n].detach(), ref["params"][who][n]
            gap = (p - q).abs() / (PARAM_ATOL + PARAM_RTOL * q.abs())
            param = max(param, float(gap.max()))
    return {"loss": loss, "moment": moment, "param": param}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("chain", [1, 2, 3])
def test_step_matches_the_plain_reference(chain, remat):
    port, ref = run_both(chain, remat)
    assert all(p["loss_r_sim"] > 0 for p in port["metrics"])
    got = worst(port, ref)
    assert all(v <= 1.0 for v in got.values()), got


@pytest.mark.parametrize("remat", [False, True])
def test_a_chain_cut_fails_the_comparison(remat):
    with faults_riter.planted("chain_cut"):
        port, ref = run_both(2, remat)
    got = worst(port, ref)
    assert got["moment"] > 1.0 and got["param"] > 1.0, got


def test_reference_loads_nothing_of_jax_gea_or_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); before = set(sys.modules)\n"
            "import portbench.reference.riter\n"
            "print(' '.join(sorted({m.split('.')[0] for m in set(sys.modules) - before})))")
    done = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    loaded = set(done.stdout.split())
    assert "portbench" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "orbax", "gea", "gea_torch"}, loaded
