"""R-iterative at the `riter80-train` cell's shape on the card (80x80, code
256, nf 64 / cap 512, bf16 on fp32 parameters, batch 64, T = 2 links, K = 8
graphed steps a dispatch) against the plain fp32 reference
(`portbench.reference.riter`): the first replay of the captured graph from
the seed's weights, held to the cell's limits (`portbench/limits/
riter80-train.json`) on two seeds, and the chain cut beyond one of them.
Then the step's spans and counters with the tracer on: they run in the
dispatcher's eager warm-up step, and neither in the capture nor in a
replay.
Needs an NVIDIA card and skips without one; imports no JAX, so on the card
it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_riter_card.py
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults_riter, harness  # noqa: E402

RITER_SPANS = {"riter.d": 1, "riter.unroll": 2, "riter.link": 4, "riter.gr_backward": 1}


def reading(seed: int, fault=None):
    cell = harness.find_cell("riter80-train")
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=torch.device("cuda"))
    run.loop_name = cell.mix["loop"]
    with faults_riter.planted(fault):
        return faults_riter.reading(run), cell.limits["numbers"]


@pytest.mark.card
@pytest.mark.parametrize("seed,fault", [(2 ** 31 + 11, None), (3 * 2 ** 31 + 5, None),
                                        (2 ** 31 + 13, "chain_cut")])
def test_cell_shape_matches_the_reference(seed, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    numbers, limits = reading(seed, fault)
    within = {k: numbers[k] <= limits[k] for k in limits}
    assert all(within.values()) == (fault is None), (numbers, limits)


@pytest.mark.card
def test_spans_run_in_the_warm_up_and_never_in_the_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from gea_torch.config import TrainRIterativeConfig
    from gea_torch.train import build_r_iterative_step, create_r_iterative_state
    from gea_torch.train.dispatch import build_step_fn
    from gea_torch.utils import trace

    flags = harness.find_cell("riter80-train").config["flags"]
    cfg = TrainRIterativeConfig(**flags, steps_per_dispatch=2, device="cuda")
    state = create_r_iterative_state(cfg, device="cuda")
    fn = build_step_fn(cfg, build_r_iterative_step(cfg))
    reals = [torch.zeros((cfg.batch_size, 80, 80, 3), device="cuda")] * 2
    trace.enable(True)
    trace.reset()
    try:
        seen = []
        for _ in range(2):  # warm-up, capture and replay; then a replay alone
            fn(state, reals)
            torch.cuda.synchronize()
            seen.append(({k: v.count for k, v in trace.totals().items()}, trace.counters()))
    finally:
        trace.enable(False)
        trace.reset()
    dispatch = ("dispatch.noise", "dispatch.fill", "dispatch.replay")
    for chunks, (spans, counters) in enumerate(seen, 1):
        assert spans == {**RITER_SPANS, **{n: chunks for n in dispatch}}, spans
        assert counters == {"riter.links": 4, "riter.renders": 6}, counters
    assert state.step == 4
