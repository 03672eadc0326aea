"""`ServingModel.sample_filtered` on the card at the filter cell's shape
(160x160, spatial_code 4, bf16; 256 of 1,024 candidates in renders of 512)
against the host composition it replaced: `topk_rounds` over `sample`'s
renders, joined and cut on the host; and the final-stage render of a
function without stages against the every-stage render. Needs an NVIDIA
card and skips
without one; imports no JAX, so on the card it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_serve_card.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gea_torch import ModelConfig
from gea_torch.models import Discriminator, GeneratorLIS
from gea_torch.serve import ServingModel, topk_rounds
from gea_torch.utils import trace

CELL_LIMITS = Path(__file__).resolve().parents[1] / "portbench" / "limits" / "glis160-filter.json"


@pytest.mark.card
@pytest.mark.parametrize("all_stages,rounds,sharded", [(False, 1, False), (True, 3, False),
                                                       (False, 1, True)])
def test_filtered_request_on_the_card_equals_the_host_composition(all_stages, rounds, sharded):
    """One request; with `sharded`, every card's replica renders on a
    stream of its own and the winners are gathered onto the model's card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = ModelConfig(image_size=160, code_size=256, r_iterations=3, spatial_code=4,
                      dtype="bfloat16")
    torch.manual_seed(0)
    model = ServingModel.from_modules(GeneratorLIS(cfg, device="cuda"),
                                      Discriminator(cfg, device="cuda"), all_stages=all_stages)
    if sharded:
        model = model.sharded()
    count, seed, batch, oversample = 256, 2 ** 31 + 7, 512, 4
    threshold = 0.0 if rounds == 1 else 1.1  # no score clears 1.1: every round runs
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same render twice, bit for bit
    try:
        got = model.sample_filtered(count, seed=seed, batch_size=batch, oversample=oversample,
                                    threshold=threshold, max_rounds=rounds)
        want, ran = topk_rounds(
            lambda r: model.sample(count * oversample, seed=seed + r, batch_size=batch),
            count, threshold=threshold, max_rounds=rounds)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert ran == rounds
    assert list(got) == list(want)
    assert got["images"].shape == (count, 160, 160, 3)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.card
def test_the_final_stage_alone_serves_what_every_stage_serves_on_the_card():
    """At the filter cell's shape, a function without stages (the final
    stage rendered alone, B rows) returns images and scores within the
    cell's `image_mae` and `score_gap` of the every-stage render (S x B
    rows), and one filtered request of 2 renders counts 2 stages."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = ModelConfig(image_size=160, code_size=256, r_iterations=3, spatial_code=4,
                      dtype="bfloat16")
    torch.manual_seed(1)
    g, d = GeneratorLIS(cfg, device="cuda"), Discriminator(cfg, device="cuda")
    final = ServingModel.from_modules(g, d, all_stages=False)
    every = ServingModel.from_modules(g, d, all_stages=True)
    rng = np.random.default_rng(2 ** 31 + 11)
    batch = 512
    z = rng.standard_normal((batch, cfg.code_size)).astype(np.float32)
    sn = rng.standard_normal((batch, *final.spatial_noise_shape)).astype(np.float32)
    got, want = final(z, sn), every(z, sn)
    limits = json.loads(CELL_LIMITS.read_text())["numbers"]
    diff = np.abs(got["images"].astype(np.float64) - want["images"].astype(np.float64))
    mae = float(diff.reshape(batch, -1).mean(axis=1).max())
    gap = float(np.abs(got["scores"] - want["scores"]).max())
    print(f"final stage alone against every stage: image_mae {mae}, score_gap {gap}")
    assert mae <= limits["image_mae"]
    assert gap <= limits["score_gap"]
    was = trace.enable(True)
    trace.reset()
    try:
        final.sample_filtered(256, seed=2 ** 31 + 13, batch_size=batch, oversample=4)
        assert trace.counters() == {"serve.stages_rendered": 2}
    finally:
        trace.enable(*was)
        trace.reset()
