"""`ServingModel.sample_filtered` on the card at the filter cell's shape
(160x160, spatial_code 4, bf16; 256 of 1,024 candidates in renders of 512)
against the host composition it replaced: `topk_rounds` over `sample`'s
renders, joined and cut on the host. Needs an NVIDIA card and skips
without one; imports no JAX, so on the card it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_serve_card.py
"""

import numpy as np
import pytest
import torch

from gea_torch import ModelConfig
from gea_torch.models import Discriminator, GeneratorLIS
from gea_torch.serve import ServingModel, topk_rounds


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
