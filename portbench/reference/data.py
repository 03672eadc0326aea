"""The synthetic training batches, made again from the seed: smooth
coloured gradients plus noise in [-1, 1], one generator a step, keyed by
(seed ^ 0x5EED, step) through numpy's SeedSequence, as `gea`'s on-device
synthetic family draws them."""

from __future__ import annotations

import math

import numpy as np
import torch

DATA_SEED_MIX = 0x5EED


def step_seed(seed: int, step: int) -> int:
    key = np.random.SeedSequence([seed ^ DATA_SEED_MIX, step]).generate_state(1, np.uint64)
    return int(key[0]) & 0x7FFF_FFFF_FFFF_FFFF


def synthetic_reals(seed: int, step: int, batch: int, size: int,
                    device: torch.device) -> torch.Tensor:
    """(batch, size, size, 3) float32: the real batch of 0-based `step`."""
    gen = torch.Generator(device).manual_seed(step_seed(seed, step))
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    yy, xx = grid.view(1, size, 1, 1), grid.view(1, 1, size, 1)
    phase = torch.rand((batch, 1, 1, 3), generator=gen, device=device)
    base = 0.5 + 0.5 * torch.sin(2 * math.pi * (yy * phase + xx))
    noise = torch.rand(base.shape, generator=gen, device=device) * 0.1
    return torch.clamp(base + noise, 0.0, 1.0) * 2.0 - 1.0
