"""Preprocess on the device (port of `gea/data/ondevice.py`).

The host decodes to fixed-size uint8 (3 bytes a pixel on the host link);
the device does the rest:

* center crop to `crop_size` (a no-op for folder batches, which decode
  already cropped),
* bilinear resize to `image_size`, antialiased when it shrinks
  (`F.interpolate(..., antialias=True)` reproduces `jax.image.resize`'s
  bilinear antialiased resize),
* a per-image horizontal flip,
* uint8 -> float32 in [-1, 1].

`synthetic_batch` draws the synthetic family of
`gea_torch.data.pipeline.SyntheticDataset` on the device, so the synthetic
path moves nothing from the host.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def synthetic_batch(gen: torch.Generator, batch: int, size: int) -> torch.Tensor:
    """(batch, size, size, 3) float32 in [-1, 1] on the generator's device:
    smooth colored gradients plus noise, drawn from `gen`."""
    dev = gen.device
    grid = torch.arange(size, device=dev, dtype=torch.float32) / size
    yy, xx = grid.view(1, size, 1, 1), grid.view(1, 1, size, 1)
    phase = torch.rand((batch, 1, 1, 3), generator=gen, device=dev)
    base = 0.5 + 0.5 * torch.sin(2 * math.pi * (yy * phase + xx))
    noise = torch.rand(base.shape, generator=gen, device=dev) * 0.1
    return torch.clamp(base + noise, 0.0, 1.0) * 2.0 - 1.0


def flip_mask(gen: torch.Generator, batch: int) -> torch.Tensor:
    """(batch,) bools, each true with probability 1/2, drawn from `gen`."""
    return torch.rand(batch, generator=gen, device=gen.device) < 0.5


def preprocess_batch(
    raw: torch.Tensor,
    crop_size: int,
    image_size: int,
    augment_flip: bool = True,
    flip: Optional[torch.Tensor] = None,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, image_size, image_size, 3) float32 in
    [-1, 1], on raw's device. With `augment_flip`, image i is mirrored where
    `flip[i]` is true; without a mask given, the mask is drawn from `gen`."""
    b, h, w, _ = raw.shape
    cs = min(crop_size, h, w)
    top, left = (h - cs) // 2, (w - cs) // 2
    x = raw[:, top:top + cs, left:left + cs, :].float() / 127.5 - 1.0
    if cs != image_size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size, image_size),
                          mode="bilinear", align_corners=False, antialias=cs > image_size)
        x = x.permute(0, 2, 3, 1)
    if augment_flip:
        if flip is None:
            flip = flip_mask(gen, b)
        x = torch.where(flip.view(b, 1, 1, 1), x.flip(2), x)
    return x.contiguous()
