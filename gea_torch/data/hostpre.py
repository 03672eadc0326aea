"""Preprocess on the host (port of `gea/data/hostpre.py`), in numpy and
PIL, imported only when used.

* `host_preprocess`: the whole transform chain on the host
  (`--on_device_pipeline false`); float32 batches then go to the device.
* `host_downsample_uint8`: crop and downsample on the host, for
  `--host_resize`; flip and normalise stay on the device.
"""

from __future__ import annotations

import numpy as np


def host_preprocess(raw: np.ndarray, rng: np.random.Generator, crop_size: int,
                    image_size: int, augment_flip: bool = True) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, image_size, image_size, 3) float32 [-1,1]."""
    from PIL import Image

    b, h, w, _ = raw.shape
    cs = min(crop_size, h, w)
    top, left = (h - cs) // 2, (w - cs) // 2
    cropped = raw[:, top:top + cs, left:left + cs, :]
    if cs != image_size:
        out = np.empty((b, image_size, image_size, 3), np.uint8)
        for i in range(b):
            out[i] = np.asarray(Image.fromarray(cropped[i]).resize(
                (image_size, image_size), Image.BILINEAR))
    else:
        out = cropped
    x = out.astype(np.float32) / 127.5 - 1.0
    if augment_flip:
        flip = rng.random(b) < 0.5
        x[flip] = x[flip, :, ::-1, :]
    return x


def host_downsample_uint8(raw: np.ndarray, crop_size: int, image_size: int) -> np.ndarray:
    """(B, H, W, 3) uint8 -> (B, image_size, image_size, 3) uint8: center
    crop, then a box mean for integer ratios (rounded half up) or PIL's
    bilinear resize for others."""
    b, h, w, _ = raw.shape
    cs = min(crop_size, h, w)
    top, left = (h - cs) // 2, (w - cs) // 2
    x = raw[:, top:top + cs, left:left + cs, :]
    if cs == image_size:
        return np.ascontiguousarray(x)
    if cs % image_size == 0:
        k = cs // image_size
        if k == 2:
            # 160 -> 80: shift-add in uint16, faster than a float mean.
            a = x.astype(np.uint16)
            s = a[:, 0::2, 0::2] + a[:, 0::2, 1::2] + a[:, 1::2, 0::2] + a[:, 1::2, 1::2]
            return ((s + 2) >> 2).astype(np.uint8)
        s = x.reshape(b, image_size, k, image_size, k, 3).astype(np.uint32).sum(axis=(2, 4))
        return ((s + k * k // 2) // (k * k)).astype(np.uint8)
    from PIL import Image

    out = np.empty((b, image_size, image_size, 3), np.uint8)
    for i in range(b):
        out[i] = np.asarray(Image.fromarray(x[i]).resize((image_size, image_size),
                                                         Image.BILINEAR))
    return out
