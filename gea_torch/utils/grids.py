"""Sample grids (port of `gea/utils/grids.py`): a fixed noise batch tiled
into one PNG per LIS stage every `--vis_interval`. The PNG is written with
`zlib` and `struct` from the standard library, so grids need no PIL; the
stage GIF, which only the samplers write, imports PIL when called."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float (B, H, W, 3) -> uint8."""
    images = np.asarray(images, dtype=np.float32)
    return np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)


def tile_grid(images: np.ndarray, rows: int, pad: int = 2) -> np.ndarray:
    """(B, H, W, 3) uint8 -> one tiled grid image, row-major."""
    b, h, w, c = images.shape
    cols = (b + rows - 1) // rows
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, c), 255, np.uint8)
    for i in range(b):
        r, col = divmod(i, cols)
        if r >= rows:
            break
        grid[r * (h + pad):r * (h + pad) + h, col * (w + pad):col * (w + pad) + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG, every row with
    filter 0."""
    h, w, c = image.shape
    if c != 3 or image.dtype != np.uint8:
        raise ValueError(f"want (H, W, 3) uint8, got {image.shape} {image.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def save_image_grid(images: np.ndarray, path: str, rows: int = 8,
                    already_uint8: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = images if already_uint8 else to_uint8(images)
    write_png(path, tile_grid(arr, rows))


def save_stage_gif(stage_images: np.ndarray, path: str, rows: int = 8,
                   duration_ms: int = 600) -> None:
    """Animated GIF whose frame s is the grid of stage s's renders."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [Image.fromarray(tile_grid(to_uint8(stage_images[s]), rows))
              for s in range(stage_images.shape[0])]
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=duration_ms,
                   loop=0)


def save_stage_grids(stage_images: np.ndarray, out_dir: str, step: int, rows: int = 8) -> None:
    """(S, B, H, W, 3) in [-1, 1] -> one grid PNG per LIS stage."""
    for s in range(stage_images.shape[0]):
        save_image_grid(stage_images[s],
                        os.path.join(out_dir, f"samples_{step:08d}_stage{s}.png"), rows=rows)
