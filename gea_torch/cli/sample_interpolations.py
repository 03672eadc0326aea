"""Interpolation sampler of the port (port of
`gea/cli/sample_interpolations.py`): walk between pairs of noise vectors
(spherical or linear interpolation) and render the walk per LIS stage; each
stage's grid has one row per pair.

    python -m gea_torch.cli.sample_interpolations --load_path runs/glis3_80 \\
        --save_path_samples out/interp --interp_pairs 8 --interp_points 10

The pairs and their spatial noise come from a `torch.Generator` seeded
with `--seed` (`gea`'s from `jax.random`); `run` takes another source as
`pairs(generator, seed, n_pairs) -> (z pairs (2, n_pairs, code), spatial
noise (n_pairs, ...) or None)`.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gea_torch.cli.sample import load_generator
from gea_torch.config import SampleInterpolationsConfig, refuse_unported, resolve_device
from gea_torch.utils.grids import tile_grid, to_uint8, write_png

Pairs = Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]


def slerp(z_a: torch.Tensor, z_b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation from z_a to z_b at the fractions t (a
    trailing axis is added to t): a Gaussian's mass lies on a shell, which
    slerp follows and lerp cuts through. Nearly parallel pairs (sin(omega)
    < 1e-6) fall back to lerp instead of dividing by about 0."""
    a = z_a / torch.linalg.vector_norm(z_a, dim=-1, keepdim=True)
    b = z_b / torch.linalg.vector_norm(z_b, dim=-1, keepdim=True)
    omega = torch.arccos(torch.clamp(torch.sum(a * b, dim=-1, keepdim=True), -1, 1))
    so = torch.sin(omega)
    t = t[..., None]
    safe_so = torch.where(so < 1e-6, torch.ones_like(so), so)
    spherical = (torch.sin((1.0 - t) * omega) / safe_so * z_a
                 + torch.sin(t * omega) / safe_so * z_b)
    linear = (1.0 - t) * z_a + t * z_b
    return torch.where(so < 1e-6, linear, spherical)


def seeded_pairs(generator, seed: int, n_pairs: int):
    """(z pairs (2, n_pairs, code), one spatial-noise draw per pair or
    None), standard normal from a `torch.Generator` seeded with `seed`."""
    dev = generator.device
    gen = torch.Generator(dev).manual_seed(seed)
    pairs = torch.randn((2, n_pairs, generator.cfg.code_size), generator=gen, device=dev)
    shape = generator.spatial_noise_shape(n_pairs)
    return pairs, (torch.randn(shape, generator=gen, device=dev) if shape else None)


def walk_codes(pairs: torch.Tensor, points: int, mode: str) -> torch.Tensor:
    """(2, P, code) pairs -> (P * points, code): each pair's walk from z_a
    to z_b at `points` evenly spaced fractions, pair after pair."""
    t = torch.linspace(0.0, 1.0, points, device=pairs.device)
    z_a, z_b = pairs[0][:, None, :], pairs[1][:, None, :]  # (P, 1, code)
    if mode == "slerp":
        walk = slerp(z_a, z_b, t)
    else:
        walk = z_a * (1 - t[:, None]) + z_b * t[:, None]
    return walk.reshape(-1, pairs.shape[-1])


def run(cfg: SampleInterpolationsConfig, pairs: Pairs = seeded_pairs) -> np.ndarray:
    """Write interpolation_stage<s>.png for every stage; returns the
    rendered stage images (S, pairs * points, H, W, 3) in fp32."""
    device = resolve_device(cfg.device)
    step = cfg.step if cfg.step != 0 else None  # -1 = best.json
    generator, train_cfg = load_generator(cfg.load_path, step=step, device=device,
                                          use_ema=cfg.use_ema)
    out_dir = cfg.save_path_samples or os.path.join(cfg.load_path, "interp_cli")
    os.makedirs(out_dir, exist_ok=True)

    z_pairs, sn_pair = pairs(generator, cfg.seed, cfg.interp_pairs)
    z = walk_codes(z_pairs.to(device), cfg.interp_points, cfg.interp_mode)
    # One spatial-noise draw per pair, repeated over that pair's points:
    # noise drawn per frame would make adjacent frames flicker.
    sn = None if sn_pair is None else sn_pair.to(device).repeat_interleave(cfg.interp_points, 0)
    with torch.no_grad():
        images = generator.render(z, sn)[0].cpu().numpy()
    for s in range(images.shape[0]):
        write_png(os.path.join(out_dir, f"interpolation_stage{s}.png"),
                  tile_grid(to_uint8(images[s]), rows=cfg.interp_pairs))
    print(f"[gea_torch] wrote {images.shape[0]} interpolation grids to {out_dir}")
    return images


def main(argv: Optional[list] = None, pairs: Pairs = seeded_pairs) -> np.ndarray:
    cfg = SampleInterpolationsConfig.from_args(argv)
    refuse_unported(cfg)
    if not cfg.load_path:
        raise SystemExit("--load_path is required")
    return run(cfg, pairs)


if __name__ == "__main__":
    main()
