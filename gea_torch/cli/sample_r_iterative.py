"""R-iterative sampler of the port (port of `gea/cli/sample_r_iterative.py`):
load a jointly trained G/R pair and render the correction chain
z_t = z_{t-1} + R(G(z_{t-1})), one grid per link.

    python -m gea_torch.cli.sample_r_iterative --load_path runs/riter \\
        --save_path_samples out/riter --chain_length 3

G is the single-stage generator the R-iterative trainer trains
(r_iterations=0). The noise comes from a `torch.Generator` seeded with
`--seed`; `run` takes another source as `noise(generator, seed) ->
draw(n)`, as `gea_torch.cli.sample.run` does.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from gea_torch.cli.sample import Noise, read_run, seeded_noise
from gea_torch.config import TrainRIterativeConfig, resolve_device
from gea_torch.models import GeneratorLIS, Reverter
from gea_torch.models.reverter import iterative_chain
from gea_torch.train.state import generator_config
from gea_torch.utils.grids import save_stage_grids


def run(load_path: str, save_path_samples: str, count: int = 64, batch_size: int = 64,
        seed: int = 0, grid_rows: int = 8, chain_length: Optional[int] = None, step: int = 0,
        device="cuda", noise: Noise = seeded_noise) -> str:
    """Write one grid set per batch; returns the output directory. The
    chain has the run's --r_chain_length links unless `chain_length` is
    given."""
    dev = resolve_device(device)
    cfg, ckpt = read_run(load_path, step or None, TrainRIterativeConfig)
    generator = GeneratorLIS(generator_config(cfg), device=dev)
    generator.load_state_dict(ckpt["generator"], strict=True)
    reverter = Reverter(cfg, device=dev)
    reverter.load_state_dict(ckpt["reverter"], strict=True)
    generator.eval()
    reverter.eval()
    links = chain_length if chain_length is not None else cfg.r_chain_length
    out_dir = save_path_samples or os.path.join(load_path, "samples_cli")
    os.makedirs(out_dir, exist_ok=True)

    draw = noise(generator, seed)
    done = batch_idx = 0
    while done < count:
        n = min(batch_size, count - done)
        z, sn = draw(n)
        with torch.no_grad():
            imgs = iterative_chain(generator, reverter, z.to(dev),
                                   None if sn is None else sn.to(dev), links)
        save_stage_grids(imgs.float().cpu().numpy(), out_dir, batch_idx, rows=grid_rows)
        done += n
        batch_idx += 1
    print(f"[gea_torch] wrote {batch_idx} chain grid sets to {out_dir}")
    return out_dir


def main(argv: Optional[list] = None, noise: Noise = seeded_noise) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True, help="R-iterative run dir")
    p.add_argument("--save_path_samples", default="")
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grid_rows", type=int, default=8)
    p.add_argument("--chain_length", type=int, default=None)
    p.add_argument("--step", type=int, default=0, help="checkpoint step to load (0 = latest)")
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the plain PyTorch versions of the kernels")
    a = p.parse_args(argv)
    return run(a.load_path, a.save_path_samples, a.count, a.batch_size, a.seed, a.grid_rows,
               a.chain_length, a.step, a.device, noise)


if __name__ == "__main__":
    main()
