"""R-separate sampler of the port (port of `gea/cli/sample_r_separate.py`):
load an R-separate run's reverser and the frozen generator it was trained
against, and render the post-hoc correction chain G(z), G(R(G(z))), ... up
to --correction_steps, one grid per link.

    python -m gea_torch.cli.sample_r_separate --load_path runs/rsep \\
        --save_path_samples out/rsep --count 64

`load_reverter` is also how `compute_fid --r_path` reads an R-separate
run directory (`config.json` and `checkpoints/<step>/state.pt` of the
port's R-separate trainer). The noise comes from a `torch.Generator`
seeded with `--seed`; `run` takes another source as `noise(generator,
seed) -> draw(n)`, as `gea_torch.cli.sample.run` does.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import torch

from gea_torch.cli.sample import Noise, load_generator, read_run, seeded_noise
from gea_torch.config import TrainRSeparateConfig, resolve_device
from gea_torch.models import Reverter
from gea_torch.models.reverter import blend_correction
from gea_torch.utils.grids import save_stage_grids


def load_reverter(load_path: str, step: Optional[int] = None,
                  device="cuda") -> Tuple[Reverter, TrainRSeparateConfig]:
    """(the run's R with the weights of `step`, in inference mode, and the
    run's config): the latest step for None, the best.json step for -1."""
    cfg, ckpt = read_run(load_path, step, TrainRSeparateConfig)
    reverter = Reverter(cfg, device=device)
    reverter.load_state_dict(ckpt["reverter"], strict=True)
    return reverter.eval(), cfg


def correction_chain(generator, reverter: Reverter, z: torch.Tensor,
                     sn: Optional[torch.Tensor], steps: int, strength: float,
                     shell_renorm: bool) -> torch.Tensor:
    """The final stage of G at z and after each of `steps` corrections
    z <- blend(z, R(G(z))): (steps + 1, B, H, W, 3) in the compute dtype."""
    imgs = [generator(z, sn, render_all_stages=True)[0][-1]]
    for _ in range(steps):
        z = blend_correction(z, reverter(imgs[-1]), strength, shell_renorm)
        imgs.append(generator(z, sn, render_all_stages=True)[0][-1])
    return torch.stack(imgs)


def run(load_path: str, save_path_samples: str, count: int = 64, batch_size: int = 64,
        seed: int = 0, grid_rows: int = 8, correction_steps: int = 2,
        correction_strength: float = 0.3, shell_renorm: bool = True, step: int = 0,
        device="cuda", noise: Noise = seeded_noise) -> str:
    """Write one grid set per batch; returns the output directory."""
    dev = resolve_device(device)
    reverter, r_cfg = load_reverter(load_path, step=step or None, device=dev)
    # The frozen G that R was trained against (--g_step of the R run;
    # 0 = latest, -1 = best.json).
    generator, _ = load_generator(r_cfg.g_path, step=r_cfg.g_step or None, device=dev)
    out_dir = save_path_samples or os.path.join(load_path, "samples_cli")
    os.makedirs(out_dir, exist_ok=True)

    draw = noise(generator, seed)
    done = batch_idx = 0
    while done < count:
        n = min(batch_size, count - done)
        z, sn = draw(n)
        with torch.no_grad():
            imgs = correction_chain(generator, reverter, z.to(dev),
                                    None if sn is None else sn.to(dev), correction_steps,
                                    correction_strength, shell_renorm)
        save_stage_grids(imgs.float().cpu().numpy(), out_dir, batch_idx, rows=grid_rows)
        done += n
        batch_idx += 1
    print(f"[gea_torch] wrote {batch_idx} correction-chain grid sets to {out_dir}")
    return out_dir


def main(argv: Optional[list] = None, noise: Noise = seeded_noise) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True, help="R-separate run dir")
    p.add_argument("--save_path_samples", default="")
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grid_rows", type=int, default=8)
    p.add_argument("--correction_steps", type=int, default=2,
                   help="number of R correction applications to visualize")
    p.add_argument("--correction_strength", type=float, default=0.3,
                   help="blend weight toward R's corrected code (the similarity constraint "
                   "applied at inference); 1.0 = pure R output")
    p.add_argument("--step", type=int, default=0, help="R checkpoint step to load (0 = latest)")
    p.add_argument("--shell_renorm", type=lambda v: v.lower() in ("1", "true", "yes"),
                   default=True, help="project corrected codes back onto the Gaussian shell")
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the plain PyTorch versions of the kernels")
    a = p.parse_args(argv)
    return run(a.load_path, a.save_path_samples, a.count, a.batch_size, a.seed, a.grid_rows,
               a.correction_steps, a.correction_strength, a.shell_renorm, a.step, a.device,
               noise)


if __name__ == "__main__":
    main()
