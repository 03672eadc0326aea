"""R-iterative trainer CLI of the port (port of `gea/cli/train_r_iterative.py`):
G, D and R trained jointly, with the correction chain
z_t = z_{t-1} + R(G(z_{t-1})) unrolled inside every step and the similarity
penalty lambda_r keeping corrected codes near the originals. G is the plain
conv core (r_iterations=0), as `gea` builds it.

On the card, with synthetic data drawn on the device:

    python -m gea_torch.cli.train_r_iterative --dataset synthetic \
        --synthetic_on_device true --image_size 80 --crop_size 160 \
        --r_chain_length 2 --lambda_r 0.9 --save_path runs/riter

A tiny run on the CPU in a fresh directory, then its resume:

    RIT=$(mktemp -d)
    python -m gea_torch.cli.train_r_iterative --device cpu --dataset synthetic \
        --image_size 16 --crop_size 32 --code_size 16 --num_features 4 \
        --max_features 16 --r_hidden 32 --batch_size 4 --dtype float32 \
        --niter 4 --log_interval 2 --vis_interval 2 --save_interval 2 \
        --vis_rows 2 --save_path "$RIT"
    # the same with --niter 6 prints "resumed from ... at step 4"

With `--fid_interval N` the run scores the proxy-FID of the chain's end
G(z_T) every N steps (`make_fid_fn`) and pins the best joint G/R snapshot.

`--num_devices N` and `--multihost` split the batch over ranks, and
`--model_shards M` shards the trained modules' Adam state and EMA over a
(N / M, M) world, as in `gea_torch.cli.train_glis`.

The flags are `gea`'s, plus `--device`; `--use_pallas`, which the port
does not implement, raises SystemExit when set
(`gea_torch.config.refuse_unported`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from gea_torch.cli.compute_fid import Noise, real_batch_iter, seeded_noise
from gea_torch.cli.train_glis import param_count
from gea_torch.config import TrainRIterativeConfig, refuse_unported
from gea_torch.eval.fid import OnlineFID
from gea_torch.models.reverter import iterative_chain
from gea_torch.train.dispatch import build_step_fn
from gea_torch.train.runner import (
    TrainLoop,
    check_batch,
    input_iterator,
    is_lead,
    make_input_fn,
    maybe_resume,
    prepare_run,
    run_trainer,
)
from gea_torch.train.state import create_r_iterative_state
from gea_torch.train.steps_r import build_r_iterative_step
from gea_torch.utils.grids import save_stage_grids


def make_vis_fn(cfg: TrainRIterativeConfig, generator, run_dir: str):
    """Per-link grids of the correction chain of a fixed noise batch:
    G(z_0), G(z_1), ..., G(z_T) as stages 0..T. The noise comes from a
    `torch.Generator` seeded with seed + 999; the values differ from
    `gea`'s."""
    n_vis = cfg.vis_rows * cfg.vis_rows
    gen = torch.Generator().manual_seed(cfg.seed + 999)
    dev = generator.device
    z0 = torch.randn((n_vis, cfg.code_size), generator=gen).to(dev)
    sn_shape = generator.spatial_noise_shape(n_vis)
    sn = torch.randn(sn_shape, generator=gen).to(dev) if sn_shape else None

    def vis(state, step: int) -> None:
        with torch.no_grad():
            imgs = iterative_chain(state.generator, state.reverter, z0, sn, cfg.r_chain_length)
        save_stage_grids(imgs.float().cpu().numpy(), os.path.join(run_dir, "samples"), step,
                         rows=cfg.vis_rows)

    return vis


def make_fid_fn(cfg: TrainRIterativeConfig, device, noise: Noise = seeded_noise):
    """--fid_interval for R-iterative: proxy-FID of the end of the
    correction chain, G(z_T), against the training data."""
    online = OnlineFID(real_batch_iter(cfg, cfg.seed ^ 0xF1D, device), cfg.image_size,
                       num_samples=cfg.fid_samples, device=device)
    print(f"[gea_torch] --fid_interval {cfg.fid_interval}: tracking chain-end {online.label} "
          f"over {cfg.fid_samples} samples", flush=True)

    def fid_fn(state) -> float:
        draw = noise(state.generator, cfg.seed ^ 0xFAD)

        def fakes():
            while True:
                z, sn = draw(cfg.batch_size)
                with torch.no_grad():
                    images = iterative_chain(state.generator, state.reverter, z, sn,
                                             cfg.r_chain_length)[-1]
                yield images

        return online.score(fakes())

    return fid_fn


def build_state(device, cfg: TrainRIterativeConfig):
    return create_r_iterative_state(cfg, device=device)


def train(device, cfg: TrainRIterativeConfig, dp=None):
    """One rank's run of G, D and R (the only one without `dp`); returns
    (state, stats) as `train_glis.train` does."""
    lead = is_lead(dp)
    run_dir = prepare_run(cfg, dp)
    check_batch(cfg, 1 if dp is None else dp.size)
    state = build_state(device, cfg)
    if lead:
        print(f"[gea_torch] G {param_count(state.generator):,} | D "
              f"{param_count(state.discriminator):,} | R {param_count(state.reverter):,} "
              f"params, device: {device}, chain links/step: {cfg.r_chain_length}")
    state, start_step = maybe_resume(cfg, state, dp)
    data = input_iterator(cfg, device, cfg.seed, start_step=start_step, dp=dp)
    fid_fn = make_fid_fn(cfg, device) if cfg.fid_interval > 0 and lead else None
    vis_fn = make_vis_fn(cfg, state.generator, run_dir) if lead else None
    loop = TrainLoop(cfg, run_dir, state, build_step_fn(cfg, build_r_iterative_step(cfg, dp)),
                     data, make_input_fn(cfg, device, dp), vis_fn=vis_fn,
                     loss_keys=("loss_d", "loss_g", "loss_r_sim"), fid_fn=fid_fn, dp=dp)
    try:
        final_state = loop.run(start_step)
    finally:
        data.close()  # ends the prefetch thread
    stats = {**loop.stats(), "metrics": loop.last_metrics}
    if lead:
        print(f"[gea_torch] done: {stats['images_per_sec']:.1f} img/s "
              f"({stats['images_per_sec_per_chip']:.1f}/chip)")
    return final_state, stats


def run(cfg: TrainRIterativeConfig):
    """Train G, D and R on the run's devices (`run_trainer`); returns the
    lead's (state, stats)."""
    refuse_unported(cfg)
    return run_trainer(cfg, train, build_state)


def main(argv: Optional[list] = None):
    return run(TrainRIterativeConfig.from_args(argv))


if __name__ == "__main__":
    main()
