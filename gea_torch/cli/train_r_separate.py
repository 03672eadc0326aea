"""R-separate trainer CLI of the port (port of `gea/cli/train_r_separate.py`):
train a reverser R against a frozen generator read from a finished G-LIS
run of the port's own trainer. The architecture comes from the G run's
`config.json`, not from this tool's flags. No real data is needed: the
frozen G is the data source.

On the card, against a flagship G-LIS run:

    python -m gea_torch.cli.train_r_separate --g_path runs/glis3_80 \
        --save_path runs/rsep --niter 20000

A tiny run on the CPU, against the tiny G-LIS run of
`gea_torch/cli/train_glis.py`'s docstring, then its resume:

    RSEP=$(mktemp -d)
    python -m gea_torch.cli.train_r_separate --device cpu --g_path "$RUN" \
        --batch_size 4 --niter 4 --log_interval 2 --vis_interval 2 \
        --save_interval 2 --vis_rows 2 --save_path "$RSEP"
    # the same with --niter 6 prints "resumed from ... at step 4"

With `--fid_interval N` the run scores the proxy-FID of the corrected
samples G(blend(z, R(G(z)), --fid_correction_strength)) every N steps
against the G run's dataset (`make_fid_fn`) and pins the best R snapshot.

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
from gea_torch.cli.sample import load_discriminator, load_generator, read_run
from gea_torch.cli.train_glis import param_count
from gea_torch.config import TrainRSeparateConfig, refuse_unported
from gea_torch.eval.fid import OnlineFID
from gea_torch.models.reverter import corrected_render
from gea_torch.train.dispatch import build_step_fn
from gea_torch.train.runner import (
    TrainLoop,
    check_batch,
    is_lead,
    maybe_resume,
    no_input,
    prepare_run,
    run_trainer,
)
from gea_torch.train.state import create_r_state
from gea_torch.train.steps_r import build_r_separate_step
from gea_torch.utils.grids import save_stage_grids

ARCHITECTURE = ("image_size", "code_size", "norm", "r_iterations", "num_features",
                "max_features", "lis_hidden_mult", "spatial_code", "include_initial_image",
                "dtype")


def architecture_from_g(cfg: TrainRSeparateConfig, g_cfg) -> TrainRSeparateConfig:
    """The reverser tool takes every architecture field from the frozen
    generator's run config."""
    return cfg.replace(**{k: getattr(g_cfg, k) for k in ARCHITECTURE})


def make_vis_fn(cfg: TrainRSeparateConfig, generator, run_dir: str):
    """Before/after grids of a fixed noise batch: G(z) as stage 0 and
    G(R(G(z))) as stage 1. The noise comes from a `torch.Generator` seeded
    with seed + 999; the values differ from `gea`'s."""
    n_vis = cfg.vis_rows * cfg.vis_rows
    gen = torch.Generator().manual_seed(cfg.seed + 999)
    dev = generator.device
    z = torch.randn((n_vis, cfg.code_size), generator=gen).to(dev)
    sn_shape = generator.spatial_noise_shape(n_vis)
    sn = torch.randn(sn_shape, generator=gen).to(dev) if sn_shape else None

    def vis(state, step: int) -> None:
        with torch.no_grad():
            before = generator(z, sn, render_all_stages=True)[0][-1]
            after = generator(state.reverter(before), sn, render_all_stages=True)[0][-1]
        pair = torch.stack([before, after]).float().cpu().numpy()
        save_stage_grids(pair, os.path.join(run_dir, "samples"), step, rows=cfg.vis_rows)

    return vis


def make_fid_fn(cfg: TrainRSeparateConfig, g_cfg, generator, noise: Noise = seeded_noise):
    """Corrected-sample proxy-FID (--fid_interval): G(blend(z, R(G(z))))
    with the sampler's blend (strength --fid_correction_strength, shell
    renorm) against the G run's dataset, so that the tracker follows
    whether R's correction improves and pins the best R snapshot."""
    data_cfg = g_cfg.replace(batch_size=cfg.batch_size)
    online = OnlineFID(real_batch_iter(data_cfg, cfg.seed ^ 0xF1D, generator.device),
                       cfg.image_size, num_samples=cfg.fid_samples, device=generator.device)
    print(f"[gea_torch] --fid_interval {cfg.fid_interval}: tracking corrected-sample "
          f"{online.label} over {cfg.fid_samples} samples (strength "
          f"{cfg.fid_correction_strength})", flush=True)

    def fid_fn(state) -> float:
        draw = noise(generator, cfg.seed ^ 0xFAD)

        def fakes():
            while True:
                z, sn = draw(cfg.batch_size)
                with torch.no_grad():
                    images = corrected_render(generator, state.reverter, z, sn,
                                              cfg.fid_correction_strength)
                yield images

        return online.score(fakes())

    return fid_fn


def g_run(cfg: TrainRSeparateConfig):
    """(cfg with the frozen G's architecture, G's run config, its
    checkpoint)."""
    if not cfg.g_path:
        raise SystemExit("--g_path (the trained generator's run directory) is required")
    g_step = cfg.g_step or None  # 0 = latest, -1 = best.json
    g_cfg, restored = read_run(cfg.g_path, g_step)
    return architecture_from_g(cfg, g_cfg), g_cfg, restored


def build_state(device, cfg: TrainRSeparateConfig, g_cfg_restored=None):
    """R's fresh state against the frozen G (and D) of --g_path."""
    cfg, _, restored = g_cfg_restored or g_run(cfg)
    generator, _ = load_generator(cfg.g_path, device=device, restored=restored)
    discriminator = None
    if cfg.r_adv_weight > 0 or cfg.r_mine_weight > 0:
        # The D-feedback and mining terms need the G run's frozen D, from
        # the checkpoint that G came from.
        try:
            discriminator = load_discriminator(cfg.g_path, device=device, restored=restored)
        except KeyError as e:
            print(f"[gea_torch] no discriminator in {cfg.g_path!r} ({e}); falling back to "
                  "pure code-reconstruction MSE")
    return create_r_state(cfg, generator, discriminator, device=device)


def train(device, cfg: TrainRSeparateConfig, dp=None):
    """One rank's run of R (the only one without `dp`); returns (state,
    stats) as `train_glis.train` does. The state holds the frozen G and D
    it trained against."""
    lead = is_lead(dp)
    cfg, g_cfg, restored = found = g_run(cfg)
    run_dir = prepare_run(cfg, dp)
    check_batch(cfg, 1 if dp is None else dp.size)
    state = build_state(device, cfg, found)
    del restored, found
    generator = state.generator
    if lead:
        print(f"[gea_torch] R params: {param_count(state.reverter):,}  frozen G params: "
              f"{param_count(generator):,}  device: {device}")
    state, start_step = maybe_resume(cfg, state, dp)
    fid_fn = make_fid_fn(cfg, g_cfg, generator) if cfg.fid_interval > 0 and lead else None
    vis_fn = make_vis_fn(cfg, generator, run_dir) if lead else None
    loop = TrainLoop(cfg, run_dir, state, build_step_fn(cfg, build_r_separate_step(cfg, dp)),
                     no_input(), lambda batch, step: batch, vis_fn=vis_fn,
                     loss_keys=("loss_r",), fid_fn=fid_fn, dp=dp)
    final_state = loop.run(start_step)
    stats = {**loop.stats(), "metrics": loop.last_metrics}
    if lead:
        print(f"[gea_torch] done: {stats['images_per_sec']:.1f} img/s")
    return final_state, stats


def run(cfg: TrainRSeparateConfig):
    """Train R on the run's devices (`run_trainer`); returns the lead's
    (state, stats)."""
    refuse_unported(cfg)
    return run_trainer(cfg, train, build_state)


def main(argv: Optional[list] = None):
    return run(TrainRSeparateConfig.from_args(argv))


if __name__ == "__main__":
    main()
