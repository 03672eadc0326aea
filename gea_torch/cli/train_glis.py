"""G-LIS trainer CLI of the port (port of `gea/cli/train_glis.py`).

Flagship on the card, with synthetic data drawn on the device:

    python -m gea_torch.cli.train_glis --dataset synthetic \
        --synthetic_on_device true --image_size 80 --crop_size 160 \
        --r_iterations 3 --batch_size 64 --niter 1000 --save_path runs/glis3_80

A tiny run on the CPU (the kernels' plain versions) in a fresh directory,
then its resume:

    RUN=$(mktemp -d)
    python -m gea_torch.cli.train_glis --device cpu --dataset synthetic \
        --image_size 16 --crop_size 32 --code_size 16 --num_features 4 \
        --max_features 16 --r_iterations 1 --batch_size 4 --dtype float32 \
        --niter 6 --log_interval 2 --vis_interval 3 --save_interval 3 \
        --vis_rows 2 --save_path "$RUN"
    # the same with --niter 9 prints "resumed from ... at step 6"

With `--fid_interval N` the run scores the final LIS stage's proxy-FID
every N steps (`make_fid_fn`), logs it to <run>/fid.jsonl and pins the best
checkpoint in best.json; `--stop_patience` ends it early.

Data parallelism: `--num_devices N` trains on N cards of this host, one
spawned process each, with the batch split and the gradients averaged
(`gea_torch.parallel`; 0, the default, takes every visible card), and
`--multihost` runs one rank of a group that a launcher started, e.g.

    torchrun --nnodes 2 --nproc_per_node 8 --rdzv_endpoint HOST:29500 \
        -m gea_torch.cli.train_glis --multihost ...

On the CPU, `--device cpu --num_devices 2` runs two gloo ranks.

Tensor parallelism: `--model_shards M` (with `--num_devices N`, M dividing
N; one host) runs `gea`'s single program on the global batch over a
(N / M, M) world, each rank keeping the full parameters and gradients and
its shards of the Adam state and EMA of each parameter wider than
`--tp_min_width` (`gea_torch.parallel.tp`); its checkpoints hold the
gathered state, so a single-process run resumes them.

`--dataset lsun --lsun_classes a,b` reads LSUN class folders or exported
LMDBs (`gea_torch.data.lsun`); `--data_backend grain` decodes with `gea`'s
grain chain (`gea_torch.data.grain_loader`, where grain is installed).

The flags are `gea`'s, plus `--device`; `--use_pallas`, which the port
does not implement, raises SystemExit when set
(`gea_torch.config.refuse_unported`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from gea_torch.cli.compute_fid import Noise, real_batch_iter, seeded_noise
from gea_torch.config import TrainGLISConfig, refuse_unported
from gea_torch.eval.fid import OnlineFID
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
from gea_torch.train.state import create_glis_state
from gea_torch.train.steps import build_glis_train_step
from gea_torch.utils.grids import save_stage_grids


def make_vis_fn(cfg: TrainGLISConfig, generator, run_dir: str):
    """Per-stage sample grids of a fixed noise batch. The noise comes from
    a `torch.Generator` seeded with seed + 999, as `gea`'s comes from
    PRNGKey(seed + 999); the values differ from `gea`'s."""
    n_vis = cfg.vis_rows * cfg.vis_rows
    gen = torch.Generator().manual_seed(cfg.seed + 999)
    dev = generator.device
    z = torch.randn((n_vis, cfg.code_size), generator=gen).to(dev)
    sn_shape = generator.spatial_noise_shape(n_vis)
    sn = torch.randn(sn_shape, generator=gen).to(dev) if sn_shape else None

    def vis(state, step: int) -> None:
        with torch.no_grad():
            images, _ = state.generator.render(z, sn)
        save_stage_grids(images.cpu().numpy(), os.path.join(run_dir, "samples"), step,
                         rows=cfg.vis_rows)

    return vis


def make_fid_fn(cfg: TrainGLISConfig, device, noise: Noise = seeded_noise):
    """In-training proxy-FID of the final LIS stage (--fid_interval): the
    real side's moments once, from the iterator the offline `compute_fid`
    reads (seed ^ 0xF1D), and the fake side rendered from the live G at
    the fixed noise seed seed ^ 0xFAD at every call. With --g_ema > 0 it
    scores the EMA shadow, the copy a user samples with --use_ema."""
    online = OnlineFID(real_batch_iter(cfg, cfg.seed ^ 0xF1D, device), cfg.image_size,
                       num_samples=cfg.fid_samples, extractor="auto", device=device)
    print(f"[gea_torch] --fid_interval {cfg.fid_interval}: tracking {online.label} over "
          f"{cfg.fid_samples} samples", flush=True)

    def fid_fn(state) -> float:
        g, weights = state.generator, (state.g_ema if cfg.g_ema > 0 else {})
        draw = noise(g, cfg.seed ^ 0xFAD)

        def fakes():
            while True:
                z, sn = draw(cfg.batch_size)
                with torch.no_grad():
                    images = torch.func.functional_call(
                        g, weights, (z, sn), {"render_all_stages": True})[0][-1]
                yield images

        return online.score(fakes())

    return fid_fn


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def build_state(device, cfg: TrainGLISConfig):
    """`gea`'s build_models: G and D from the seeded init, fresh Adam."""
    return create_glis_state(cfg, device=device)


def train(device, cfg: TrainGLISConfig, dp=None):
    """One rank's run (the only one without `dp`); returns (state, stats):
    the meter's rates and the loop's median host times per step."""
    lead = is_lead(dp)
    run_dir = prepare_run(cfg, dp)
    check_batch(cfg, 1 if dp is None else dp.size)
    state = build_state(device, cfg)
    if lead:
        print(f"[gea_torch] G params: {param_count(state.generator):,}  D params: "
              f"{param_count(state.discriminator):,}  device: {device}  stages/step: "
              f"{cfg.n_stages}")
    state, start_step = maybe_resume(cfg, state, dp)
    data = input_iterator(cfg, device, cfg.seed, start_step=start_step, dp=dp)
    fid_fn = make_fid_fn(cfg, device) if cfg.fid_interval > 0 and lead else None
    vis_fn = make_vis_fn(cfg, state.generator, run_dir) if lead else None
    step = build_glis_train_step(cfg, dp=dp)
    loop = TrainLoop(cfg, run_dir, state, build_step_fn(cfg, step), data,
                     make_input_fn(cfg, device, dp), vis_fn=vis_fn, fid_fn=fid_fn, dp=dp)
    try:
        final_state = loop.run(start_step)
    finally:
        data.close()  # ends the prefetch thread
    stats = {**loop.stats(), "metrics": loop.last_metrics}
    if lead:
        print(f"[gea_torch] done: {stats['images_per_sec']:.1f} img/s "
              f"({stats['images_per_sec_per_chip']:.1f}/chip)")
    return final_state, stats


def run(cfg: TrainGLISConfig):
    """Train on the run's devices (`run_trainer`); returns the lead's
    (state, stats)."""
    refuse_unported(cfg)
    return run_trainer(cfg, train, build_state)


def main(argv: Optional[list] = None):
    return run(TrainGLISConfig.from_args(argv))


if __name__ == "__main__":
    main()
