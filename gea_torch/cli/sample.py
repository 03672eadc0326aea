"""Per-stage grid sampler of the port (port of `gea/cli/sample.py`): load a
trained G-LIS run and render one grid per LIS stage, so the error-avoidance
progression is visible.

On the card:

    python -m gea_torch.cli.sample --load_path runs/glis3_80 \\
        --save_path_samples out/samples --count 64 --d_filter --save_gif

On the CPU, against the tiny run of `gea_torch/cli/train_glis.py`'s
docstring:

    python -m gea_torch.cli.sample --device cpu --load_path "$RUN" \\
        --count 8 --batch_size 4 --grid_rows 2

`--d_filter` renders `--oversample` x candidates, scores the final stage
with the run's D and keeps the best batch; with `--d_threshold` it keeps
the candidates whose sigmoid score clears the threshold instead, rendering
up to 20 rounds and filling any remainder from the best rejects.

This module is also the cross-tool checkpoint contract: `read_run`,
`load_generator` and `load_discriminator` rebuild a run's G (or its EMA
shadow) and D for R-separate, the evaluators and the other samplers. They
read a run directory of the port: `config.json` and
`checkpoints/<step>/state.pt`, as the port's trainers and
`gea_torch.cli.convert_checkpoint --from_torch` write them. A `gea` (orbax)
run directory is converted first (`read_run`'s error says how).

The noise comes from a `torch.Generator` seeded with `--seed` (`gea`'s from
`jax.random`); `run` takes another source as `noise(generator, seed) ->
draw(n) -> (z, spatial noise)`.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple, Type

import torch

from gea_torch.config import (
    BaseConfig,
    SampleConfig,
    TrainGLISConfig,
    refuse_unported,
    resolve_device,
)
from gea_torch.models import Discriminator, GeneratorLIS
from gea_torch.utils.checkpoint import STATE_FILE, load_checkpoint
from gea_torch.utils.grids import save_stage_gif, save_stage_grids

Draw = Callable[[int], Tuple[torch.Tensor, Optional[torch.Tensor]]]
Noise = Callable[..., Draw]

# The rounds of `--d_threshold` rejection sampling before the fill.
THRESHOLD_ROUNDS = 20


def seeded_noise(generator, seed: int) -> Draw:
    """n -> (z (n, code), spatial noise or None), standard normal on the
    generator's device, drawn from one `torch.Generator` seeded with
    `seed`."""
    dev = generator.device
    gen = torch.Generator(dev).manual_seed(seed)

    def draw(n: int):
        z = torch.randn((n, generator.cfg.code_size), generator=gen, device=dev)
        shape = generator.spatial_noise_shape(n)
        return z, (torch.randn(shape, generator=gen, device=dev) if shape else None)

    return draw


def read_run(load_path: str, step: Optional[int] = None,
             config_cls: Type[BaseConfig] = TrainGLISConfig) -> Tuple[BaseConfig, dict]:
    """(the run's config as `config_cls`, the state_dict of `step` on the
    host: the latest for None, the best.json step for -1)."""
    expected = (f"{load_path!r} is not a gea_torch run directory: expected config.json and "
                f"checkpoints/<step>/{STATE_FILE} there. A gea (orbax) run directory converts "
                "with `python -m gea.cli.convert_checkpoint --load_path <gea run> --out F.pt`, "
                "then `python -m gea_torch.cli.convert_checkpoint --from_torch F.pt --out_run "
                "<dir>`")
    config = os.path.join(load_path, "config.json")
    if not os.path.isfile(config):
        raise FileNotFoundError(expected)
    try:
        return config_cls.load(config), load_checkpoint(load_path, step)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"{expected}: {e}") from e


def load_generator(load_path: str, step: Optional[int] = None, device="cuda",
                   restored: Optional[dict] = None,
                   use_ema: bool = False) -> Tuple[GeneratorLIS, TrainGLISConfig]:
    """(the run's G with the weights of `step`, in inference mode, and the
    run's config). `restored` is a state_dict already read from the run.
    `use_ema` takes the EMA shadow of G's parameters (runs trained with
    --g_ema > 0)."""
    cfg, ckpt = read_run(load_path, step) if restored is None else (
        TrainGLISConfig.load(os.path.join(load_path, "config.json")), restored)
    weights = ckpt["generator"]
    if use_ema:
        if not ckpt.get("g_ema"):
            raise SystemExit(f"--use_ema: checkpoint under {load_path!r} has no EMA params "
                             "(train with --g_ema > 0)")
        weights = {**weights, **ckpt["g_ema"]}
    g = GeneratorLIS(cfg, device=device)
    g.load_state_dict(weights, strict=True)
    return g.eval(), cfg


def load_discriminator(load_path: str, step: Optional[int] = None, device="cuda",
                       restored: Optional[dict] = None) -> Discriminator:
    """The run's D with the weights of `step`, in inference mode. KeyError
    when the checkpoint holds none."""
    cfg, ckpt = read_run(load_path, step) if restored is None else (
        TrainGLISConfig.load(os.path.join(load_path, "config.json")), restored)
    d = Discriminator(cfg, device=device)
    d.load_state_dict(ckpt["discriminator"], strict=True)
    return d.eval()


def threshold_sampler(generator, discriminator, threshold: float, fresh: Draw):
    """(z, sn) of n_keep * oversample candidates -> the stage images of
    n_keep kept ones: those whose sigmoid D score on the final stage is >=
    `threshold`, over at most THRESHOLD_ROUNDS rounds, each after the first
    on fresh noise from `fresh`; a shortfall is filled from the best
    rejects (a running top-n_keep pool), with a notice."""

    def render(z, sn, n_keep):
        kept, pool, pool_scores = [], None, None
        for _ in range(THRESHOLD_ROUNDS):
            images = generator.render(z, sn)[0]
            scores = torch.sigmoid(discriminator(images[-1]))
            ok = scores >= threshold
            kept.append(images[:, ok])
            rej, rej_scores = images[:, ~ok], scores[~ok]
            if pool is not None:
                rej, rej_scores = torch.cat([pool, rej], 1), torch.cat([pool_scores, rej_scores])
            top = torch.argsort(rej_scores, descending=True, stable=True)[:n_keep]
            pool, pool_scores = rej[:, top], rej_scores[top]
            if sum(k.shape[1] for k in kept) >= n_keep:
                break
            z, fresh_sn = fresh(z.shape[0])
            z = z.to(images.device)
            sn = None if sn is None else fresh_sn.to(images.device)
        out = torch.cat(kept, 1)
        if out.shape[1] < n_keep:
            need = n_keep - out.shape[1]
            print(f"[gea_torch] d_threshold={threshold}: only {out.shape[1]}/{n_keep} "
                  f"candidates cleared it; filling {need} from the best rejects")
            out = torch.cat([out, pool[:, :need]], 1)
        return out[:, :n_keep]

    return render


def run(cfg: SampleConfig, noise: Noise = seeded_noise) -> dict:
    """Render cfg.count samples in batches, one grid per stage and batch
    (and a GIF with --save_gif); returns the output directory and the
    numbers of batches and images."""
    device = resolve_device(cfg.device)
    step = cfg.step if cfg.step != 0 else None  # -1 = best.json
    _, restored = read_run(cfg.load_path, step)
    generator, train_cfg = load_generator(cfg.load_path, device=device, restored=restored,
                                          use_ema=cfg.use_ema)
    out_dir = cfg.save_path_samples or os.path.join(cfg.load_path, "samples_cli")
    os.makedirs(out_dir, exist_ok=True)

    oversample = max(1, cfg.oversample) if cfg.d_filter else 1
    if cfg.d_filter:
        # -1 selects the best.json snapshot, as --step does.
        d_step = cfg.d_filter_step if cfg.d_filter_step != 0 else step
        if cfg.d_threshold > 0 and train_cfg.gan_loss != "bce":
            print(f"[gea_torch] warning: this run was trained with --gan_loss "
                  f"{train_cfg.gan_loss}; --d_threshold compares sigmoid(margin) against an "
                  "absolute cutoff, which is uncalibrated for non-BCE objectives; treat the "
                  "threshold as a unitless knob, not a probability")
        discriminator = load_discriminator(cfg.load_path, step=d_step, device=device,
                                           restored=restored if d_step == step else None)
        if cfg.d_threshold > 0:
            render = threshold_sampler(generator, discriminator, cfg.d_threshold,
                                       noise(generator, cfg.seed + 1))
        else:
            def render(z, sn, n_keep):
                # Keep the n_keep candidates D scores highest, best first.
                images = generator.render(z, sn)[0]
                return images[:, torch.topk(discriminator(images[-1]), n_keep).indices]
    else:
        def render(z, sn, n_keep):
            return generator.render(z, sn)[0]

    draw = noise(generator, cfg.seed)
    done = batch_idx = 0
    while done < cfg.count:
        n = min(cfg.batch_size, cfg.count - done)
        z, sn = draw(n * oversample)
        with torch.no_grad():
            images = render(z.to(device), None if sn is None else sn.to(device), n)
        images = images.cpu().numpy()
        save_stage_grids(images, out_dir, batch_idx, rows=cfg.grid_rows)
        if cfg.save_gif:
            save_stage_gif(images, os.path.join(out_dir, f"progression_{batch_idx:08d}.gif"),
                           rows=cfg.grid_rows)
        done += n
        batch_idx += 1
    print(f"[gea_torch] wrote {batch_idx} per-stage grid sets to {out_dir}")
    return {"out_dir": out_dir, "batches": batch_idx, "images": done}


def main(argv: Optional[list] = None, noise: Noise = seeded_noise) -> dict:
    cfg = SampleConfig.from_args(argv)
    refuse_unported(cfg)
    if not cfg.load_path:
        raise SystemExit("--load_path is required")
    return run(cfg, noise)


if __name__ == "__main__":
    main()
