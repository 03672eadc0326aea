"""FID evaluation CLI of the port (port of `gea/cli/compute_fid.py`): score
a trained G-LIS run of the port against a real dataset.

On the card:

    python -m gea_torch.cli.compute_fid --load_path runs/glis3_80 \\
        --dataset folder --dataroot /data/celeba --num_samples 10000

On the CPU, against the tiny run of `gea_torch/cli/train_glis.py`'s
docstring:

    python -m gea_torch.cli.compute_fid --device cpu --load_path "$RUN" \\
        --dataset synthetic --num_samples 16 --batch_size 4

The metric is `gea`'s proxy-FID, labelled ``proxy-FID(random-cnn)``
(`gea_torch/eval/fid.py`); true FID (InceptionV3) is not available in the
port and `--extractor inception` or `--inception_weights` raise. The
output JSON has `gea`'s keys. The fakes stay on the device through the
feature network; the reals are decoded on the host and preprocessed on the
device. The noise comes from a `torch.Generator` seeded with `--seed`, so
the same weights score a little differently than under `gea`, whose noise
is `jax.random`'s; each fake iterator takes another noise source as
`noise(generator, seed) -> draw(n) -> (z, spatial noise)`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, Optional

import numpy as np
import torch

from gea_torch.cli.sample import (
    Noise,
    load_discriminator,
    load_generator,
    read_run,
    seeded_noise,
)
from gea_torch.config import resolve_device
from gea_torch.data.ondevice import preprocess_batch
from gea_torch.data.pipeline import device_crop_size, make_dataset
from gea_torch.eval.fid import MetricBundle
from gea_torch.models.reverter import corrected_render


def fake_batch_iter(generator, batch_size: int, seed: int,
                    noise: Noise = seeded_noise) -> Iterator[torch.Tensor]:
    """The final LIS stage of G on fresh noise, batch after batch."""
    draw = noise(generator, seed)
    while True:
        z, sn = draw(batch_size)
        with torch.no_grad():
            images = generator(z, sn, render_all_stages=True)[0][-1]
        yield images


def corrected_batch_iter(generator, r_path: str, batch_size: int, seed: int,
                         correction_steps: int = 1, correction_strength: float = 0.3,
                         shell_renorm: bool = True, r_step: int = 0,
                         noise: Noise = seeded_noise) -> Iterator[torch.Tensor]:
    """Final images after the R-separate correction chain of the run in
    `r_path`: the ablation "does correction improve FID?"."""
    from gea_torch.cli.sample_r_separate import load_reverter

    reverter, _ = load_reverter(r_path, step=r_step or None, device=generator.device)
    draw = noise(generator, seed)
    while True:
        z, sn = draw(batch_size)
        with torch.no_grad():
            images = corrected_render(generator, reverter, z, sn, correction_strength,
                                      shell_renorm, correction_steps)
        yield images


def filtered_batch_iter(generator, load_path: str, batch_size: int, seed: int,
                        oversample: int = 4, d_step: int = 0, restored: Optional[dict] = None,
                        noise: Noise = seeded_noise) -> Iterator[torch.Tensor]:
    """Final images after discriminator-filtered resampling (`--d_filter`):
    render oversample * batch candidates and keep the top batch by D's
    score, the sampler's selection. `restored` reuses a checkpoint already
    read when D comes from the same step as G."""
    discriminator = load_discriminator(load_path, step=d_step or None, device=generator.device,
                                       restored=restored)
    n_cand = batch_size * max(1, oversample)
    draw = noise(generator, seed)
    while True:
        z, sn = draw(n_cand)
        with torch.no_grad():
            final = generator(z, sn, render_all_stages=True)[0][-1]
            images = final[torch.topk(discriminator(final), batch_size).indices]
        yield images


def real_batch_iter(cfg, seed: int, device) -> Iterator[torch.Tensor]:
    """The config's dataset, decoded on the host and preprocessed on the
    device without the flip: `gea`'s real side, within 1e-6."""
    ds = make_dataset(cfg, seed=seed)
    crop = device_crop_size(cfg)
    for raw in ds.batches():
        yield preprocess_batch(torch.from_numpy(raw).to(device), crop, cfg.image_size,
                               augment_flip=False)


def add_extractor_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--extractor", default="auto", choices=("auto", "inception", "random"),
                   help="auto and random: the proxy-FID; inception is not available in "
                   "gea_torch and raises")
    p.add_argument("--inception_weights", default="",
                   help="InceptionV3 weights: not available in gea_torch, raises")
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the plain PyTorch versions of the kernels")


def main(argv: Optional[list] = None, noise: Noise = seeded_noise):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True, help="trained G-LIS run dir")
    p.add_argument("--dataset", default="folder")
    p.add_argument("--dataroot", default="")
    p.add_argument("--num_samples", type=int, default=10_000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    add_extractor_args(p)
    p.add_argument("--out", default="", help="optional JSON output path")
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step (0 = latest, -1 = best per --fid_interval)")
    p.add_argument("--r_path", default="",
                   help="R-separate run dir: score CORRECTED samples G(blend(z, R(G(z)))) "
                   "instead of plain ones")
    p.add_argument("--correction_steps", type=int, default=1)
    p.add_argument("--correction_strength", type=float, default=0.3)
    p.add_argument("--shell_renorm", type=lambda v: v.lower() not in ("0", "false", "no"),
                   default=True)
    p.add_argument("--r_step", type=int, default=0)
    p.add_argument("--d_filter", action="store_true",
                   help="score D-filtered samples (top batch of --oversample x candidates by "
                   "discriminator score)")
    p.add_argument("--oversample", type=int, default=4)
    p.add_argument("--d_filter_step", type=int, default=0,
                   help="with --d_filter: D snapshot step to judge with (0 = --step)")
    p.add_argument("--use_ema", action="store_true",
                   help="score the EMA copy of G (runs trained with --g_ema > 0)")
    p.add_argument("--second_opinion", action="store_true",
                   help="also score with the independent second random-feature net "
                   "(proxy-FID-b), KID and improved precision/recall")
    p.add_argument("--repeats", type=int, default=1,
                   help="score N independent sample draws (fresh noise and a reshuffled real "
                   "subset per repeat) and report mean and half the spread per metric")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    _, restored = read_run(a.load_path, a.step or None)
    generator, train_cfg = load_generator(a.load_path, device=device, restored=restored,
                                          use_ema=a.use_ema)
    data_cfg = train_cfg.replace(dataset=a.dataset, dataroot=a.dataroot or train_cfg.dataroot,
                                 batch_size=a.batch_size)

    def make_fakes(seed: int):
        """A fresh fake iterator, deterministic from the seed."""
        if a.r_path:
            return corrected_batch_iter(
                generator, a.r_path, a.batch_size, seed, correction_steps=a.correction_steps,
                correction_strength=a.correction_strength, shell_renorm=a.shell_renorm,
                r_step=a.r_step, noise=noise)
        if a.d_filter:
            d_step = a.d_filter_step or a.step
            return filtered_batch_iter(generator, a.load_path, a.batch_size, seed,
                                       oversample=a.oversample, d_step=d_step,
                                       restored=restored if d_step == a.step else None,
                                       noise=noise)
        return fake_batch_iter(generator, a.batch_size, seed, noise=noise)

    def score_once(seed: int):
        # One pass over the reals and one over the fakes feed every metric.
        bundle = MetricBundle(train_cfg.image_size, extractor=a.extractor,
                              inception_weights=a.inception_weights,
                              second_opinion=a.second_opinion, device=device)
        bundle.set_reals(real_batch_iter(data_cfg, seed, device), a.num_samples)
        fakes = bundle.group()
        fakes.consume(make_fakes(seed), a.num_samples)
        return bundle, bundle.row(fakes)

    # --repeats N: N independent draws (fresh noise and a reshuffled real
    # subset); the spread is the evaluation's noise at this sample count.
    repeat_seeds = [a.seed + 7919 * r for r in range(max(1, a.repeats))]
    rows = []
    for seed in repeat_seeds:
        bundle, scores = score_once(seed)
        rows.append(scores)

    def agg(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        if not vals:
            return None, None
        return round(float(np.mean(vals)), 4), round(float((max(vals) - min(vals)) / 2.0), 4)

    scores = rows[0] if len(rows) == 1 else {k: agg(k)[0] for k in rows[0]}
    result = {
        "metric": bundle.label,
        "value": scores["frechet"],
        "num_samples": a.num_samples,
        "load_path": os.path.abspath(a.load_path),
    }
    if a.second_opinion:
        result["second_opinion"] = {
            "metric_b": bundle.label_b,
            "value_b": scores["frechet_b"],
            "kid_metric": f"KID over {bundle.label} features, x1000",
            "kid_x1000": scores["kid_x1000"],
            "kid_x1000_std": scores["kid_x1000_std"],
            "precision": scores["precision"],
            "recall": scores["recall"],
        }
    if len(rows) > 1:
        spread_keys = ["frechet"]
        if a.second_opinion:
            spread_keys += ["frechet_b", "kid_x1000", "precision", "recall"]
        result["repeats"] = {
            "n": len(rows),
            "seeds": repeat_seeds,
            "per_draw": rows,
            "half_spread": {k: agg(k)[1] for k in spread_keys},
        }
    if a.r_path:
        result["r_path"] = os.path.abspath(a.r_path)
        result["correction"] = (f"steps={a.correction_steps} strength={a.correction_strength} "
                                f"shell_renorm={a.shell_renorm}")
    if a.d_filter:
        result["d_filter"] = (f"oversample={a.oversample} "
                              f"d_step={a.d_filter_step or a.step or 'latest'}")
    print(json.dumps(result), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
