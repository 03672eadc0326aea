"""Per-LIS-stage evaluation CLI of the port (port of
`gea/cli/eval_stages.py`): for each stage image z_0..z_N of a G-LIS run it
reports the mean sigmoid score of the run's discriminator and the
`MetricBundle` row against the real data (proxy-FID, and with
`--second_opinion` proxy-FID-b, KID and precision/recall), so the gain of
each LIS refinement is a number.

On the card:

    python -m gea_torch.cli.eval_stages --load_path runs/glis3_80 \\
        --dataset folder --dataroot /data/celeba --num_samples 2048

On the CPU, against the tiny run of `gea_torch/cli/train_glis.py`'s
docstring:

    python -m gea_torch.cli.eval_stages --device cpu --load_path "$RUN" \\
        --num_samples 16 --batch_size 4

The output JSON has `gea`'s keys. The noise comes from a `torch.Generator`
seeded with `--seed` (`compute_fid.seeded_noise`).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from gea_torch.cli.compute_fid import Noise, add_extractor_args, real_batch_iter, seeded_noise
from gea_torch.cli.sample import load_discriminator, load_generator, read_run
from gea_torch.config import resolve_device
from gea_torch.eval.fid import MetricBundle


def main(argv: Optional[list] = None, noise: Noise = seeded_noise):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True, help="trained G-LIS run dir")
    p.add_argument("--dataset", default="",
                   help="real-data source for the Frechet reference (default: the run's own "
                   "training dataset from its config.json)")
    p.add_argument("--dataroot", default="")
    p.add_argument("--num_samples", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="", help="optional JSON output path")
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step (0 = latest, -1 = best per --fid_interval)")
    add_extractor_args(p)
    p.add_argument("--second_opinion", action="store_true",
                   help="add per-stage proxy-FID-b (second random-feature net) and KID x1000 "
                   "columns")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    step = a.step if a.step != 0 else None  # -1 = best.json
    _, restored = read_run(a.load_path, step)
    generator, cfg = load_generator(a.load_path, device=device, restored=restored)
    discriminator = load_discriminator(a.load_path, device=device, restored=restored)
    n_stages = cfg.r_iterations + 1

    # One feature extraction per batch feeds every metric; the reals are
    # decoded once.
    bundle = MetricBundle(cfg.image_size, extractor=a.extractor,
                          inception_weights=a.inception_weights,
                          second_opinion=a.second_opinion, device=device)
    stage_groups = [bundle.group() for _ in range(n_stages)]
    d_scores = [[] for _ in range(n_stages)]

    draw = noise(generator, a.seed)
    done = 0
    while done < a.num_samples:
        n = min(a.batch_size, a.num_samples - done)
        z, sn = draw(n)
        with torch.no_grad():
            images = generator(z, sn, render_all_stages=True)[0]
            flat = images.reshape(-1, *images.shape[2:])
            scores = torch.sigmoid(discriminator(flat)).reshape(n_stages, -1).cpu().numpy()
        for s in range(n_stages):
            d_scores[s].append(scores[s])
            stage_groups[s].update(images[s])
        done += n

    data_cfg = cfg.replace(dataset=a.dataset or cfg.dataset,
                           dataroot=a.dataroot or cfg.dataroot, batch_size=a.batch_size)
    bundle.set_reals(real_batch_iter(data_cfg, a.seed, device), a.num_samples)

    stages = []
    for s in range(n_stages):
        row = {"stage": s,
               "d_score_mean": round(float(np.mean(np.concatenate(d_scores[s]))), 4)}
        row.update(bundle.row(stage_groups[s]))
        stages.append(row)
    result = {
        "metric": bundle.label,
        # Provenance of the reference distribution.
        "real_dataset": a.dataset or cfg.dataset,
        "real_dataroot": a.dataroot or cfg.dataroot,
        "num_samples": a.num_samples,
        "stages": stages,
        "load_path": os.path.abspath(a.load_path),
    }
    if a.second_opinion:
        result["metric_b"] = bundle.label_b
        result["kid_metric"] = f"KID over {bundle.label} features, x1000"
    print(json.dumps(result), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
