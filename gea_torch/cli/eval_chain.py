"""Per-link evaluation of an R-iterative run (port of
`gea/cli/eval_chain.py`): for each link of the inference correction chain
z_t = z_{t-1} + R(G(z_{t-1})) it reports the mean sigmoid score of the
run's discriminator and the `MetricBundle` row against the real data, so
"does the chain improve samples?" is a table.

On the card:

    python -m gea_torch.cli.eval_chain --load_path runs/riter \\
        --dataset folder --dataroot /data/celeba --num_samples 2048

On the CPU, against the tiny R-iterative run of
`gea_torch/cli/train_r_iterative.py`'s docstring:

    python -m gea_torch.cli.eval_chain --device cpu --load_path "$RIT" \\
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
from gea_torch.config import TrainRIterativeConfig, resolve_device
from gea_torch.eval.fid import MetricBundle
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.models.reverter import iterative_chain
from gea_torch.train.state import generator_config
from gea_torch.utils.checkpoint import load_checkpoint


def main(argv: Optional[list] = None, noise: Noise = seeded_noise):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True, help="R-iterative run dir")
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
    p.add_argument("--chain_length", type=int, default=None,
                   help="links to evaluate (default: the run's r_chain_length; larger values "
                   "probe extrapolating the chain beyond training)")
    add_extractor_args(p)
    p.add_argument("--second_opinion", action="store_true",
                   help="add per-link proxy-FID-b (second random-feature net) and KID x1000 "
                   "columns")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    cfg = TrainRIterativeConfig.load(os.path.join(a.load_path, "config.json"))
    ckpt = load_checkpoint(a.load_path, a.step if a.step != 0 else None)  # -1 = best.json
    generator = GeneratorLIS(generator_config(cfg), device=device)
    reverter = Reverter(cfg, device=device)
    discriminator = Discriminator(cfg, device=device)
    for name, module in (("generator", generator), ("reverter", reverter),
                         ("discriminator", discriminator)):
        module.load_state_dict(ckpt[name], strict=True)
        module.eval()
    del ckpt
    links = a.chain_length if a.chain_length is not None else cfg.r_chain_length
    n_links = links + 1  # link 0 = the uncorrected G(z0)

    bundle = MetricBundle(cfg.image_size, extractor=a.extractor,
                          inception_weights=a.inception_weights,
                          second_opinion=a.second_opinion, device=device)
    link_groups = [bundle.group() for _ in range(n_links)]
    d_scores = [[] for _ in range(n_links)]

    draw = noise(generator, a.seed)
    done = 0
    while done < a.num_samples:
        n = min(a.batch_size, a.num_samples - done)
        z, sn = draw(n)
        with torch.no_grad():
            imgs = iterative_chain(generator, reverter, z, sn, links)  # (links+1, n, H, W, 3)
            flat = imgs.reshape(-1, *imgs.shape[2:])
            scores = torch.sigmoid(discriminator(flat)).reshape(n_links, -1).cpu().numpy()
        for t in range(n_links):
            d_scores[t].append(scores[t])
            link_groups[t].update(imgs[t])
        done += n

    data_cfg = cfg.replace(dataset=a.dataset or cfg.dataset,
                           dataroot=a.dataroot or cfg.dataroot, batch_size=a.batch_size)
    bundle.set_reals(real_batch_iter(data_cfg, a.seed, device), a.num_samples)

    rows = []
    for t in range(n_links):
        row = {"link": t,
               "d_score_mean": round(float(np.mean(np.concatenate(d_scores[t]))), 4)}
        row.update(bundle.row(link_groups[t]))
        rows.append(row)
    result = {
        "metric": bundle.label,
        "real_dataset": a.dataset or cfg.dataset,
        "real_dataroot": a.dataroot or cfg.dataroot,
        "num_samples": a.num_samples,
        "lambda_r": cfg.lambda_r,
        "chain_length_trained": cfg.r_chain_length,
        "links": rows,
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
