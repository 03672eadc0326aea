"""Run-directory inspector of the port (port of `gea/cli/info.py`): print a
JSON summary of a run directory (config, checkpoint steps, parameter
counts of G, D and R, the step, the number of sample grids and the best
snapshot) without loading any model onto a device.

    python -m gea_torch.cli.info --load_path runs/glis3_80
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Optional

from gea_torch.utils.checkpoint import best_record, load_checkpoint

# gea's parameter trees and the port's state_dict entries that hold them.
_PARAMS = {"params_g": "generator", "params_d": "discriminator", "params_r": "reverter"}


def param_count(state: Optional[dict]) -> int:
    """The number of values in a module's state_dict (0 for none): the
    count `gea` gives its parameter tree, whose leaves are these tensors
    in another layout."""
    return sum(t.numel() for t in (state or {}).values())


def summarize(load_path: str) -> dict:
    out: dict = {"path": os.path.abspath(load_path)}
    cfg_path = os.path.join(load_path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            out["config"] = json.load(f)
    root = os.path.join(load_path, "checkpoints")
    steps = []
    if os.path.isdir(root):
        steps = sorted(int(d) for d in os.listdir(root) if re.fullmatch(r"\d+", d))
    out["checkpoint_steps"] = steps
    if steps:
        ckpt = load_checkpoint(load_path)
        out["params"] = {k: param_count(ckpt.get(name)) for k, name in _PARAMS.items()}
        out["step"] = int(ckpt["step"])
    samples = os.path.join(load_path, "samples")
    if os.path.isdir(samples):
        out["num_sample_grids"] = len(os.listdir(samples))
    best = best_record(load_path)
    if best is not None:  # --fid_interval tracking (load with --step -1)
        out["best"] = best
    return out


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True)
    a = p.parse_args(argv)
    result = summarize(a.load_path)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
