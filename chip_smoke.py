#!/usr/bin/env python3
"""The port on one NVIDIA GPU: every card check, then each kernel's
launches in a flagship train step beside its time.

    python3 chip_smoke.py [pytest arguments]

Runs the card modules in this process, as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_*_card.py

runs (they build the kernels, hold each against its plain version and
hold every path's launches), and fails if they fail; extra arguments go to
pytest (say `-x`). Then runs one bf16 G-LIS train step at the flagship
with the launch counters zeroed just before it, and prints one JSON line,
`{"kernels": [...]}`: for each kernel, its launches in that step, and
`ms`, `plain_ms` and `bound_ms` summed over the step's calls of it
(`scripts/torch_kernel_times.py`'s cases and timer; the bound from
`portbench.cost.kernels.call_bound_ms`). The checks live in the card
modules alone; this script adds none.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD_ARGS = ["--noconftest", "-p", "no:cacheprovider", "-m", "card"]


def step_launches(cfg) -> dict:
    """Each kernel's launches in one bf16 G-LIS train step at `cfg`, read
    from the port's counters, zeroed just before the step."""
    import torch
    from torch_port_card_runs import BATCH, cudnn_tf32, real_batch

    from gea_torch import ops
    from gea_torch.config import TrainGLISConfig
    from gea_torch.interop import init_discriminator_params, init_generator_params
    from gea_torch.train import build_glis_train_step, create_glis_state

    tcfg = TrainGLISConfig(**{**dataclasses.asdict(cfg), "batch_size": BATCH, "gan_loss": "bce"})
    with cudnn_tf32():
        state = create_glis_state(tcfg, init_generator_params(cfg, 0),
                                  init_discriminator_params(cfg, 1))
        step = build_glis_train_step(tcfg)
        real = real_batch(cfg)
        ops.reset_launch_counts()
        step(state, real)
        torch.cuda.synchronize()
        return ops.launch_counts()


def kernel_rows(cfg, counts: dict, card: str) -> list:
    """One row a kernel: its launches in the step (`counts`), and its
    device time, its plain version's and its bound, each summed over the
    step's calls at their shapes."""
    import torch
    import torch_kernel_times as kt
    from torch_port_card_cases import BATCH

    rows = {name: {"name": name, "launches": n, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "shapes": []} for name, n in counts.items()}
    for name, label, per, kernel, plain, op, op_args, _ in kt.calls(cfg, BATCH, 0,
                                                                     torch.bfloat16):
        if not per:
            continue
        row = rows[name]
        for key, value in kt.timed(kernel, plain, op, op_args).items():
            if key != "bound_by":
                row[key] += per * value
        row["shapes"].append(f"{label} x{per}")
    per = "bf16, one flagship G-LIS train step: ms, plain_ms and bound_ms summed over its calls"
    return [{**row, "per": per, "card": card} for row in rows.values() if row["launches"]]


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import pytest

    modules = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_port_*_card.py")))
    rc = int(pytest.main([*CARD_ARGS, *argv, *modules]))
    if rc:
        print(f"chip_smoke: the card modules failed (pytest exit code {rc})", file=sys.stderr)
        return rc
    sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "scripts")]
    from torch_port_card_cases import nvidia_smi

    from gea_torch import FLAGSHIP

    rows = kernel_rows(FLAGSHIP, step_launches(FLAGSHIP), nvidia_smi())
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
