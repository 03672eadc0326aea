"""The cross-tool checkpoint contract of `gea/cli/sample.py`: rebuild a
G-LIS run's generator (or its EMA shadow) and discriminator from its run
directory. R-separate reads its frozen G (and D) through these, and the
evaluators (`compute_fid`, `eval_stages`) their G and D.

They read a run directory of the port's G-LIS trainer: `config.json` and
`checkpoints/<step>/state.pt`. `gea`'s orbax run directories are not read.
The sampler's own `run` and `main` (per-stage grids, D-filtered sampling,
the GIF) come with the samplers slice.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from gea_torch.config import TrainGLISConfig
from gea_torch.models import Discriminator, GeneratorLIS
from gea_torch.utils.checkpoint import STATE_FILE, load_checkpoint


def read_run(load_path: str, step: Optional[int] = None) -> Tuple[TrainGLISConfig, dict]:
    """(the run's config, the state_dict of `step` on the host: the latest
    for None, the best.json step for -1)."""
    expected = (f"{load_path!r} is not a gea_torch G-LIS run directory: expected "
                f"config.json and checkpoints/<step>/{STATE_FILE} there (gea's orbax run "
                "directories are not read)")
    config = os.path.join(load_path, "config.json")
    if not os.path.isfile(config):
        raise FileNotFoundError(expected)
    try:
        return TrainGLISConfig.load(config), load_checkpoint(load_path, step)
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

