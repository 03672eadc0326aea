"""The reverser loader of `gea/cli/sample_r_separate.py`: rebuild an
R-separate run's reverter from its run directory (`config.json` and
`checkpoints/<step>/state.pt` of the port's R-separate trainer), as
`compute_fid --r_path` reads it. The sampler's own `run` and `main` come
with the samplers."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from gea_torch.config import TrainRSeparateConfig
from gea_torch.models import Reverter
from gea_torch.utils.checkpoint import load_checkpoint


def load_reverter(load_path: str, step: Optional[int] = None,
                  device="cuda") -> Tuple[Reverter, TrainRSeparateConfig]:
    """(the run's R with the weights of `step`, in inference mode, and the
    run's config): the latest step for None, the best.json step for -1."""
    cfg = TrainRSeparateConfig.load(os.path.join(load_path, "config.json"))
    reverter = Reverter(cfg, device=device)
    reverter.load_state_dict(load_checkpoint(load_path, step)["reverter"], strict=True)
    return reverter.eval(), cfg
