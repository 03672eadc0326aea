"""Train state of the G-LIS trainer (port of `gea/train/state.py`).

`gea` keeps one immutable pytree (params, optax states, step, PRNG key)
that a pure step maps to the next. The port keeps the same pieces as
mutable objects that the step updates in place: G and D as modules, one
Adam per player, the step count, the EMA shadow of G's parameters and a
`torch.Generator` on the device for the trainer's own draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import torch

from gea_torch.config import TrainGLISConfig, resolve_device
from gea_torch.interop import (
    discriminator_state_from_jax_params,
    generator_state_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.models import Discriminator, GeneratorLIS


def lr_factor(schedule: str, total_steps: int, lr_final: float):
    """n -> the factor on lr of update n (0-based), with optax's semantics:
    `cosine_decay_schedule(lr, total_steps, alpha=lr_final)` and
    `linear_schedule(lr, lr_final * lr, total_steps)`; constant otherwise."""
    if schedule == "constant" or total_steps <= 0:
        return None
    if schedule == "cosine":
        def factor(n: int) -> float:
            t = min(n, total_steps) / total_steps
            return (1.0 - lr_final) * 0.5 * (1.0 + math.cos(math.pi * t)) + lr_final
    elif schedule == "linear":
        def factor(n: int) -> float:
            return 1.0 - (1.0 - lr_final) * min(n, total_steps) / total_steps
    else:
        raise ValueError(f"unknown lr schedule {schedule!r}")
    return factor


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    beta1: float,
    beta2: float,
    schedule: str = "constant",
    total_steps: int = 0,
    lr_final: float = 0.0,
) -> Tuple[torch.optim.Adam, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """Adam (eps 1e-8, as optax's) and, for a cosine or linear schedule, a
    LambdaLR that the step advances after every update."""
    opt = torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8)
    factor = lr_factor(schedule, total_steps, lr_final)
    sched = None if factor is None else torch.optim.lr_scheduler.LambdaLR(opt, factor)
    return opt, sched


@dataclass
class GLISTrainState:
    generator: GeneratorLIS
    discriminator: Discriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    sched_g: Optional[torch.optim.lr_scheduler.LambdaLR]
    sched_d: Optional[torch.optim.lr_scheduler.LambdaLR]
    rng: torch.Generator
    step: int = 0
    # EMA shadow of G's parameters by name ({} when g_ema == 0).
    g_ema: Dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.generator.device


def create_glis_state(
    cfg: TrainGLISConfig,
    g_params=None,
    d_params=None,
    seed: Optional[int] = None,
    device: str | torch.device = "cuda",
    use_kernels: bool = True,
) -> GLISTrainState:
    """G and D from `gea`-layout param trees (the port's own seeded
    `init_*_params` where none is given), fresh Adam for both, and the
    trainer's generator seeded with `seed` (cfg.seed by default). CUDA
    unless the caller asks for the CPU."""
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    if g_params is None:
        g_params = init_generator_params(cfg, seed)
    if d_params is None:
        d_params = init_discriminator_params(cfg, seed + 1)
    g = GeneratorLIS(cfg, device=dev, use_kernels=use_kernels)
    g.load_state_dict(generator_state_from_jax_params(g_params, cfg), strict=True)
    d = Discriminator(cfg, device=dev, use_kernels=use_kernels)
    d.load_state_dict(discriminator_state_from_jax_params(d_params, cfg), strict=True)
    sched = (cfg.lr_schedule, cfg.niter, cfg.lr_final)
    opt_g, sched_g = make_optimizer(g.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
    opt_d, sched_d = make_optimizer(d.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
    ema = {}
    if cfg.g_ema > 0:
        ema = {n: p.detach().clone() for n, p in g.named_parameters()}
    return GLISTrainState(
        generator=g, discriminator=d, opt_g=opt_g, opt_d=opt_d, sched_g=sched_g,
        sched_d=sched_d, rng=torch.Generator(dev).manual_seed(seed), g_ema=ema,
    )
