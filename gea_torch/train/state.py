"""Train states of the three trainers (port of `gea/train/state.py` and of
`gea/cli/train_r_separate.py::create_r_state`).

`gea` keeps one immutable pytree (params, optax states, step, PRNG key)
that a pure step maps to the next. The port keeps the same pieces as
mutable objects that the step updates in place: the models as modules,
one Adam (and scheduler) per trained player, the step count and a
`torch.Generator` on the device for the trainer's own draws; G-LIS adds
the EMA shadow of G's parameters, R-separate the frozen G (and D) it
trains against. `PLAYERS` names each state's trained modules, with the tag
of their optimizer and scheduler fields; the checkpoint holds those.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from gea_torch.config import (
    TrainGLISConfig,
    TrainRConfig,
    TrainRIterativeConfig,
    dispatch_chunk,
    resolve_device,
)
from gea_torch.interop import (
    discriminator_state_from_jax_params,
    generator_state_from_jax_params,
    init_discriminator_params,
    init_generator_params,
    init_reverter_params,
    reverter_state_from_jax_params,
)
from gea_torch.models import Discriminator, GeneratorLIS, Reverter


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


def scheduled_lrs(sched, k: int) -> List[List[float]]:
    """The lr of each of the next k updates, per param group, as the
    scheduler would set it before each (LambdaLR: base * factor(epoch))."""
    return [[base * fn(sched.last_epoch + i) for i in range(k)]
            for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float,
    beta1: float,
    beta2: float,
    schedule: str = "constant",
    total_steps: int = 0,
    lr_final: float = 0.0,
    chunked: bool = False,
) -> Tuple[torch.optim.Adam, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """Adam (eps 1e-8, as optax's) and, for a cosine or linear schedule, a
    LambdaLR that the step advances after every update.

    `chunked` (K > 1 steps a dispatch, `StepDispatcher`): under a schedule
    the lr lives in a 0-d tensor, which the dispatcher fills before each
    inner step from its (K,) buffer, on either device. On the card Adam is
    also capturable, as a CUDA graph of train steps needs: its step counts
    stay on the device and it reads the fp32 lr tensor at replay (a float lr
    would be baked into the captured kernels). On the CPU Adam is the plain
    one, which reads the tensor back as a number: float64 keeps the
    scheduler's value exact. The scheduler's base lr stays a float, so
    advancing it fills the tensor in place."""
    params = list(params)
    cuda = params[0].is_cuda
    opt = torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                           capturable=chunked and cuda)
    factor = lr_factor(schedule, total_steps, lr_final)
    sched = None if factor is None else torch.optim.lr_scheduler.LambdaLR(opt, factor)
    if chunked and sched is not None:
        for group in opt.param_groups:
            group["lr"] = torch.tensor(float(group["lr"]), device=params[0].device,
                                       dtype=torch.float32 if cuda else torch.float64)
    return opt, sched


def chunked(cfg) -> bool:
    """True where the trainer runs K > 1 steps a dispatch
    (`--steps_per_dispatch`), whose Adam `make_optimizer` makes for it."""
    return dispatch_chunk(cfg) > 1


@dataclass
class GLISTrainState:
    PLAYERS = (("generator", "g"), ("discriminator", "d"))

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
    g_stats=None,
    d_stats=None,
) -> GLISTrainState:
    """G and D from `gea`-layout param trees (the port's own seeded
    `init_*_params` where none is given) and, under `norm=batch`, their
    `batch_stats` trees (initial running statistics where none is given),
    fresh Adam for both, and the trainer's generator seeded with `seed`
    (cfg.seed by default). CUDA unless the caller asks for the CPU."""
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    if g_params is None:
        g_params = init_generator_params(cfg, seed)
    if d_params is None:
        d_params = init_discriminator_params(cfg, seed + 1)
    g = GeneratorLIS(cfg, device=dev, use_kernels=use_kernels)
    g.load_state_dict(generator_state_from_jax_params(g_params, cfg, g_stats), strict=True)
    d = Discriminator(cfg, device=dev, use_kernels=use_kernels)
    d.load_state_dict(discriminator_state_from_jax_params(d_params, cfg, d_stats), strict=True)
    sched = (cfg.lr_schedule, cfg.niter, cfg.lr_final, chunked(cfg))
    opt_g, sched_g = make_optimizer(g.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
    opt_d, sched_d = make_optimizer(d.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
    ema = {}
    if getattr(cfg, "g_ema", 0.0) > 0:
        ema = {n: p.detach().clone() for n, p in g.named_parameters()}
    return GLISTrainState(
        generator=g, discriminator=d, opt_g=opt_g, opt_d=opt_d, sched_g=sched_g,
        sched_d=sched_d, rng=torch.Generator(dev).manual_seed(seed), g_ema=ema,
    )


def _reverter(cfg: TrainRConfig, r_params, seed: int, dev: torch.device,
              use_kernels: bool, r_stats=None) -> Tuple[
                  Reverter, torch.optim.Adam, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """R from a `gea`-layout tree (seeded `init_reverter_params` where none
    is given; `r_stats` its batch_stats) and a fresh Adam with the config's
    schedule."""
    if r_params is None:
        r_params = init_reverter_params(cfg, seed)
    r = Reverter(cfg, device=dev, use_kernels=use_kernels)
    r.load_state_dict(reverter_state_from_jax_params(r_params, cfg, r_stats), strict=True)
    opt, sched = make_optimizer(r.parameters(), cfg.lr, cfg.beta1, cfg.beta2,
                                cfg.lr_schedule, cfg.niter, cfg.lr_final, chunked(cfg))
    return r, opt, sched


@dataclass
class RSeparateTrainState:
    """R and its Adam; the frozen G (and D, for the D-feedback and mining
    terms; None without one) that the step renders and scores with. Only R
    is trained and checkpointed."""

    PLAYERS = (("reverter", "r"),)

    reverter: Reverter
    opt_r: torch.optim.Adam
    sched_r: Optional[torch.optim.lr_scheduler.LambdaLR]
    rng: torch.Generator
    generator: GeneratorLIS
    discriminator: Optional[Discriminator] = None
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.reverter.device


def freeze(module: Optional[torch.nn.Module]) -> None:
    """Inference mode (batch norm on its running statistics, as `gea`
    applies the frozen models with train=False) and no parameter
    gradients, in place."""
    if module is not None:
        module.eval().requires_grad_(False)


def create_r_state(
    cfg: TrainRConfig,
    generator: GeneratorLIS,
    discriminator: Optional[Discriminator] = None,
    r_params=None,
    seed: Optional[int] = None,
    device: str | torch.device = "cuda",
    use_kernels: bool = True,
    r_stats=None,
) -> RSeparateTrainState:
    """R-separate's state (`gea`'s `create_r_state`): R seeded with `seed`
    (cfg.seed by default), fresh Adam, the trainer's generator seeded with
    `seed`, and the given G and D, which are frozen here. CUDA unless the
    caller asks for the CPU."""
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    r, opt_r, sched_r = _reverter(cfg, r_params, seed, dev, use_kernels, r_stats)
    freeze(generator)
    freeze(discriminator)
    return RSeparateTrainState(
        reverter=r, opt_r=opt_r, sched_r=sched_r, rng=torch.Generator(dev).manual_seed(seed),
        generator=generator, discriminator=discriminator,
    )


@dataclass
class RIterativeTrainState:
    """G (single-stage, r_iterations=0), D and R, trained jointly, each with
    its own Adam."""

    PLAYERS = (("generator", "g"), ("discriminator", "d"), ("reverter", "r"))

    generator: GeneratorLIS
    discriminator: Discriminator
    reverter: Reverter
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    opt_r: torch.optim.Adam
    sched_g: Optional[torch.optim.lr_scheduler.LambdaLR]
    sched_d: Optional[torch.optim.lr_scheduler.LambdaLR]
    sched_r: Optional[torch.optim.lr_scheduler.LambdaLR]
    rng: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.generator.device


def generator_config(cfg: TrainRIterativeConfig) -> TrainRIterativeConfig:
    """R-iterative's G is the plain conv core: no LIS modules, one stage."""
    return cfg.replace(r_iterations=0)


def add_reverter(state: GLISTrainState, cfg: TrainRConfig, r_params=None,
                 seed: Optional[int] = None, use_kernels: bool = True,
                 r_stats=None) -> RIterativeTrainState:
    """`gea`'s `add_reverter`: a G/D state plus R, seeded with seed + 101,
    and its Adam."""
    seed = cfg.seed if seed is None else seed
    r, opt_r, sched_r = _reverter(cfg, r_params, seed + 101, state.device, use_kernels,
                                  r_stats)
    return RIterativeTrainState(
        generator=state.generator, discriminator=state.discriminator, reverter=r,
        opt_g=state.opt_g, opt_d=state.opt_d, opt_r=opt_r, sched_g=state.sched_g,
        sched_d=state.sched_d, sched_r=sched_r, rng=state.rng, step=state.step,
    )


def create_r_iterative_state(
    cfg: TrainRIterativeConfig,
    g_params=None,
    d_params=None,
    r_params=None,
    seed: Optional[int] = None,
    device: str | torch.device = "cuda",
    use_kernels: bool = True,
    g_stats=None,
    d_stats=None,
    r_stats=None,
) -> RIterativeTrainState:
    """R-iterative's state: G (r_iterations=0) and D as `create_glis_state`
    makes them, then `add_reverter` (`*_stats`: batch_stats trees under
    `norm=batch`). CUDA unless the caller asks for the CPU."""
    glis = create_glis_state(generator_config(cfg), g_params, d_params, seed, device,
                             use_kernels, g_stats, d_stats)
    return add_reverter(glis, cfg, r_params, seed, use_kernels, r_stats)
