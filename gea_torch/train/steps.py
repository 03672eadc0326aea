"""The G-LIS alternating train step (port of `gea/train/steps.py::
build_glis_train_step`).

One step is (1) a D update on the real batch plus every LIS stage's fakes
(detached), then (2) a G update against the freshly updated D, with the
per-stage adversarial weights of `stage_weights` (final stage highest),
then the EMA of G's parameters when `g_ema > 0`.

* One G forward serves both players: its output, detached, feeds the D
  step, and the G step pulls the image gradient of the G loss back through
  the same graph. `share_g_forward=False` runs G's forward again in the G
  step instead; `remat` recomputes G's forward in its backward
  (`torch.utils.checkpoint`).
* D runs one forward over real and all fakes together.
* `norm=batch` follows `gea`'s batch-norm path. G's forward is not shared
  (None, the default, means shared unless batch norm): the first forward's
  new running statistics are dropped (`frozen_stats`) and the G step's
  forward keeps them, so G's move once a step. D runs separate forwards on
  the real batch and on the flat fakes, each updating D's statistics, real
  first; WGAN-GP's penalty and the G step's D pass normalise with batch
  statistics and update nothing. A recompute under `remat` updates
  nothing either.
* The G loss is differentiated with respect to the images only
  (`autograd.grad`), so nothing accumulates into D's parameters, and the
  image gradient, cast to the images' dtype, is pulled back through G.
* `grad_accum` K splits the batch (and z, spatial noise and the
  gradient-penalty eps, drawn for the full batch) into K microbatches: D's
  gradients are summed over them and divided by K; G's are too, with a
  fresh G forward per microbatch.

z, spatial noise and the penalty's eps are inputs of the step; where the
caller gives none, the step draws them from the state's `torch.Generator`
on the device. The step updates the state in place and returns its
metrics as 0-d tensors on the device, so it never waits for the device.

Data parallelism (`dp`, a `gea_torch.parallel.DataParallel`): the step
runs on this rank's slab of the global batch, and D's gradients, G's and
the metrics are averaged over the ranks where `gea` `pmean`s them, after
each player's backward (and its microbatches' mean) and before its update;
each rank normalises with its own batch statistics, and the running
statistics are averaged over the ranks after the step.
Its own draws are this rank's rows of the global batch's
(`DataParallel.rows`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from gea_torch.config import TrainGLISConfig, stage_weights
from gea_torch.ops.layers import frozen_stats
from gea_torch.train import losses
from gea_torch.train.state import GLISTrainState

Metrics = Dict[str, torch.Tensor]


def check_accum(cfg: TrainGLISConfig) -> int:
    """K microbatches per update; `norm=batch` is refused with `gea`'s
    error: per-microbatch batch statistics would change its semantics."""
    accum = max(1, int(cfg.grad_accum))
    if accum > 1 and cfg.norm == "batch":
        raise ValueError(
            "--grad_accum > 1 requires --norm weight|none: batch "
            "statistics would be computed per-microbatch, changing the "
            "reference's full-batch BatchNorm semantics"
        )
    return accum


def stats_once(fn: Callable, *modules) -> Callable:
    """fn, whose calls after the first update no running statistic of
    `modules`: a forward recomputed in the backward (`remat`) normalises
    as the first did and must not move the statistics again."""
    calls = []

    def once(*args):
        with frozen_stats(*modules) if calls else contextlib.nullcontext():
            calls.append(None)
            return fn(*args)

    return once


def mean_stats(dp, *modules) -> None:
    """With `dp`, each module's running statistics averaged over the ranks
    (`gea` pmeans its batch_stats after the step)."""
    if dp is not None:
        for m in modules:
            dp.mean_stats(m)


def _update(opt: torch.optim.Optimizer, sched) -> None:
    opt.step()
    if sched is not None:
        sched.step()


def draw(state, draw_fn, shape, dp=None) -> torch.Tensor:
    """`draw_fn` (torch.randn or torch.rand) of `shape` from the state's
    generator on its device; with `dp`, shape[0] is this rank's batch, and
    the global batch is drawn and this rank's rows kept."""
    world = 1 if dp is None else dp.size
    t = draw_fn((shape[0] * world, *shape[1:]), generator=state.rng, device=state.device)
    return t if dp is None else dp.rows(t)


def draw_noise(state, generator, batch: int, code_size: int, z, sn, dp=None):
    """z (batch, code) and the generator's spatial noise (None without
    spatial code), fp32 on the state's device; where not given, drawn from
    the state's generator, z first (`draw`)."""
    dev = state.device
    if z is None:
        z = draw(state, torch.randn, (batch, code_size), dp)
    sn_shape = generator.spatial_noise_shape(batch)
    if sn_shape is None:
        sn = None
    elif sn is None:
        sn = draw(state, torch.randn, sn_shape, dp)
    return to_device(z, dev), to_device(sn, dev)


def device_weights(weights) -> Callable[[torch.device], torch.Tensor]:
    """dev -> `weights` as an fp32 tensor on dev, made once per device: a
    copy from the host cannot run inside a CUDA graph's capture, so the
    first (eager) step makes it."""
    made: Dict[torch.device, torch.Tensor] = {}

    def on(dev: torch.device) -> torch.Tensor:
        if dev not in made:
            made[dev] = torch.tensor(weights, dtype=torch.float32, device=dev)
        return made[dev]

    return on


def to_device(t, dev: torch.device) -> Optional[torch.Tensor]:
    return None if t is None else torch.as_tensor(t, dtype=torch.float32, device=dev)


def microbatches(t: Optional[torch.Tensor], batch: int, accum: int) -> list:
    """t split into `accum` microbatches along its first axis (Nones for
    None); the batch must divide by accum."""
    if batch % accum:
        raise ValueError(f"batch {batch} not divisible by grad_accum {accum}")
    return [None] * accum if t is None else list(t.split(batch // accum))


def local_batch(cfg, dp=None) -> int:
    """This rank's share of the global batch."""
    return cfg.batch_size // (1 if dp is None else dp.size)


def zero_grads(opt: torch.optim.Optimizer, module: torch.nn.Module, dp=None) -> None:
    """Before a player's backward: no gradients, or with `dp` its zeroed
    flat buffer."""
    if dp is None:
        opt.zero_grad(set_to_none=True)
    else:
        dp.zero_grads(module)


def mean_grads(module: torch.nn.Module, accum: int, dp=None) -> None:
    """Gradients summed over `accum` microbatches -> their mean, with `dp`
    then averaged over the ranks."""
    if dp is not None:
        dp.mean_grads(module, accum)
    elif accum > 1:
        for p in module.parameters():
            if p.grad is not None:
                p.grad.div_(accum)


def mean_metrics(metrics: Metrics, dp=None) -> Metrics:
    return metrics if dp is None else dp.mean_metrics(metrics)


def build_glis_train_step(
    cfg: TrainGLISConfig, share_g_forward: Optional[bool] = None, dp=None
) -> Callable[..., Metrics]:
    """Returns step(state, real, z=None, spatial_noise=None, gp_eps=None)
    -> metrics. `real` (B, H, W, 3) in [-1, 1]; z (B, code); spatial_noise
    (B, 2*s0, 2*s0, spatial_code); gp_eps (B, 1, 1, 1); B is this rank's
    batch under `dp`. `step.noise(state)` draws one step's noise as the
    step would ({"z", "spatial_noise", "gp_eps"}, None where the step takes
    none), for a caller that draws ahead (`gea_torch.train.dispatch`)."""
    weights = stage_weights(cfg)
    n_stages = cfg.n_stages
    d_real_fn, d_fake_fn, g_fn = losses.gan_objective(cfg.gan_loss)
    use_gp = cfg.gan_loss == "wgan-gp"
    accum = check_accum(cfg)
    stage_w = device_weights(weights)
    batch_norm = cfg.norm == "batch"
    # `gea`: None = shared unless batch norm; batch norm never shares.
    share = share_g_forward is not False and not batch_norm

    def draws(state: GLISTrainState, batch: int, z=None, sn=None, eps=None):
        """z, spatial noise and eps, each drawn where not given, in this
        order."""
        z, sn = draw_noise(state, state.generator, batch, cfg.code_size, z, sn, dp)
        if not use_gp:
            eps = None
        elif eps is None:
            eps = draw(state, torch.rand, (batch, 1, 1, 1), dp)
        return z, sn, to_device(eps, state.device)

    def inputs(state: GLISTrainState, real, z, sn, eps):
        real = to_device(real, state.device)
        return (real, *draws(state, real.shape[0], z, sn, eps))

    def g_images(g, z, sn, grad: bool) -> torch.Tensor:
        """(S, B, H, W, 3) fakes in the compute dtype."""
        if not grad:
            with torch.no_grad():
                return g(z, sn)[0]
        if cfg.remat:
            return checkpoint(stats_once(lambda z_, sn_: g(z_, sn_)[0], g), z, sn,
                              use_reentrant=False,
                              preserve_rng_state=False)  # G's forward draws nothing
        return g(z, sn)[0]

    def d_loss(d, real, fakes, eps, w):
        batch = real.shape[0]
        flat = fakes.reshape(-1, *fakes.shape[2:])
        if batch_norm:
            # Separate forwards keep each population's batch statistics.
            logits_real = d(real)
            logits_fake = d(flat)
        else:
            logits = d(torch.cat([real.to(flat.dtype), flat]))
            logits_real, logits_fake = logits[:batch], logits[batch:]
        logits_fake = logits_fake.reshape(n_stages, batch)
        loss = d_real_fn(logits_real) + losses.staged_apply(d_fake_fn, logits_fake, w)
        if use_gp:
            with frozen_stats(d):
                gp = losses.gradient_penalty(d, real, fakes[-1], eps)
            loss = loss + cfg.gp_weight * gp
        return loss, logits_real, logits_fake

    def g_backward(d, images, w) -> torch.Tensor:
        """The G loss against D, and its gradient pulled back through the
        graph of `images` into G's parameters."""
        leaf = images.detach().requires_grad_(True)
        with frozen_stats(d):
            logits = d(leaf.reshape(-1, *leaf.shape[2:])).reshape(n_stages, leaf.shape[1])
        loss = losses.staged_apply(g_fn, logits, w)
        (d_images,) = torch.autograd.grad(loss, leaf)
        images.backward(d_images.to(images.dtype))
        return loss.detach()

    def finish(state: GLISTrainState) -> None:
        if cfg.g_ema > 0:
            with torch.no_grad():
                for name, p in state.generator.named_parameters():
                    state.g_ema[name].mul_(cfg.g_ema).add_(p, alpha=1.0 - cfg.g_ema)
        state.step += 1

    def step(state: GLISTrainState, real, z=None, spatial_noise=None, gp_eps=None) -> Metrics:
        g, d = state.generator, state.discriminator
        real, z, sn, eps = inputs(state, real, z, spatial_noise, gp_eps)
        w = stage_w(real.device)

        with contextlib.nullcontext() if share else frozen_stats(g):
            fakes_live = g_images(g, z, sn, grad=share)
        zero_grads(state.opt_d, d, dp)
        loss_d, logits_real, logits_fake = d_loss(d, real, fakes_live.detach(), eps, w)
        loss_d.backward()
        mean_grads(d, 1, dp)
        _update(state.opt_d, state.sched_d)

        zero_grads(state.opt_g, g, dp)
        if not share:
            fakes_live = g_images(g, z, sn, grad=True)
        loss_g = g_backward(d, fakes_live, w)
        mean_grads(g, 1, dp)
        _update(state.opt_g, state.sched_g)
        mean_stats(dp, g, d)
        finish(state)
        return mean_metrics({
            "loss_d": loss_d.detach(),
            "loss_g": loss_g,
            "d_real": torch.sigmoid(logits_real.detach()).mean(),
            "d_fake_final": torch.sigmoid(logits_fake[-1].detach()).mean(),
        }, dp)

    def step_accum(state: GLISTrainState, real, z=None, spatial_noise=None,
                   gp_eps=None) -> Metrics:
        g, d = state.generator, state.discriminator
        real, z, sn, eps = inputs(state, real, z, spatial_noise, gp_eps)
        batch = real.shape[0]
        mbs = list(zip(*(microbatches(t, batch, accum) for t in (real, z, sn, eps))))
        w = stage_w(real.device)

        zero_grads(state.opt_d, d, dp)
        loss_d = d_real = d_fake = 0.0
        for real_mb, z_mb, sn_mb, eps_mb in mbs:
            fakes = g_images(g, z_mb, sn_mb, grad=False)
            loss, logits_real, logits_fake = d_loss(d, real_mb, fakes, eps_mb, w)
            loss.backward()
            loss_d = loss_d + loss.detach()
            d_real = d_real + torch.sigmoid(logits_real.detach()).mean()
            d_fake = d_fake + torch.sigmoid(logits_fake[-1].detach()).mean()
        mean_grads(d, accum, dp)
        _update(state.opt_d, state.sched_d)

        zero_grads(state.opt_g, g, dp)
        loss_g = 0.0
        for _, z_mb, sn_mb, _ in mbs:
            loss_g = loss_g + g_backward(d, g_images(g, z_mb, sn_mb, grad=True), w)
        mean_grads(g, accum, dp)
        _update(state.opt_g, state.sched_g)
        finish(state)
        return mean_metrics({"loss_d": loss_d / accum, "loss_g": loss_g / accum,
                             "d_real": d_real / accum, "d_fake_final": d_fake / accum}, dp)

    chosen = step_accum if accum > 1 else step
    chosen.noise = lambda state: dict(zip(("z", "spatial_noise", "gp_eps"),
                                          draws(state, local_batch(cfg, dp))))
    return chosen

