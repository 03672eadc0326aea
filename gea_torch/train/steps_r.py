"""The reverser train steps (port of `gea/train/steps_r.py`).

R-separate (`build_r_separate_step`): the generator is frozen (read from a
finished G-LIS run). R learns to invert it: from the final-stage image
G(z) it predicts the final LIS code zs[-1] that rendered it,

    loss = r_mse_weight * mean_b(w_b * ||R(G(z))_b - zs[-1]_b||^2 / code)
         + r_adv_weight * BCE(D(G(R(G(z)))), real)

The second term (D-feedback) renders the corrected code through the frozen
G with the same spatial noise and scores it with the frozen D; its gradient
flows through both (the seed and LIS kernels' backwards included) into R's
output, and only R's parameters gather gradients. With `r_mine_weight` > 0
the weights w are `1 - sigmoid(D(G(z)))`, normalised to mean 1 over the
whole batch and detached, blended with 1; otherwise w = 1. No real data is
needed: the frozen G is the data source.

R-iterative (`build_r_iterative_step`): G (single-stage, r_iterations=0),
D and R train jointly. Each step unrolls the correction chain
z_t = z_{t-1} + R(G(z_{t-1})) for `r_chain_length` links and renders an
image per link. (1) D is updated on the real batch and the detached chain
renders (two forwards), the links weighted 0.5 + 0.5 * i / (n - 1),
normalised (final link highest); (2) G and R are updated together against
the updated D with the same weights, plus lambda_r * ||z_t - z_{t-1}||^2 /
code; only G and R gather gradients.

Both steps: `grad_accum` K splits the batch (and z and spatial noise, drawn
for the full batch) into K microbatches and divides the summed gradients
by K; R-separate's frozen renders and mining weights stay full-batch.
`remat` recomputes, in the backward, R-separate's corrected render and its
scoring, and each of R-iterative's chain links and its first render
(`torch.utils.checkpoint`); a recompute updates no running statistic. z and spatial noise are inputs of the step;
where the caller gives none, the step draws them from the state's
`torch.Generator` on the device. The step updates the state in place and
returns its metrics as 0-d tensors on the device.

With `gea_torch.utils.trace` on, R-iterative's step opens these spans:
`riter.d` around D's half (its unroll, forwards, backward and update),
`riter.unroll` around each unroll (2 a step, one in each half), nested in
it `riter.link` around each link's R pass, residual add and render (T an
unroll), and `riter.gr_backward` around the G/R loss's backward through the
chain; it counts `riter.links` and `riter.renders` (2T and 2(T + 1) a
step). Captured into a CUDA graph, none of them runs on replay
(`gea_torch.utils.trace`).

`norm=batch` follows `gea`. R-separate's frozen G and D run on their
running statistics (inference mode, `state.freeze`); R normalises with
batch statistics and updates its running ones once a step. R-iterative's
D-step unroll updates nothing; D takes the real batch, then the flat chain
renders, each forward updating its statistics; the G/R unroll threads G's
statistics through all 1 + T renders and R's through the T links; the G/R
loss's D pass updates nothing (`frozen_stats`).

With `dp` (data parallelism, as in `gea_torch.train.steps`) each rank
trains on its slab of the global batch (R-separate: its rows of the global
draws, and the mining weights normalised over its own slab, as `gea`'s
shard is), and each trained player's gradients and the metrics are
averaged over the ranks before the updates, and the trained players'
running statistics after the step. Under tensor parallelism (`dp` a
`TensorParallel`) the steps keep the single program's semantics: the rows
of the single process's draws, the mining weights normalised over the
global batch, batch statistics over every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from gea_torch.config import TrainRIterativeConfig, TrainRSeparateConfig
from gea_torch.ops.layers import frozen_stats
from gea_torch.train import losses
from gea_torch.train.state import RIterativeTrainState, RSeparateTrainState
from gea_torch.train.steps import (
    Metrics,
    _update,
    check_accum,
    device_weights,
    draw_noise,
    local_batch,
    mean_grads,
    mean_metrics,
    mean_stats,
    microbatches,
    stats_once,
    to_device,
    zero_grads,
)
from gea_torch.utils import trace


def _remat(fn: Callable, *modules) -> Callable:
    """fn, with its forward recomputed in the backward, where the running
    statistics of `modules` stay as the first call left them. The
    segments draw no random numbers, so no RNG state is kept for the
    recompute (nor read from the generator inside a CUDA graph's
    capture)."""
    return lambda *args: checkpoint(stats_once(fn, *modules), *args, use_reentrant=False,
                                    preserve_rng_state=False)


def build_r_separate_step(cfg: TrainRSeparateConfig, dp=None) -> Callable[..., Metrics]:
    """Returns step(state, _unused=None, z=None, spatial_noise=None) ->
    metrics {loss_r, loss_r_mse, loss_r_adv, correction_norm}, and
    `step.noise(state)`, one step's draws ({"z", "spatial_noise"}). The second
    argument is ignored, so that `TrainLoop` can drive the step with an
    input-free stream. The frozen D of `state` (None without one) enables
    the D-feedback term (r_adv_weight > 0) and the mining weights
    (r_mine_weight > 0)."""
    accum = check_accum(cfg)

    def corr_logits(g, d, z_pred, sn):
        """The corrected code through the frozen G, its final stage scored
        by the frozen D."""
        def segment(z_, sn_):
            return d(g(z_, sn_, render_all_stages=True)[0][-1])

        return (_remat(segment) if cfg.remat else segment)(z_pred, sn)

    def step(state: RSeparateTrainState, _unused=None, z=None, spatial_noise=None) -> Metrics:
        g, d, r = state.generator, state.discriminator, state.reverter
        use_adv = d is not None and cfg.r_adv_weight > 0
        use_mine = d is not None and cfg.r_mine_weight > 0
        z, sn = draw_noise(state, g, local_batch(cfg, dp), cfg.code_size, z, spatial_noise, dp)
        batch = z.shape[0]
        with torch.no_grad():
            images, zs = g(z, sn, render_all_stages=True)
            final_img, target = images[-1], zs[-1]
            mine_w = None
            if use_mine:
                defect = 1.0 - torch.sigmoid(d(final_img).float())
                # Over the whole batch: this rank's slab under DP, the
                # global batch under TP (`batch_mean`).
                mean = defect.mean() if dp is None else dp.batch_mean(defect)
                defect = defect / (mean + 1e-8)
                mine_w = (1.0 - cfg.r_mine_weight) + cfg.r_mine_weight * defect

        zero_grads(state.opt_r, r, dp)
        sums = torch.zeros(4, device=z.device)
        zero = torch.zeros((), device=z.device)
        for img, code, mine, sn_mb in zip(*(microbatches(t, batch, accum)
                                            for t in (final_img, target, mine_w, sn))):
            z_pred = r(img)
            per_sample = (z_pred - code).square().mean(-1)
            if mine is not None:
                per_sample = per_sample * mine
            loss_mse = per_sample.mean()
            loss = cfg.r_mse_weight * loss_mse
            loss_adv = zero
            if use_adv:
                loss_adv = losses.g_adv_loss(corr_logits(g, d, z_pred, sn_mb))
                loss = loss + cfg.r_adv_weight * loss_adv
            loss.backward()
            norm = torch.linalg.vector_norm(z_pred.detach() - code, dim=-1).mean()
            sums += torch.stack([loss.detach(), loss_mse.detach(), loss_adv.detach(), norm])
        mean_grads(r, accum, dp)
        _update(state.opt_r, state.sched_r, r, dp)
        mean_stats(dp, r)
        state.step += 1
        sums = sums / accum
        return mean_metrics({"loss_r": sums[0], "loss_r_mse": sums[1], "loss_r_adv": sums[2],
                             "correction_norm": sums[3]}, dp)

    step.noise = lambda state: noise(cfg, state, dp)
    return step


def noise(cfg, state, dp=None) -> dict:
    """One R step's draws, as the step makes them where none is given."""
    z, sn = draw_noise(state, state.generator, local_batch(cfg, dp), cfg.code_size, None,
                       None, dp)
    return {"z": z, "spatial_noise": sn}


def link_weights(chain_length: int):
    """Per-link adversarial weights of R-iterative, final link highest,
    normalised to sum to 1 (not `stage_weights`)."""
    n = chain_length + 1
    raw = [0.5 + 0.5 * i / max(1, n - 1) for i in range(n)]
    return tuple(w / sum(raw) for w in raw)


def build_r_iterative_step(cfg: TrainRIterativeConfig, dp=None) -> Callable[..., Metrics]:
    """Returns step(state, real, z=None, spatial_noise=None) -> metrics
    {loss_d, loss_g, loss_r_sim, d_real}, and `step.noise(state)` as
    R-separate's. `real` (B, H, W, 3) in [-1, 1], B this rank's batch
    under `dp`; z (B, code) is the chain's z_0."""
    n_links = cfg.r_chain_length + 1
    link_w = device_weights(link_weights(cfg.r_chain_length))
    accum = check_accum(cfg)

    def unroll(g, r, z0, sn):
        """(images (T+1, B, H, W, 3) in the compute dtype, codes (T+1, B,
        code) in fp32) of the chain from z0."""
        def render(z):
            return g(z, sn)[0][0]

        def link(z_prev, img_prev):
            z_next = z_prev + r(img_prev)
            return z_next, render(z_next)

        first, next_link = render, link
        if cfg.remat and torch.is_grad_enabled():
            first, next_link = _remat(render, g), _remat(link, g, r)
        with trace.span("riter.unroll"):
            zs, imgs = [z0], [first(z0)]
            for _ in range(cfg.r_chain_length):
                with trace.span("riter.link"):
                    z_next, img_next = next_link(zs[-1], imgs[-1])
                zs.append(z_next)
                imgs.append(img_next)
            trace.count("riter.links", cfg.r_chain_length)
            trace.count("riter.renders", n_links)
            return torch.stack(imgs), torch.stack(zs)

    def step(state: RIterativeTrainState, real, z=None, spatial_noise=None) -> Metrics:
        g, d, r = state.generator, state.discriminator, state.reverter
        real = to_device(real, state.device)
        batch = real.shape[0]
        z0, sn = draw_noise(state, g, batch, cfg.code_size, z, spatial_noise, dp)
        mbs = list(zip(*(microbatches(t, batch, accum) for t in (real, z0, sn))))
        weights = link_w(real.device)

        # D on the real batch and the detached chain renders.
        with trace.span("riter.d"):
            zero_grads(state.opt_d, d, dp)
            loss_d = d_real = 0.0
            for real_mb, z_mb, sn_mb in mbs:
                with torch.no_grad(), frozen_stats(g, r):
                    fakes, _ = unroll(g, r, z_mb, sn_mb)
                logits_real = d(real_mb)
                logits_fake = d(fakes.reshape(-1, *fakes.shape[2:])).reshape(n_links, -1)
                loss = losses.d_real_loss(logits_real) + losses.staged_loss(
                    logits_fake, weights, 0.0)
                loss.backward()
                loss_d = loss_d + loss.detach()
                d_real = d_real + torch.sigmoid(logits_real.detach()).mean()
            mean_grads(d, accum, dp)
            _update(state.opt_d, state.sched_d, d, dp)

        # G and R together against the updated D.
        zero_grads(state.opt_g, g, dp)
        zero_grads(state.opt_r, r, dp)
        trained = [*g.parameters(), *r.parameters()]
        loss_g = loss_sim = 0.0
        for _, z_mb, sn_mb in mbs:
            images, zs = unroll(g, r, z_mb, sn_mb)
            with frozen_stats(d):
                logits = d(images.reshape(-1, *images.shape[2:])).reshape(n_links, -1)
            adv = losses.staged_loss(logits, weights, 1.0)
            sim = losses.z_similarity_loss(zs[1:] - zs[:-1])
            with trace.span("riter.gr_backward"):
                (adv + cfg.lambda_r * sim).backward(inputs=trained)
            loss_g = loss_g + adv.detach()
            loss_sim = loss_sim + sim.detach()
        mean_grads(g, accum, dp)
        mean_grads(r, accum, dp)
        _update(state.opt_g, state.sched_g, g, dp)
        _update(state.opt_r, state.sched_r, r, dp)
        mean_stats(dp, g, d, r)
        state.step += 1
        return mean_metrics({"loss_d": loss_d / accum, "loss_g": loss_g / accum,
                             "loss_r_sim": loss_sim / accum, "d_real": d_real / accum}, dp)

    step.noise = lambda state: noise(cfg, state, dp)
    return step
