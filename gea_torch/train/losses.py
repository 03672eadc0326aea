"""GAN objectives (port of `gea/train/losses.py`).

Every loss takes raw logits and is computed in fp32. The gradients at a
kink are JAX's: `maximum` splits a tie in halves and `relu` takes 0, as in
torch, but JAX's |x| takes the slope 1 at 0, where torch's `abs` takes 0.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """mean( max(x,0) - x*t + log(1+exp(-|x|)) ), the stable BCE form."""
    x = logits.float()
    t = targets.float()
    abs_x = torch.where(x >= 0, x, -x)
    loss = torch.maximum(x, torch.zeros_like(x)) - x * t + torch.log1p(torch.exp(-abs_x))
    return loss.mean()


def d_real_loss(logits: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(logits, torch.ones_like(logits))


def d_fake_loss(logits: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(logits, torch.zeros_like(logits))


def g_adv_loss(logits: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(logits, torch.ones_like(logits))


def hinge_d_real(logits: torch.Tensor) -> torch.Tensor:
    return torch.relu(1.0 - logits.float()).mean()


def hinge_d_fake(logits: torch.Tensor) -> torch.Tensor:
    return torch.relu(1.0 + logits.float()).mean()


def hinge_g(logits: torch.Tensor) -> torch.Tensor:
    return -logits.float().mean()


def wgan_d_real(logits: torch.Tensor) -> torch.Tensor:
    return -logits.float().mean()


def wgan_d_fake(logits: torch.Tensor) -> torch.Tensor:
    return logits.float().mean()


def wgan_g(logits: torch.Tensor) -> torch.Tensor:
    return -logits.float().mean()


def staged_apply(fn: Callable, logits_per_stage: torch.Tensor,
                 weights: Sequence[float] | torch.Tensor) -> torch.Tensor:
    """sum_s w_s * fn(logits[s]) over the stages of logits (S, B)."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=logits_per_stage.device)
    per_stage = torch.stack([fn(lg) for lg in logits_per_stage])
    return (w * per_stage).sum()


def staged_loss(logits_per_stage: torch.Tensor, weights: Sequence[float] | torch.Tensor,
                target: float) -> torch.Tensor:
    """sum_s w_s * BCE(logits[s], target) over the stages of logits (S, B),
    with one target for every logit."""
    t = torch.full(logits_per_stage.shape[1:], target, dtype=torch.float32,
                   device=logits_per_stage.device)
    return staged_apply(lambda lg: bce_with_logits(lg, t), logits_per_stage, weights)


def gradient_penalty(d_apply: Callable, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP: E[(||grad_x D(x_hat)|| - 1)^2] on the interpolates
    x_hat = eps*real + (1-eps)*fake, eps (B, 1, 1, 1). The gradient keeps
    its graph (a double backward), so the caller can differentiate the
    penalty with respect to D's parameters."""
    x_hat = eps * real.float() + (1.0 - eps) * fake.float()
    x_hat = x_hat.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d_apply(x_hat).float().sum(), x_hat, create_graph=True)
    norms = torch.sqrt(g.square().sum(dim=(1, 2, 3)) + 1e-12)
    return (norms - 1.0).square().mean()


def gan_objective(kind: str):
    """(d_real_fn, d_fake_fn, g_fn) for `gan_loss` bce | hinge | wgan-gp."""
    if kind == "hinge":
        return hinge_d_real, hinge_d_fake, hinge_g
    if kind == "wgan-gp":
        return wgan_d_real, wgan_d_fake, wgan_g
    if kind == "bce":
        return d_real_loss, d_fake_loss, g_adv_loss
    raise ValueError(f"unknown gan_loss {kind!r}")


def z_similarity_loss(delta: torch.Tensor) -> torch.Tensor:
    """Mean squared correction magnitude ||z' - z||^2 / dim."""
    return delta.float().square().mean()
