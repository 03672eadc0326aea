"""Reverser network R (port of `gea/models/reverter.py`).

R maps a generated image back to a code: the discriminator's conv trunk,
then a dense head onto the code space (`fc1` -> activation -> `fc2`). The
head's activation is the TPReLU kernel on a (B, hidden) input
(`gea_torch.ops.tprelu.fused_tprelu`); with `norm=none` or `batch` it is
the LeakyReLU(0.2) of `gea`, written as a TPReLU with a = 0.2, b = 0 (the
head has no batch norm; the trunk has, under `norm=batch`). The
output is fp32. Module and parameter names are those of `TorchReverter` in
`gea/interop/torch_port.py`.

One module, two output contracts; be explicit when wiring R:

* **R-iterative treats R's output as a residual dz**: the chain composes
  z_{t+1} = z_t + R(G(z_t)) (`iterative_chain` below and
  `steps_r.build_r_iterative_step`), and the similarity penalty
  lambda_r * ||dz||^2 regularises the raw output.
* **R-separate treats R's output as the absolute corrected code**: the
  step trains it against the final LIS code zs[-1], not z
  (`steps_r.build_r_separate_step`), and sampling blends z_hat with z
  (`blend_correction`). No residual add.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from gea_torch.config import ModelConfig, resolve_device
from gea_torch.models.discriminator import DiscriminatorTrunk
from gea_torch.ops.layers import Dense, TPReLU


class Reverter(nn.Module):
    """NHWC image (B, H, W, 3) -> fp32 code (B, code_size); head width
    `cfg.r_hidden`."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 use_kernels: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        wn = cfg.norm == "weight"
        hidden = getattr(cfg, "r_hidden", 512)  # a model config has none
        self.trunk = DiscriminatorTrunk(cfg, use_kernels)
        self.fc1 = Dense(self.trunk.out_features, hidden, wn)
        self.act = TPReLU(hidden, learned=wn, use_kernels=use_kernels)
        self.fc2 = Dense(hidden, cfg.code_size, wn)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.fc2.bias.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.trunk(x.to(self.cfg.torch_dtype))
        return self.fc2(self.act(self.fc1(h))).float()


def apply_correction(z: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """One reverser step: z' = z + R(G(z))."""
    return z + delta


def blend_correction(z: torch.Tensor, z_hat: torch.Tensor, strength: float = 0.3,
                     shell_renorm: bool = True) -> torch.Tensor:
    """R-separate's correction at sampling time: blend the absolute
    corrected code toward the original and project it back onto the
    Gaussian shell ||z|| = sqrt(d)."""
    z2 = (1.0 - strength) * z + strength * z_hat
    if shell_renorm:
        d = float(z.shape[-1])
        z2 = z2 * d**0.5 / torch.linalg.vector_norm(z2, dim=-1, keepdim=True)
    return z2


def corrected_render(generator, reverter: Reverter, z: torch.Tensor,
                     spatial_noise: Optional[torch.Tensor], strength: float = 0.3,
                     shell_renorm: bool = True, steps: int = 1) -> torch.Tensor:
    """R-separate's correction applied `steps` times, z <- blend(z,
    R(G(z))), then the final stage of G(z) in the compute dtype: the
    corrected samples that `compute_fid --r_path` and the R-separate
    trainer's `--fid_interval` score."""
    for _ in range(steps):
        images = generator(z, spatial_noise, render_all_stages=True)[0]
        z = blend_correction(z, reverter(images[-1]), strength, shell_renorm)
    return generator(z, spatial_noise, render_all_stages=True)[0][-1]


def iterative_chain(generator, reverter: Reverter, z0: torch.Tensor,
                    spatial_noise: Optional[torch.Tensor], links: int) -> torch.Tensor:
    """The unrolled chain z_t = z_{t-1} + R(G(z_{t-1})) of a single-stage
    generator (r_iterations=0): the per-link images (links + 1, B, H, W, 3)
    in the compute dtype. Shared by the R-iterative trainer's sample grids
    and `--fid_interval`, and `eval_chain`."""
    z = z0
    imgs = [generator(z, spatial_noise)[0][0]]
    for _ in range(links):
        z = apply_correction(z, reverter(imgs[-1]))
        imgs.append(generator(z, spatial_noise)[0][0])
    return torch.stack(imgs)
