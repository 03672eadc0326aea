"""DCGAN-style discriminator (port of `gea/models/discriminator.py`).

Stride-2 convs halve the resolution and double the channels down to the seed
resolution; a dense head over the NHWC-flattened features gives one logit
per image, returned in fp32. The first block is a LeakyReLU(0.2) with no
norm; every later block's activation is the TPReLU kernel
(`gea_torch.ops.tprelu.fused_tprelu`). Module and parameter names are those of
`TorchDiscriminator` in `gea/interop/torch_port.py`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from gea_torch.config import ModelConfig, generator_plan, resolve_device
from gea_torch.ops.layers import Conv, Dense, TPReLU, norm_act


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, first: bool, use_kernels: bool):
        super().__init__()
        self.conv = Conv(cin, cout, norm == "weight")
        self.act: Optional[TPReLU] = None if first else norm_act(norm, cout, use_kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.act is None:
            return F.leaky_relu(x, 0.2)
        return self.act(x)


class DiscriminatorTrunk(nn.Module):
    """NHWC image -> flat features at seed resolution, flattened in
    (h, w, c) order."""

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True):
        super().__init__()
        if cfg.norm == "batch":
            raise NotImplementedError("norm=batch is not ported yet")
        s0, d = generator_plan(cfg.image_size)
        nf, cap = cfg.num_features, cfg.max_features
        downs, ch = [], 3
        for i in range(d):
            ci = min(nf * 2**i, cap)
            downs.append(DownBlock(ch, ci, cfg.norm, i == 0, use_kernels))
            ch = ci
        self.downs = nn.ModuleList(downs)
        self.out_features = ch * s0 * s0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.downs:
            x = blk(x)
        return x.reshape(x.shape[0], -1)


class Discriminator(nn.Module):
    """NHWC image (B, H, W, 3) -> one fp32 logit per image."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 use_kernels: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.trunk = DiscriminatorTrunk(cfg, use_kernels)
        self.head = Dense(self.trunk.out_features, 1, cfg.norm == "weight")
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.trunk(x.to(self.cfg.torch_dtype))
        return self.head(h).squeeze(-1).float()
