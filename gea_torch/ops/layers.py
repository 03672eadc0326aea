"""Weight-normalised layers and the TPReLU activation (port of
`gea/ops/layers.py`).

Parameters live in fp32 and keep the `state_dict` names of the torch
mirrors in `gea/interop/torch_port.py`: `weight_v`/`weight_g`/`bias` with
weight norm, `weight`/`bias` without, and `a`/`b` for a TPReLU. The weight
norm is computed explicitly on every call, in fp32, per output channel, and
the result is cast to the compute dtype, as `gea` does.

Activations between layers are NHWC tensors; the convolutions see them as
NCHW views in `torch.channels_last` memory, so NHWC stays the physical
layout and the TPReLU kernel sees rows of C contiguous channels. The
convolutions and the dense head are library calls, as XLA computed them
outside any Pallas kernel in `gea`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gea_torch.ops.tprelu import fused_tprelu, fused_tprelu_plain


def normalize_weight(v: torch.Tensor, g: torch.Tensor, out_dim: int) -> torch.Tensor:
    """w = g * v / ||v|| with the norm over every axis but `out_dim`,
    computed in fp32 with 1e-12 inside the sqrt (`gea/ops/layers.py:147`)."""
    v32 = v.float()
    axes = [i for i in range(v.dim()) if i != out_dim]
    norm = torch.sqrt(v32.square().sum(dim=axes, keepdim=True) + 1e-12)
    return (v32 / norm) * g.float()


class _Weighted(nn.Module):
    """A weight of `shape` (torch layout) with optional weight norm over
    every axis but `out_dim`, and a bias of the output width."""

    def __init__(self, shape: Tuple[int, ...], out_dim: int, fan_in: int, weight_norm: bool):
        super().__init__()
        self.out_dim = out_dim
        self.weight_norm = weight_norm
        v = torch.randn(shape) / math.sqrt(fan_in)
        if weight_norm:
            self.weight_v = nn.Parameter(v)
            g_shape = [1] * len(shape)
            g_shape[out_dim] = shape[out_dim]
            self.weight_g = nn.Parameter(torch.ones(g_shape))
        else:
            self.weight = nn.Parameter(v)
        self.bias = nn.Parameter(torch.zeros(shape[out_dim]))

    def normalized_weight(self) -> torch.Tensor:
        """The effective weight in fp32."""
        if self.weight_norm:
            return normalize_weight(self.weight_v, self.weight_g, self.out_dim)
        return self.weight.float()


class Dense(_Weighted):
    """Linear layer; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, weight_norm: bool):
        super().__init__((out_features, in_features), 0, in_features, weight_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        return torch.matmul(x, self.normalized_weight().t().to(dt)) + self.bias.to(dt)


class Conv(_Weighted):
    """Conv2d(k=4, s=2, p=1) on NHWC input; weight (out, in, 4, 4)."""

    def __init__(self, in_ch: int, out_ch: int, weight_norm: bool):
        super().__init__((out_ch, in_ch, 4, 4), 0, in_ch * 16, weight_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.conv2d(
            x.permute(0, 3, 1, 2),
            self.normalized_weight().to(dt),
            self.bias.to(dt),
            stride=2,
            padding=1,
        )
        return y.permute(0, 2, 3, 1)


class ConvTranspose(_Weighted):
    """ConvTranspose2d(k=4, s=2, p=1) on NHWC input; weight (in, out, 4, 4),
    weight norm over (in, kh, kw) per output channel."""

    def __init__(self, in_ch: int, out_ch: int, weight_norm: bool):
        super().__init__((in_ch, out_ch, 4, 4), 1, in_ch * 16, weight_norm)

    def hwio_weight(self) -> torch.Tensor:
        """The effective fp32 weight in gea's HWIO layout (4, 4, in, out)."""
        return self.normalized_weight().permute(2, 3, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2),
            self.normalized_weight().to(dt),
            self.bias.to(dt),
            stride=2,
            padding=1,
        )
        return y.permute(0, 2, 3, 1)


class TPReLU(nn.Module):
    """y = PReLU_a(x - b) + b over the trailing (channel) axis of x.

    With `learned=False` it is LeakyReLU(0.2) written as a TPReLU with
    a = 0.2, b = 0 held in buffers outside the state_dict (`norm=none`)."""

    def __init__(self, ch: int, learned: bool = True, use_kernels: bool = True):
        super().__init__()
        self.use_kernels = use_kernels
        if learned:
            self.a = nn.Parameter(torch.full((ch,), 0.25))
            self.b = nn.Parameter(torch.zeros(ch))
        else:
            self.register_buffer("a", torch.full((ch,), 0.2), persistent=False)
            self.register_buffer("b", torch.zeros(ch), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        op = fused_tprelu if self.use_kernels else fused_tprelu_plain
        return op(x.contiguous(), self.a, self.b)


def norm_act(norm: str, ch: int, use_kernels: bool = True) -> TPReLU:
    """The activation after a conv for `--norm weight|none`."""
    if norm == "batch":
        raise NotImplementedError("norm=batch is not ported yet")
    return TPReLU(ch, learned=norm == "weight", use_kernels=use_kernels)
