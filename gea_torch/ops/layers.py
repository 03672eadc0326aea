"""Weight-normalised layers, the TPReLU activation and the batch-norm
block (port of `gea/ops/layers.py`).

Parameters live in fp32 and keep the `state_dict` names of the torch
mirrors in `gea/interop/torch_port.py`: `weight_v`/`weight_g`/`bias` with
weight norm, `weight`/`bias` without, and `a`/`b` for a TPReLU. The weight
norm is computed explicitly on every call, in fp32, per output channel, and
the result is cast to the compute dtype, as `gea` does.

Activations between layers are NHWC tensors; the convolutions see them as
NCHW views in `torch.channels_last` memory, so NHWC stays the physical
layout and the TPReLU kernel sees rows of C contiguous channels. The
convolutions and the dense head are library calls, as XLA computed them
outside any Pallas kernel in `gea`; so are batch norm's reductions, which
flax computed outside any kernel too.

`BatchNormAct` (`--norm batch`) keeps running statistics, and runs in one
of three modes, as `gea`'s `train`/`mutable` arguments choose them:

* `module.train()`: batch statistics, and the running ones updated;
* `module.train()` inside `frozen_stats(...)`: batch statistics, no update
  (a pass whose new `batch_stats` `gea` drops);
* `module.eval()`: the running statistics (`gea`'s `train=False`).

`eval_mode(...)` puts modules into inference mode for a block and back.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

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


BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch statistic
BN_EPSILON = 1e-5


class BatchNormAct(nn.Module):
    """BatchNorm over every axis but the trailing (channel) one, then
    LeakyReLU(0.2): `gea`'s `NormAct(norm="batch")`, flax's
    `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` as flax 0.12 computes it.

    The statistics are fp32 whatever the compute dtype: the mean and
    E[x^2] - mean^2, clipped at 0 (the biased variance). The output is
    (x - mean) * (scale * rsqrt(var + eps)) + bias in fp32, cast to the
    input's dtype, then the LeakyReLU as the TPReLU kernel with a = 0.2,
    b = 0 (its plain version with `use_kernels=False`). The running mean
    and variance are persistent buffers (`mean` 0 and `var` 1 at first),
    updated in place under no_grad, so a CUDA graph captures the update;
    `torch.nn.BatchNorm2d` is not used, as it keeps the unbiased variance."""

    def __init__(self, ch: int, use_kernels: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))
        self.act = TPReLU(ch, learned=False, use_kernels=use_kernels)
        self.update_stats = True  # off inside `frozen_stats`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dims)
            var = (x32.square().mean(dims) - mean.square()).clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.mean.mul_(BN_MOMENTUM).add_(mean.detach(), alpha=1 - BN_MOMENTUM)
                    self.var.mul_(BN_MOMENTUM).add_(var.detach(), alpha=1 - BN_MOMENTUM)
        else:
            mean, var = self.mean, self.var
        y = (x32 - mean) * (self.scale * torch.rsqrt(var + BN_EPSILON)) + self.bias
        return self.act(y.to(x.dtype))


def batch_norms(*modules) -> Iterator[BatchNormAct]:
    for m in modules:
        if m is not None:
            yield from (b for b in m.modules() if isinstance(b, BatchNormAct))


@contextlib.contextmanager
def frozen_stats(*modules):
    """Batch norm inside `modules` (None is skipped) normalises with batch
    statistics in train mode but updates no running statistic."""
    bns = list(batch_norms(*modules))
    kept = [b.update_stats for b in bns]
    for b in bns:
        b.update_stats = False
    try:
        yield
    finally:
        for b, k in zip(bns, kept):
            b.update_stats = k


@contextlib.contextmanager
def eval_mode(*modules):
    """`modules` (None is skipped) in inference mode, each submodule's
    mode put back afterwards."""
    kept = [(m, m.training) for mod in modules if mod is not None for m in mod.modules()]
    for mod in modules:
        if mod is not None:
            mod.eval()
    try:
        yield
    finally:
        for m, training in kept:
            m.training = training


def norm_act(norm: str, ch: int, use_kernels: bool = True) -> nn.Module:
    """The block after a conv: `--norm weight` a learned TPReLU, `none`
    LeakyReLU(0.2), `batch` BatchNorm then LeakyReLU(0.2)."""
    if norm == "batch":
        return BatchNormAct(ch, use_kernels)
    return TPReLU(ch, learned=norm == "weight", use_kernels=use_kernels)
