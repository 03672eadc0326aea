"""TPReLU, `max(x-b, 0) + a*min(x-b, 0) + b` per channel over the trailing
axis, as one Triton kernel.

Replaces `gea/ops/pallas/tprelu.py::fused_tprelu` (the `pl.pallas_call` in
`_forward_2d`). As in that kernel, `a` and `b` are cast to x's dtype and the
arithmetic rounds to x's dtype after every operation.

Bound on the H100: bytes. The pass reads x once and writes y once, so the
least time is 2*M*C*itemsize over 3.35 TB/s (about 31 us for the largest
generator activation, (409600, 64) in bf16). The design is a plain masked
block pass: each program loads a (BLOCK_M, BLOCK_C) tile of contiguous rows
with the per-channel a/b broadcast across it. Triton's masked block loads
are wide and coalesced, so they reach memory bandwidth as well as a CUDA
kernel written by hand would; nothing else is needed for a streaming
elementwise pass.

The kernel is the custom op `gea_torch::fused_tprelu` (`torch.library`),
so `torch.export` records it as one node of an exported graph: its CPU
implementation is the plain version, its CUDA one launches the kernel (and
counts the launch in `fused_tprelu.launches`) or raises, and its fake
implementation gives the output's shape and dtype to the tracer.

`fused_tprelu` is differentiable on both devices through `FusedTPReLU`, a
`torch.autograd.Function` whose forward is the op. Its backward is the one
of `gea/ops/pallas/tprelu.py::_bwd`, written out in eager PyTorch ops and
itself differentiable, so a gradient penalty can differentiate through it
twice.
"""

from __future__ import annotations

import functools

import torch

from gea_torch.ops.build import check_cuda_inputs

_BLOCK_ELEMS = 8192


def fused_tprelu_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., C); a, b (C,). Plain PyTorch, rounding to x's dtype per op.
    Written with `where`, as `gea`'s reference is, so that its autograd
    takes the slope 1 at s = 0 as the explicit backward does."""
    a = a.to(x.dtype)
    b = b.to(x.dtype)
    s = x - b
    return torch.where(s < 0, a * s, s) + b


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def tprelu_kernel(
        x_ptr, a_ptr, b_ptr, o_ptr, M, C,
        BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        mask = (rows[:, None] < M) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        dt = o_ptr.dtype.element_ty
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        a = tl.load(a_ptr + cols, mask=cmask, other=0.0).to(tl.float32)[None, :]
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(tl.float32)[None, :]
        # Round to x's dtype after each operation, as the reference does.
        s = (x - b).to(dt).to(tl.float32)
        neg = (a * tl.minimum(s, 0.0)).to(dt).to(tl.float32)
        y = (tl.maximum(s, 0.0) + neg).to(dt).to(tl.float32)
        tl.store(o_ptr + offs, (y + b).to(dt), mask=mask)

    return triton, tprelu_kernel


@torch.library.custom_op("gea_torch::fused_tprelu", mutates_args=(), device_types="cpu")
def tprelu_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return fused_tprelu_plain(x, a, b).contiguous()


@tprelu_op.register_fake
def _(x, a, b):
    return x.new_empty(x.shape)


@tprelu_op.register_kernel("cuda")
def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_cuda_inputs("fused_tprelu", x, a, b)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_tprelu: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_tprelu: x must be contiguous (channels on the last axis)")
    c = x.shape[-1]
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"fused_tprelu: a, b must be ({c},), got {tuple(a.shape)}, {tuple(b.shape)}")
    m = x.numel() // c
    a = a.to(x.dtype).contiguous()
    b = b.to(x.dtype).contiguous()
    out = torch.empty_like(x)
    if m == 0:
        return out
    triton, kernel = _kernel()
    block_c = triton.next_power_of_2(c)
    block_m = max(1, _BLOCK_ELEMS // block_c)
    grid = (triton.cdiv(m, block_m),)
    with torch.cuda.device(x.device):
        kernel[grid](x, a, b, out, m, c, BLOCK_M=block_m, BLOCK_C=block_c, num_warps=8)
    fused_tprelu.launches += 1
    return out


def _forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tprelu_op(x, a, b)


class FusedTPReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        return _forward(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        s = x - b.to(x.dtype)
        neg = s < 0
        fprime = torch.where(neg, a.to(x.dtype), torch.ones_like(x))
        dx = (g * fprime).to(x.dtype)
        # The sums over every axis but the channel one accumulate in fp32
        # (or wider).
        axes = tuple(range(x.dim() - 1))
        acc = torch.promote_types(x.dtype, torch.float32)
        da = db = None
        if ctx.needs_input_grad[1]:
            da = torch.where(neg, g * s, torch.zeros_like(x)).sum(axes, dtype=acc).to(a.dtype)
        if ctx.needs_input_grad[2]:
            db = (g * (1 - fprime)).sum(axes, dtype=acc).to(b.dtype)
        return dx, da, db


def fused_tprelu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TPReLU over the trailing channel axis of x; differentiable."""
    return FusedTPReLU.apply(x, a, b)


fused_tprelu.launches = 0
