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
`torch.autograd.Function` whose forward is the op. Its backward, the one
of `gea/ops/pallas/tprelu.py::_bwd` (dx, da and db), is a second Triton
kernel bound as the custom op `gea_torch::fused_tprelu_backward`, with
`fused_tprelu_backward_plain` as its plain version. It reads x and the
cotangent g once and writes dx once, so its bound is bytes too:
3*M*C*itemsize over 3.35 TB/s (about 47 us at (409600, 64) in bf16). The
per-channel sums behind da and db are the part a TPU grid would carry from
one step to the next; here blocks run in no order, so the pass runs on a
persistent grid of a few hundred programs, each walking its share of the
row tiles with two fp32 (rows, channels) accumulators that it reduces once
and writes as one row of a (2, P, C) buffer of partial sums. A second,
small kernel sums those P rows in a fixed order; each of its programs
loads all P rows of a few channels at once (a loop over the rows, one
load after another, made the backward 0.54 ms a G-LIS step on the H100
against 0.41 ms this way). There are no atomics: the gradients are the
same bit for bit from run to run, which the graphed and data-parallel
steps are checked against. Where
neither a nor b needs a gradient (the LeakyReLU of `norm=batch` and
`norm=none`, a frozen D), the partial sums and the second kernel are
skipped. The gradient's own backward (a gradient penalty differentiates D
twice) is eager PyTorch in `FusedTPReLUGrad`.
"""

from __future__ import annotations

import functools

import torch

from gea_torch.ops.build import check_cuda_inputs

_BLOCK_ELEMS = 8192
# The backward's tile (elements of a (rows, channels) tile), persistent grid
# (programs an SM) and warps a program, chosen by timing tile, grid and warp
# settings at the G-LIS step's shapes on the H100.
_GRAD_BLOCK_ELEMS = 2048
_GRAD_PROGRAMS_PER_SM = 4
_GRAD_WARPS = 4
_REDUCE_ELEMS = 8192  # partial sums a program of the second kernel loads at once


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


def fused_tprelu_backward_plain(x, a, b, g, need_ab: bool = True):
    """The gradient of `fused_tprelu` as `gea`'s `_bwd` takes it: (dx, da,
    db), da and db None unless asked for. Plain PyTorch with the kernel's
    roundings: s and fprime in x's dtype, the products with g in the type
    eager promotion gives them, dx cast to x's dtype, and the sums over every
    axis but the last in fp32 (or wider), cast to a's and b's types."""
    s = x - b.to(x.dtype)
    neg = s < 0
    fprime = torch.where(neg, a.to(x.dtype), torch.ones_like(x))
    dx = (g * fprime).to(x.dtype)
    if not need_ab:
        return dx, None, None
    axes = tuple(range(x.dim() - 1))
    acc = torch.promote_types(x.dtype, torch.float32)
    da = torch.where(neg, g * s, torch.zeros_like(x)).sum(axes, dtype=acc).to(a.dtype)
    db = (g * (1 - fprime)).sum(axes, dtype=acc).to(b.dtype)
    return dx, da, db


@functools.cache
def _grad_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def tprelu_grad_kernel(
        x_ptr, g_ptr, a_ptr, b_ptr, dx_ptr, part_ptr, M, C, tiles, programs,
        BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr, NEED_AB: tl.constexpr,
        PROD_BF16: tl.constexpr,
    ):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        dt = dx_ptr.dtype.element_ty
        a = tl.load(a_ptr + cols, mask=cmask, other=0.0).to(dt).to(tl.float32)[None, :]
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0).to(dt).to(tl.float32)[None, :]
        acc_a = tl.zeros((BLOCK_M, BLOCK_C), tl.float32)
        acc_b = tl.zeros((BLOCK_M, BLOCK_C), tl.float32)
        for t in range(pid, tiles, programs):
            rows = t * BLOCK_M + tl.arange(0, BLOCK_M)
            mask = (rows[:, None] < M) & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            # The plain version's roundings: s and 1 - fprime in x's dtype,
            # the products with g in the promoted type (bf16 only when g and
            # x both are: a product of two bf16 values is exact in fp32).
            s = (x - b).to(dt).to(tl.float32)
            neg = s < 0.0
            fprime = tl.where(neg, a, 1.0)
            tl.store(dx_ptr + offs, (g * fprime).to(dt), mask=mask)
            if NEED_AB:
                gs = g * s
                gq = g * (1.0 - fprime).to(dt).to(tl.float32)
                if PROD_BF16:
                    gs = gs.to(tl.bfloat16).to(tl.float32)
                    gq = gq.to(tl.bfloat16).to(tl.float32)
                acc_a += tl.where(neg, gs, 0.0)
                acc_b += gq
        if NEED_AB:
            tl.store(part_ptr + pid * C + cols, tl.sum(acc_a, axis=0), mask=cmask)
            tl.store(part_ptr + (programs + pid) * C + cols, tl.sum(acc_b, axis=0), mask=cmask)

    @triton.jit
    def tprelu_grad_reduce(
        part_ptr, da_ptr, db_ptr, programs, C,
        BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr,
    ):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        acc_a = tl.zeros((BLOCK_P, BLOCK_C), tl.float32)
        acc_b = tl.zeros((BLOCK_P, BLOCK_C), tl.float32)
        for p0 in range(0, programs, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            mask = (rows[:, None] < programs) & cmask[None, :]
            offs = rows[:, None] * C + cols[None, :]
            acc_a += tl.load(part_ptr + offs, mask=mask, other=0.0)
            acc_b += tl.load(part_ptr + programs * C + offs, mask=mask, other=0.0)
        tl.store(da_ptr + cols, tl.sum(acc_a, axis=0).to(da_ptr.dtype.element_ty), mask=cmask)
        tl.store(db_ptr + cols, tl.sum(acc_b, axis=0).to(db_ptr.dtype.element_ty), mask=cmask)

    return triton, tprelu_grad_kernel, tprelu_grad_reduce


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@torch.library.custom_op("gea_torch::fused_tprelu_backward", mutates_args=(),
                         device_types="cpu")
def tprelu_backward_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                       need_ab: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op on the CPU: the plain version. A custom op returns no None:
    da and db not asked for come back empty."""
    dx, da, db = fused_tprelu_backward_plain(x, a, b, g, need_ab)
    if not need_ab:
        da, db = a.new_empty(0), b.new_empty(0)
    return dx.contiguous(), da, db


@tprelu_backward_op.register_fake
def _(x, a, b, g, need_ab):
    size = a.shape if need_ab else (0,)
    return x.new_empty(x.shape), a.new_empty(size), b.new_empty(size)


@tprelu_backward_op.register_kernel("cuda")
def _launch_backward(x, a, b, g, need_ab):
    check_cuda_inputs("fused_tprelu_backward", x, a, b, g)
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"fused_tprelu_backward: unsupported dtypes x {x.dtype}, g {g.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_tprelu_backward: x must be contiguous (channels on the last axis)")
    if g.shape != x.shape:
        raise ValueError(f"fused_tprelu_backward: g {tuple(g.shape)} != x {tuple(x.shape)}")
    c = x.shape[-1]
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"fused_tprelu_backward: a, b must be ({c},), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    g = g.contiguous()  # the cotangent keeps its dtype: eager promotion decides the products'
    a, b = a.contiguous(), b.contiguous()
    m = x.numel() // c
    dx = torch.empty_like(x)
    if not need_ab:
        da, db = a.new_empty(0), b.new_empty(0)
    elif m == 0:  # no rows: sums of nothing
        da, db = torch.zeros_like(a), torch.zeros_like(b)
    else:
        da, db = torch.empty_like(a), torch.empty_like(b)
    if m == 0:  # no launch
        return dx, da, db
    triton, kernel, reduce = _grad_kernels()
    block_c = triton.next_power_of_2(c)
    block_m = max(1, _GRAD_BLOCK_ELEMS // block_c)
    tiles = triton.cdiv(m, block_m)
    programs = min(tiles, _GRAD_PROGRAMS_PER_SM * _sm_count(x.device.index))
    part = torch.empty((2, programs, c), device=x.device, dtype=torch.float32) if need_ab else dx
    prod_bf16 = torch.promote_types(x.dtype, g.dtype) == torch.bfloat16
    with torch.cuda.device(x.device):
        kernel[(programs,)](x, g, a, b, dx, part, m, c, tiles, programs,
                            BLOCK_M=block_m, BLOCK_C=block_c, NEED_AB=need_ab,
                            PROD_BF16=prod_bf16, num_warps=_GRAD_WARPS)
        if need_ab:
            block_p = min(max(triton.next_power_of_2(programs), 16), 1024)
            reduce_c = min(block_c, max(1, _REDUCE_ELEMS // block_p))
            reduce[(triton.cdiv(c, reduce_c),)](part, da, db, programs, c, BLOCK_P=block_p,
                                                BLOCK_C=reduce_c, num_warps=8)
    fused_tprelu_backward.launches += 1
    return dx, da, db


def fused_tprelu_backward(x, a, b, g, need_ab: bool = True):
    """(dx, da, db) of `fused_tprelu` for the cotangent g: the kernel on a
    CUDA tensor, the plain version on a CPU one; da and db None unless
    asked for."""
    dx, da, db = tprelu_backward_op(x, a, b, g, need_ab)
    return (dx, da, db) if need_ab else (dx, None, None)


def _forward(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tprelu_op(x, a, b)


def _backward(x, a, b, g, need_ab: bool):
    return fused_tprelu_backward(x, a, b, g, need_ab)


class FusedTPReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.save_for_backward(x, a, b)
        return _forward(x, a, b)

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        # da and db together or neither: autograd drops a gradient returned
        # for an input that needs none.
        need = ctx.needs_input_grad
        return FusedTPReLUGrad.apply(x, a, b, g, need[1] or need[2])


class FusedTPReLUGrad(torch.autograd.Function):
    """(dx, da, db) of `FusedTPReLU` through the backward op. Its own
    backward, reached only when a gradient penalty differentiates the
    gradient again, is the derivative of the plain version in eager ops
    (s < 0 held fixed, as autograd takes it through `where`)."""

    @staticmethod
    def forward(ctx, x, a, b, g, need_ab):
        ctx.save_for_backward(x, a, b, g)
        return _backward(x, a, b, g, need_ab)

    @staticmethod
    def backward(ctx, gdx, gda, gdb):
        x, a, b, g = ctx.saved_tensors
        need = ctx.needs_input_grad
        s = x - b.to(x.dtype)
        neg = s < 0
        fprime = torch.where(neg, a.to(x.dtype), torch.ones_like(x))
        axes = tuple(range(x.dim() - 1))
        acc = torch.promote_types(x.dtype, torch.float32)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        dg = gdx * fprime
        if gda is not None:
            dg = dg + torch.where(neg, gda * s, zero)
        if gdb is not None:
            dg = dg + gdb * (1 - fprime)
        grads = [None] * 5
        if need[3]:
            grads[3] = dg.to(g.dtype)
        if need[0] and gda is not None:
            grads[0] = torch.where(neg, gda * g, zero).to(x.dtype)
        if need[1]:
            da2 = gdx if gdb is None else gdx - gdb
            grads[1] = torch.where(neg, g * da2, zero).sum(axes, dtype=acc).to(a.dtype)
        if need[2] and gda is not None:
            grads[2] = -torch.where(neg, g * gda, zero).sum(axes, dtype=acc).to(b.dtype)
        return tuple(grads)


def fused_tprelu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """TPReLU over the trailing channel axis of x; differentiable."""
    return FusedTPReLU.apply(x, a, b)


fused_tprelu.launches = 0
fused_tprelu_backward.launches = 0
