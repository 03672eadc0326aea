"""One LIS link, `z + W2 @ tprelu(W1 @ z + b1) + b2`, as one CUDA kernel
(`gea_torch/csrc/lis.cu`).

Replaces `gea/ops/pallas/lis.py::lis_residual_mlp`. Same arguments and the
same rounding: both products accumulate in fp32, the TPReLU runs in fp32,
the hidden row is cast to z's dtype before the second product, and that
product (plus b2) is cast to z's dtype before the residual add.

The link is bound by launch latency (0.1 us of bytes at the flagship shape).
The bf16 kernel runs on the tensor cores (mma.sync) as thread block
clusters of 8 blocks that share a tile of 16 rows: each block computes an
eighth of the hidden columns and of the output columns, and the blocks
exchange their hidden slices through distributed shared memory, so no SM
reads a weight whole. The fp32 kernel stays on the CUDA cores.

The kernel is the custom op `gea_torch::lis_residual_mlp` (`torch.library`),
so `torch.export` records it as one node of an exported graph: its CPU
implementation is the plain version, its CUDA one launches the kernel (and
counts the launch in `lis_residual_mlp.launches`) or raises, and its fake
implementation gives the output's shape and dtype to the tracer.

`lis_residual_mlp` is differentiable on both devices through
`LISResidualMLP`, a `torch.autograd.Function` whose forward is the op. Its
backward is the one of `gea/ops/pallas/lis.py::_bwd` in eager PyTorch ops:
the hidden row is recomputed in fp32 from the saved inputs, the products
run in fp32, and only the gradients of inputs that need one are computed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gea_torch.ops import build


def lis_residual_mlp_plain(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    """z (B, C); w1 (C, H); w2 (H, C); b1, slope, trans (H,); b2 (C,)."""
    dt = z.dtype
    h = z.float() @ w1.float() + b1.float()
    s = h - trans.float()
    h = torch.where(s < 0, slope.float() * s, s) + trans.float()
    out = h.to(dt).float() @ w2.float() + b2.float()
    return z + out.to(dt)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lis")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gea_lis_forward.argtypes = [p] * 8 + [i, i, i, i, p]
    lib.gea_lis_forward.restype = ctypes.c_int
    lib.gea_lis_smem_bytes.argtypes = [i, i, i]
    lib.gea_lis_smem_bytes.restype = ctypes.c_longlong
    return lib


@torch.library.custom_op("gea_torch::lis_residual_mlp", mutates_args=(), device_types="cpu")
def lis_op(z: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, slope: torch.Tensor,
           trans: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return lis_residual_mlp_plain(z, w1, b1, slope, trans, w2, b2).contiguous()


@lis_op.register_fake
def _(z, w1, b1, slope, trans, w2, b2):
    return z.new_empty(z.shape)


@lis_op.register_kernel("cuda")
def _launch(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    build.check_cuda_inputs("lis_residual_mlp", z, w1, b1, slope, trans, w2, b2)
    dt = z.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lis_residual_mlp: unsupported dtype {dt}")
    batch, code = z.shape
    hidden = w1.shape[1]
    if w1.shape != (code, hidden) or w2.shape != (hidden, code):
        raise ValueError(
            f"lis_residual_mlp: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
            f"do not fit z {tuple(z.shape)}"
        )
    bf16 = dt == torch.bfloat16
    if bf16 and (code % 8 or hidden % 16):
        raise ValueError(
            f"lis_residual_mlp: the bf16 kernel takes code divisible by 8 and "
            f"hidden by 16; got code={code}, hidden={hidden}"
        )
    lib = _lib()
    if lib.gea_lis_smem_bytes(code, hidden, int(bf16)) > build.SMEM_LIMIT:
        raise ValueError(f"lis_residual_mlp: code+hidden={code + hidden} too wide")
    z = build.aligned16(z.contiguous())
    out = torch.empty_like(z)
    if batch == 0:
        return out
    # The kernel copies every operand in 16-byte pieces.
    w1, w2 = (build.aligned16(w.to(dt).contiguous()) for w in (w1, w2))
    f32 = [build.aligned16(v.float().contiguous()) for v in (b1, slope, trans, b2)]
    with torch.cuda.device(z.device):
        rc = lib.gea_lis_forward(
            z.data_ptr(), w1.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
            f32[2].data_ptr(), w2.data_ptr(), f32[3].data_ptr(), out.data_ptr(),
            batch, code, hidden, int(bf16),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    build.check(lib, rc, "lis_residual_mlp")
    lis_residual_mlp.launches += 1
    return out


def _forward(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    return lis_op(z, w1, b1, slope, trans, w2, b2)


class LISResidualMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w1, b1, slope, trans, w2, b2):
        ctx.save_for_backward(z, w1, b1, slope, trans, w2)
        return _forward(z, w1, b1, slope, trans, w2, b2)

    @staticmethod
    def backward(ctx, g):
        """The gradients that `ctx.needs_input_grad` asks for, None for the
        others: a frozen link (R-separate's G) pays for dz alone."""
        z, w1, b1, slope, trans, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        gf, zf, w1f = g.float(), z.float(), w1.float()
        grads = [None] * 7
        if need[6]:
            grads[6] = gf.sum(0)
        if not any(need[:6]):
            return tuple(grads)
        s = zf @ w1f + b1.float() - trans.float()
        neg = s < 0
        a = slope.float()
        if need[5]:
            h = torch.where(neg, a * s, s) + trans.float()
            grads[5] = (h.t() @ gf).to(w2.dtype)
        if not any(need[:5]):
            return tuple(grads)
        dh = gf @ w2.float().t()
        fprime = torch.where(neg, a, torch.ones_like(s))
        dh_pre = dh * fprime
        if need[0]:
            grads[0] = (gf + dh_pre @ w1f.t()).to(z.dtype)
        if need[1]:
            grads[1] = (zf.t() @ dh_pre).to(w1.dtype)
        if need[2]:
            grads[2] = dh_pre.sum(0)
        if need[3]:
            grads[3] = torch.where(neg, dh * s, torch.zeros_like(s)).sum(0)
        if need[4]:
            grads[4] = (dh * (1 - fprime)).sum(0)
        return tuple(grads)


def lis_residual_mlp(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    """One LIS link; differentiable."""
    return LISResidualMLP.apply(z, w1, b1, slope, trans, w2, b2)


lis_residual_mlp.launches = 0
