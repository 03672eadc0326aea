"""The generator's seed segment, `project -> TPReLU -> ConvTranspose(4, 2, 1)`,
as CUDA kernels (`gea_torch/csrc/seed.cu`).

Replaces `gea/ops/pallas/seed.py::fused_seed`, with the same arguments and
layouts: z (N, code); wp (code, s0*s0*c0) whose output reshapes to
(s0, s0, c0) channels fastest; bp (s0*s0*c0,); slope, trans (c0,); wc
(4, 4, c0, c1) HWIO, not flipped; bc (c1,). The output is NHWC
(N, 2*s0, 2*s0, c1) in z's dtype. Products accumulate in fp32, the TPReLU
runs in fp32 and its result is cast to z's dtype before the transposed conv.

In bf16 a call is two launches of one tensor-core kernel (wgmma fed by
TMA): the projection, whose epilogue applies bias and TPReLU and writes the
seed map (N, s0, s0, c0) into a scratch buffer allocated here, then the
transposed conv, one output parity per block, whose blocks hold whole
images so that the map is read once for all four taps and Wc is read at the
flipped taps in place. Bound: operations, 28.8 us at the flagship shape on
the H100's bf16 tensor cores. In fp32 a call is one launch on the CUDA
cores. Either way it counts as one launch in `fused_seed.launches`.

The kernels are the custom op `gea_torch::fused_seed` (`torch.library`), so
`torch.export` records a call as one node of an exported graph: its CPU
implementation is the plain version, its CUDA one launches the kernels or
raises, and its fake implementation gives the output's shape and dtype to
the tracer.

`fused_seed` is differentiable on both devices through `FusedSeed`, a
`torch.autograd.Function` whose forward is the op. Its backward is
the one of `gea/ops/pallas/seed.py::_bwd`: autograd through the plain
version recomputed from the saved inputs (cuBLAS and cuDNN on the card),
with the incoming cotangent first cast to the recomputed output's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gea_torch.ops import build

_CODES_F32 = 2  # codes per block of the fp32 kernel; kCodes in csrc/seed.cu


def fused_seed_plain(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    dt = z.dtype
    c0 = wc.shape[2]
    h = z.float() @ wp.float() + bp.float()
    s = h.view(z.shape[0], s0, s0, c0) - trans.float()
    h = (torch.where(s < 0, slope.float() * s, s) + trans.float()).to(dt)
    y = F.conv_transpose2d(
        h.float().permute(0, 3, 1, 2),
        wc.float().permute(2, 3, 0, 1),  # HWIO -> (in, out, kh, kw)
        bc.float(),
        stride=2,
        padding=1,
    )
    return y.permute(0, 2, 3, 1).to(dt).contiguous()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("seed")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gea_seed_forward.argtypes = [p] * 9 + [i, i, i, i, i, i, p]
    lib.gea_seed_forward.restype = ctypes.c_int
    return lib


@torch.library.custom_op("gea_torch::fused_seed", mutates_args=(), device_types="cpu")
def seed_op(z: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, slope: torch.Tensor,
            trans: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor, s0: int) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    return fused_seed_plain(z, wp, bp, slope, trans, wc, bc, s0)


@seed_op.register_fake
def _(z, wp, bp, slope, trans, wc, bc, s0):
    return z.new_empty((z.shape[0], 2 * s0, 2 * s0, wc.shape[3]))


@seed_op.register_kernel("cuda")
def _launch(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    build.check_cuda_inputs("fused_seed", z, wp, bp, slope, trans, wc, bc)
    dt = z.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_seed: unsupported dtype {dt}")
    batch, code = z.shape
    c0, c1 = wc.shape[2], wc.shape[3]
    if wp.shape != (code, s0 * s0 * c0) or wc.shape != (4, 4, c0, c1):
        raise ValueError(
            f"fused_seed: wp {tuple(wp.shape)} / wc {tuple(wc.shape)} do not "
            f"fit z {tuple(z.shape)} at s0={s0}"
        )
    bf16 = dt == torch.bfloat16
    if not 4 <= s0 <= 7:
        raise ValueError(f"fused_seed: the kernel takes 4 <= s0 <= 7; got s0={s0}")
    if bf16 and (code % 8 or c0 % 8 or c1 % 8):
        raise ValueError(
            f"fused_seed: the bf16 kernel takes code, c0, c1 divisible by 8; got "
            f"code={code}, c0={c0}, c1={c1}"
        )
    if not bf16 and (code % 4 or c0 % 4):
        raise ValueError(
            f"fused_seed: the fp32 kernel takes code, c0 divisible by 4; got "
            f"code={code}, c0={c0}"
        )
    if not bf16 and 4 * _CODES_F32 * (code + (s0 + 2) ** 2 * c0) > build.SMEM_LIMIT:
        raise ValueError(f"fused_seed: the fp32 seed map of c0={c0} does not fit shared memory")
    out = torch.empty((batch, 2 * s0, 2 * s0, c1), dtype=dt, device=z.device)
    if batch == 0:
        return out
    # The bf16 kernel's tensor maps need 16-byte aligned bases.
    z, wp, wc = (build.aligned16(t.to(dt).contiguous()) for t in (z, wp, wc))
    f32 = [v.float().contiguous() for v in (bp, slope, trans, bc)]
    seed_map = torch.empty((batch, s0, s0, c0) if bf16 else (0,), dtype=dt, device=z.device)
    lib = _lib()
    with torch.cuda.device(z.device):
        rc = lib.gea_seed_forward(
            z.data_ptr(), wp.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
            f32[2].data_ptr(), wc.data_ptr(), f32[3].data_ptr(), seed_map.data_ptr(),
            out.data_ptr(), batch, code, s0, c0, c1, int(bf16),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    build.check(lib, rc, "fused_seed")
    fused_seed.launches += 1
    return out


def _forward(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    return seed_op(z, wp, bp, slope, trans, wc, bc, s0)


class FusedSeed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, wp, bp, slope, trans, wc, bc, s0):
        ctx.save_for_backward(z, wp, bp, slope, trans, wc, bc)
        ctx.s0 = s0
        return _forward(z, wp, bp, slope, trans, wc, bc, s0)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[:7]) if need]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(i in want) for i, t in enumerate(saved)]
            out = fused_seed_plain(*args, ctx.s0)
            grads = torch.autograd.grad(out, [args[i] for i in want], g.to(out.dtype))
        result = [None] * 8
        for i, d in zip(want, grads):
            result[i] = d.to(saved[i].dtype)
        return tuple(result)


def fused_seed(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    """The seed segment; differentiable."""
    return FusedSeed.apply(z, wp, bp, slope, trans, wc, bc, s0)


fused_seed.launches = 0
