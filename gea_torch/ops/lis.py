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
backward, the one of `gea/ops/pallas/lis.py::_bwd` (the gradients of z,
w1, b1, slope, trans, w2 and b2), is a second kernel
(`gea_torch/csrc/lis_bwd.cu`, one launch a link) bound as the custom op
`gea_torch::lis_residual_mlp_backward`, with
`lis_residual_mlp_backward_plain` as its plain version. It recomputes the
hidden row from the saved inputs, pre exactly (fp64 products and sums,
rounded once to fp32, as the plain version computes it, so that both put
each TPReLU input on the same side of 0), and computes only the gradients
asked for (a frozen link asks for dz alone). The gradient is not
differentiable again (no path needs it): a second derivative raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from gea_torch.ops import build

_GRADS = 7  # z, w1, b1, slope, trans, w2, b2


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


def lis_residual_mlp_backward_plain(z, w1, b1, slope, trans, w2, g,
                                    need=(True,) * _GRADS) -> list:
    """The gradients of `lis_residual_mlp` for the cotangent g, as `gea`'s
    `_bwd` takes them: [dz, dw1, db1, dslope, dtrans, dw2, db2], None where
    `need` is False. Plain PyTorch with the kernel's rounding points: the
    weights and g in z's dtype, as the kernel takes them; pre = z @ w1
    exact (fp64 products and sums, rounded once to fp32), then + b1 and -
    trans in fp32 (float64 stays float64); h, before dw2's product, and
    dh_pre = dh * fprime, before the products of dz and dw1, rounded to z's
    dtype (in fp32 a no-op); every sum in fp32, db1 over the unrounded
    dh_pre; each gradient cast to its input's dtype (db2 stays fp32: b2 is
    not an input here, and autograd casts it to b2's)."""
    dt = z.dtype
    acc = torch.promote_types(dt, torch.float32)
    gf = g.to(dt).to(acc)
    grads = [None] * _GRADS
    if need[6]:
        grads[6] = gf.sum(0)
    if not any(need[:6]):
        return grads
    w1r = w1.to(dt)
    s = (z.double() @ w1r.double()).to(acc) + b1.to(acc) - trans.to(acc)
    neg = s < 0
    a = slope.to(acc)
    if need[5]:
        h = (torch.where(neg, a * s, s) + trans.to(acc)).to(dt).to(acc)
        grads[5] = (h.t() @ gf).to(w2.dtype)
    if not any(need[:5]):
        return grads
    dh = gf @ w2.to(dt).to(acc).t()
    fprime = torch.where(neg, a, 1.0)
    dh_pre = dh * fprime
    dh_pre_r = dh_pre.to(dt).to(acc)
    if need[0]:
        grads[0] = (gf + dh_pre_r @ w1r.to(acc).t()).to(z.dtype)
    if need[1]:
        grads[1] = (z.to(acc).t() @ dh_pre_r).to(w1.dtype)
    if need[2]:
        grads[2] = dh_pre.sum(0).to(b1.dtype)
    if need[3]:
        grads[3] = torch.where(neg, dh * s, 0.0).sum(0).to(slope.dtype)
    if need[4]:
        grads[4] = (dh * (1 - fprime)).sum(0).to(trans.dtype)
    return grads


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("lis_bwd")
    lib.gea_lis_backward.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.gea_lis_backward.restype = ctypes.c_int
    lib.gea_lis_backward_rows.argtypes = [ctypes.c_int] * 3
    lib.gea_lis_backward_rows.restype = ctypes.c_int
    return lib


@torch.library.custom_op("gea_torch::lis_residual_mlp_backward", mutates_args=(),
                         device_types="cpu")
def lis_backward_op(
    z: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, slope: torch.Tensor,
    trans: torch.Tensor, w2: torch.Tensor, g: torch.Tensor, need: list[bool],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """The op on the CPU: the plain version. A custom op returns no None:
    gradients not asked for come back empty."""
    grads = lis_residual_mlp_backward_plain(z, w1, b1, slope, trans, w2, g, need)
    return tuple(d.contiguous() if d is not None else x.new_empty(0)
                 for d, x in zip(grads, _grad_likes(z, w1, b1, slope, trans, w2)))


def _grad_likes(z, w1, b1, slope, trans, w2) -> tuple:
    """Each gradient's dtype and shape, by the input it is like: db2 is
    fp32 (float64 for float64 z) of b2's shape, (code,)."""
    return (z, w1, b1, slope, trans, w2,
            z.new_empty(z.shape[1], dtype=torch.promote_types(z.dtype, torch.float32)))


@lis_backward_op.register_fake
def _(z, w1, b1, slope, trans, w2, g, need):
    return tuple(x.new_empty(x.shape if n else (0,))
                 for x, n in zip(_grad_likes(z, w1, b1, slope, trans, w2), need))


@lis_backward_op.register_kernel("cuda")
def _launch_backward(z, w1, b1, slope, trans, w2, g, need):
    what = "lis_residual_mlp_backward"
    build.check_cuda_inputs(what, z, w1, b1, slope, trans, w2, g)
    if len(need) != _GRADS:
        raise ValueError(f"{what}: need has {len(need)} flags, not {_GRADS}")
    dt = z.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {dt}")
    batch, code = z.shape
    hidden = w1.shape[1]
    if w1.shape != (code, hidden) or w2.shape != (hidden, code) or g.shape != z.shape:
        raise ValueError(f"{what}: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} / g "
                         f"{tuple(g.shape)} do not fit z {tuple(z.shape)}")
    bf16 = dt == torch.bfloat16
    piece = 8 if bf16 else 4  # elements of a 16-byte copy
    if code % piece or hidden % piece:
        raise ValueError(f"{what}: the {'bf16' if bf16 else 'fp32'} kernel takes code and "
                         f"hidden divisible by {piece}; got code={code}, hidden={hidden}")
    lib = _bwd_lib()
    rows = lib.gea_lis_backward_rows(code, hidden, int(bf16))
    if rows == 0:
        raise ValueError(f"{what}: code={code}, hidden={hidden} too wide for shared memory")
    dev = z.device
    grads = [torch.empty(x.shape if n else (0,), dtype=x.dtype, device=dev)
             for x, n in zip(_grad_likes(z, w1, b1, slope, trans, w2), need)]
    if batch == 0 or not any(need):  # no launch; the sums of nothing are zero
        return tuple(d.zero_() for d in grads)
    # What the kernel writes: dz in z's dtype, dw1 and dw2 in bf16 or fp32,
    # the sums in fp32; another dtype goes through a copy.
    kinds = [dt if i == 0 else d.dtype if i in (1, 5) and d.dtype in (torch.bfloat16,
                                                                       torch.float32)
             else torch.float32 for i, d in enumerate(grads)]
    outs = [d if d.dtype == k else torch.empty_like(d, dtype=k) for d, k in zip(grads, kinds)]
    # The kernel copies every operand in 16-byte pieces.
    z, w1, w2, g = (build.aligned16(t.to(dt).contiguous()) for t in (z, w1, w2, g))
    b1, slope, trans = (build.aligned16(v.float().contiguous()) for v in (b1, slope, trans))
    carry = torch.empty(2 * code * hidden if batch > rows and (need[1] or need[5]) else 0,
                        dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (z, w1, b1, slope, trans, w2, g, *outs, carry)]
    dims = [batch, code, hidden, int(bf16), sum(1 << i for i, n in enumerate(need) if n), rows,
            int(kinds[1] == torch.float32), int(kinds[5] == torch.float32)]
    with torch.cuda.device(dev):
        rc = lib.gea_lis_backward((ctypes.c_uint64 * len(ptrs))(*ptrs),
                                  (ctypes.c_int * len(dims))(*dims),
                                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, what)
    lis_residual_mlp_backward.launches += 1
    for d, o in zip(grads, outs):
        if o is not d:
            d.copy_(o)
    return tuple(grads)


def lis_residual_mlp_backward(z, w1, b1, slope, trans, w2, g, need=(True,) * _GRADS) -> tuple:
    """The gradients of `lis_residual_mlp` for the cotangent g: (dz, dw1,
    db1, dslope, dtrans, dw2, db2), None where `need` is False. The kernel
    on CUDA tensors, the plain version on CPU ones."""
    grads = lis_backward_op(z, w1, b1, slope, trans, w2, g, [bool(n) for n in need])
    return tuple(d if n else None for d, n in zip(grads, need))


def _backward(z, w1, b1, slope, trans, w2, g, need) -> tuple:
    return lis_residual_mlp_backward(z, w1, b1, slope, trans, w2, g, need)


class LISResidualMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, w1, b1, slope, trans, w2, b2):
        ctx.save_for_backward(z, w1, b1, slope, trans, w2)
        return _forward(z, w1, b1, slope, trans, w2, b2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        """The gradients that `ctx.needs_input_grad` asks for, None for the
        others: a frozen link (R-separate's G) pays for dz alone."""
        return _backward(*ctx.saved_tensors, g, tuple(ctx.needs_input_grad[:_GRADS]))


def lis_residual_mlp(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    """One LIS link; differentiable."""
    return LISResidualMLP.apply(z, w1, b1, slope, trans, w2, b2)


lis_residual_mlp.launches = 0
lis_residual_mlp_backward.launches = 0
