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
`torch.autograd.Function` whose forward is the op. Its backward, the one of
`gea/ops/pallas/seed.py::_bwd` (the gradients of z, wp, bp, slope, trans,
wc and bc, with the incoming cotangent first cast to the output's dtype),
is a second set of kernels (`gea_torch/csrc/seed_bwd.cu`) bound as the
custom op `gea_torch::fused_seed_backward`, with
`fused_seed_backward_plain` as its plain version. It recomputes the
projection (exactly: fp64 products and sums, rounded once to fp32, as the
plain versions compute it, so that both put each TPReLU input on the same
side of 0), not the transposed conv, whose output no gradient needs, and
computes only the gradients asked for (a frozen G asks for dz alone). Bound:
operations, 58.7 GFLOP or 59.4 us at the G-LIS step's shape on the bf16
tensor cores. The gradient is not differentiable again (no path needs it):
a second derivative raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gea_torch.ops import build

_CODES_F32 = 2  # codes per block of the fp32 kernel; kCodes in csrc/seed.cu
# The backward's split of its sums (csrc/seed_bwd.cu): codes a chunk of the
# ds pass's partial sums, rows of g a chunk of its column sums, and at
# least this many k-steps of 64 a split of dz's K.
_ACT_ROWS = 32
_COLSUM_ROWS = 128
_DZ_MIN_KSTEPS = 4
_GRADS = 7  # z, wp, bp, slope, trans, wc, bc


def _projection(z, wp, bp, acc) -> torch.Tensor:
    """z @ wp + bp in `acc`, the product in fp64 and rounded once: exact
    enough that the backward's kernels, which compute it the same way, and
    the plain versions put every s = pre - trans on the same side of 0 (the
    TPReLU's branch, where its derivative jumps)."""
    return (z.double() @ wp.double()).to(acc) + bp.to(acc)


def fused_seed_plain(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    """Plain PyTorch: the projection as `_projection`, the TPReLU and the
    transposed conv in fp32 (float64 stays float64), h and the output
    rounded to z's dtype."""
    dt = z.dtype
    acc = torch.promote_types(dt, torch.float32)
    c0 = wc.shape[2]
    h = _projection(z, wp, bp, acc)
    s = h.view(z.shape[0], s0, s0, c0) - trans.to(acc)
    h = (torch.where(s < 0, slope.to(acc) * s, s) + trans.to(acc)).to(dt)
    y = F.conv_transpose2d(
        h.to(acc).permute(0, 3, 1, 2),
        wc.to(acc).permute(2, 3, 0, 1),  # HWIO -> (in, out, kh, kw)
        bc.to(acc),
        stride=2,
        padding=1,
    )
    return y.permute(0, 2, 3, 1).to(dt).contiguous()


def fused_seed_backward_plain(z, wp, bp, slope, trans, wc, bc, g, s0: int,
                              need=(True,) * _GRADS) -> list:
    """The gradients of `fused_seed` for the cotangent g, as `gea`'s `_bwd`
    takes them: [dz, dwp, dbp, dslope, dtrans, dwc, dbc], None where `need`
    is False. Plain PyTorch with the kernels' roundings: the projection
    recomputed as `_projection`; g cast to z's dtype first; sums in fp32
    (float64 stays float64); dh, the transposed conv's
    data gradient, rounded to z's dtype (as autograd through
    `fused_seed_plain` rounds it), and ds, dh through the TPReLU, rounded
    too before the two projection products (in fp32 a no-op); each gradient
    cast to its input's dtype."""
    dt = z.dtype
    acc = torch.promote_types(dt, torch.float32)
    n, c0, c1 = z.shape[0], wc.shape[2], wc.shape[3]
    s = _projection(z, wp, bp, acc).view(n, s0, s0, c0) - trans.to(acc)
    neg = s < 0
    a = slope.to(acc)
    g = g.to(dt).to(acc)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))  # g[:, y, x] at gp[:, y + 1, x + 1]
    taps = [(kh, kw) for kh in range(4) for kw in range(4)]

    def window(kh, kw):  # g[:, 2i - 1 + kh, 2j - 1 + kw] for i, j < s0, zero outside
        return gp[:, kh:kh + 2 * s0:2, kw:kw + 2 * s0:2]

    grads = [None] * _GRADS
    if any(need[:5]):
        wcf = wc.to(acc)
        dh = sum(window(kh, kw) @ wcf[kh, kw].t() for kh, kw in taps).to(dt).to(acc)
        ds = torch.where(neg, a * dh, dh).to(dt).to(acc).view(n, s0 * s0 * c0)
        if need[0]:
            grads[0] = (ds @ wp.to(acc).t()).to(z.dtype)
        if need[1]:
            grads[1] = (z.to(acc).t() @ ds).to(wp.dtype)
        if need[2]:
            grads[2] = ds.sum(0).to(bp.dtype)
        if need[3]:
            grads[3] = torch.where(neg, dh * s, 0.0).sum((0, 1, 2)).to(slope.dtype)
        if need[4]:
            grads[4] = (dh * (1 - torch.where(neg, a, 1.0))).sum((0, 1, 2)).to(trans.dtype)
    if need[5]:
        h = (torch.where(neg, a * s, s) + trans.to(acc)).to(dt).to(acc)
        grads[5] = torch.stack([torch.einsum("nijc,nijd->cd", h, window(kh, kw))
                                for kh, kw in taps]).view(4, 4, c0, c1).to(wc.dtype)
    if need[6]:
        grads[6] = g.sum((0, 1, 2)).to(bc.dtype)
    return grads


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


def _check_shapes(what: str, z, wp, wc, s0: int) -> None:
    """The shapes and dtypes the kernels take; raises on any other."""
    dt = z.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {dt}")
    code = z.shape[1]
    c0, c1 = wc.shape[2], wc.shape[3]
    if wp.shape != (code, s0 * s0 * c0) or wc.shape != (4, 4, c0, c1):
        raise ValueError(
            f"{what}: wp {tuple(wp.shape)} / wc {tuple(wc.shape)} do not "
            f"fit z {tuple(z.shape)} at s0={s0}"
        )
    bf16 = dt == torch.bfloat16
    if not 4 <= s0 <= 7:
        raise ValueError(f"{what}: the kernel takes 4 <= s0 <= 7; got s0={s0}")
    if bf16 and (code % 8 or c0 % 8 or c1 % 8):
        raise ValueError(
            f"{what}: the bf16 kernel takes code, c0, c1 divisible by 8; got "
            f"code={code}, c0={c0}, c1={c1}"
        )
    if not bf16 and (code % 4 or c0 % 4):
        raise ValueError(
            f"{what}: the fp32 kernel takes code, c0 divisible by 4; got "
            f"code={code}, c0={c0}"
        )
    if not bf16 and 4 * _CODES_F32 * (code + (s0 + 2) ** 2 * c0) > build.SMEM_LIMIT:
        raise ValueError(f"{what}: the fp32 seed map of c0={c0} does not fit shared memory")


@seed_op.register_kernel("cuda")
def _launch(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    build.check_cuda_inputs("fused_seed", z, wp, bp, slope, trans, wc, bc)
    _check_shapes("fused_seed", z, wp, wc, s0)
    dt = z.dtype
    batch, code = z.shape
    c0, c1 = wc.shape[2], wc.shape[3]
    bf16 = dt == torch.bfloat16
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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("seed_bwd")
    lib.gea_seed_backward.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.gea_seed_backward.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@torch.library.custom_op("gea_torch::fused_seed_backward", mutates_args=(), device_types="cpu")
def seed_backward_op(
    z: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, slope: torch.Tensor,
    trans: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor, g: torch.Tensor, s0: int,
    need: list[bool],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """The op on the CPU: the plain version. A custom op returns no None:
    gradients not asked for come back empty."""
    grads = fused_seed_backward_plain(z, wp, bp, slope, trans, wc, bc, g, s0, need)
    inputs = (z, wp, bp, slope, trans, wc, bc)
    return tuple(d.contiguous() if d is not None else x.new_empty(0)
                 for d, x in zip(grads, inputs))


@seed_backward_op.register_fake
def _(z, wp, bp, slope, trans, wc, bc, g, s0, need):
    return tuple(x.new_empty(x.shape if n else (0,))
                 for x, n in zip((z, wp, bp, slope, trans, wc, bc), need))


@seed_backward_op.register_kernel("cuda")
def _launch_backward(z, wp, bp, slope, trans, wc, bc, g, s0: int, need):
    what = "fused_seed_backward"
    build.check_cuda_inputs(what, z, wp, bp, slope, trans, wc, bc, g)
    _check_shapes(what, z, wp, wc, s0)
    if len(need) != _GRADS:
        raise ValueError(f"{what}: need has {len(need)} flags, not {_GRADS}")
    dt = z.dtype
    batch, code = z.shape
    c0, c1 = wc.shape[2], wc.shape[3]
    if g.shape != (batch, 2 * s0, 2 * s0, c1):
        raise ValueError(f"{what}: g {tuple(g.shape)} is not the output's "
                         f"{(batch, 2 * s0, 2 * s0, c1)}")
    inputs = (z, wp, bp, slope, trans, wc, bc)
    dev = z.device
    grads = [torch.empty(x.shape if n else (0,), dtype=x.dtype, device=dev)
             for x, n in zip(inputs, need)]
    if batch == 0 or not any(need):  # no launch; the sums of nothing are zero
        return tuple(d.zero_() for d in grads)
    # What the kernels write: dz, dwp and dwc in bf16 or fp32, the sums in
    # fp32; another dtype goes through a copy.
    kinds = [d.dtype if i in (0, 1, 5) and d.dtype in (torch.bfloat16, torch.float32)
             else torch.float32 for i, d in enumerate(grads)]
    outs = [d if d.dtype == k else torch.empty_like(d, dtype=k) for d, k in zip(grads, kinds)]
    # The bf16 kernels' tensor maps need 16-byte aligned bases.
    z, wp, wc, g = (build.aligned16(t.to(dt).contiguous()) for t in (z, wp, wc, g))
    bp, slope, trans = (v.float().contiguous() for v in (bp, slope, trans))
    proj = s0 * s0 * c0
    ksteps = _cdiv(proj, 64)
    tiles = _cdiv(batch, 128) * _cdiv(code, 128)
    k_chunk = max(_DZ_MIN_KSTEPS, _cdiv(ksteps * tiles, _sm_count(dev.index or 0)))
    splits = _cdiv(ksteps, k_chunk)
    chunks = _cdiv(batch, _ACT_ROWS)

    def scratch(shape, dtype, wanted=True):
        return torch.empty(shape if wanted else (0,), dtype=dtype, device=dev)

    f32 = torch.float32
    need_dh = any(need[:5])
    bufs = [
        scratch((batch, proj), f32, need_dh or need[5]),        # s
        scratch((batch, proj), dt, need[5]),                     # h
        scratch((batch, proj), dt, need_dh),                     # dh
        scratch((batch, proj), dt, need_dh),                     # ds
        scratch((splits, batch, code), f32, need[0]),            # dz partials
        scratch((3, chunks, proj), f32, any(need[2:5])),         # ds, dslope, dtrans partials
        scratch((_cdiv(batch * 4 * s0 * s0, _COLSUM_ROWS), c1), f32, need[6]),  # dbc partials
    ]
    ptrs = [t.data_ptr() for t in (z, wp, bp, slope, trans, wc, g, *bufs, *outs)]
    dims = [batch, code, s0, c0, c1, int(dt == torch.bfloat16),
            sum(1 << i for i, n in enumerate(need) if n),
            sum(1 << i for i in (0, 1, 5) if kinds[i] == torch.bfloat16),
            k_chunk, _ACT_ROWS, _COLSUM_ROWS, splits]
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.gea_seed_backward((ctypes.c_uint64 * len(ptrs))(*ptrs),
                                   (ctypes.c_int * len(dims))(*dims),
                                   torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, what)
    fused_seed_backward.launches += 1
    for d, o in zip(grads, outs):
        if o is not d:
            d.copy_(o)
    return tuple(grads)


def fused_seed_backward(z, wp, bp, slope, trans, wc, bc, g, s0: int,
                        need=(True,) * _GRADS) -> tuple:
    """The gradients of `fused_seed` for the cotangent g: (dz, dwp, dbp,
    dslope, dtrans, dwc, dbc), None where `need` is False. The kernels on
    CUDA tensors, the plain version on CPU ones."""
    grads = seed_backward_op(z, wp, bp, slope, trans, wc, bc, g, s0, [bool(n) for n in need])
    return tuple(d if n else None for d, n in zip(grads, need))


def _forward(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    return seed_op(z, wp, bp, slope, trans, wc, bc, s0)


def _backward(z, wp, bp, slope, trans, wc, bc, g, s0: int, need) -> tuple:
    return fused_seed_backward(z, wp, bp, slope, trans, wc, bc, g, s0, need)


class FusedSeed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, wp, bp, slope, trans, wc, bc, s0):
        ctx.save_for_backward(z, wp, bp, slope, trans, wc, bc)
        ctx.s0 = s0
        return _forward(z, wp, bp, slope, trans, wc, bc, s0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        grads = _backward(*ctx.saved_tensors, g, ctx.s0, ctx.needs_input_grad[:_GRADS])
        return (*grads, None)


def fused_seed(z, wp, bp, slope, trans, wc, bc, s0: int) -> torch.Tensor:
    """The seed segment; differentiable."""
    return FusedSeed.apply(z, wp, bp, slope, trans, wc, bc, s0)


fused_seed.launches = 0
fused_seed_backward.launches = 0
