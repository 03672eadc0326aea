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
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gea_torch.ops import build

_CODES_F32 = 2  # codes per block of the fp32 kernel; kCodes in csrc/seed.cu
# The backward's split of its sums (csrc/seed_bwd.cu): rows of g a chunk of
# its column sums, and at least this many k-steps of 64 a split of dz's K.
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


# The taps by cost: the centre four (s0 x s0 pixel pairs), the eight edges,
# the corners (kTapsByCost in csrc/seed_bwd.cu).
TAPS_BY_COST = (5, 6, 9, 10, 1, 2, 4, 7, 8, 11, 13, 14, 0, 3, 12, 15)


def _tap_pairs(s0: int, tap: int) -> int:
    """The pixel pairs of h and g that tap (kh, kw) links."""
    kh, kw = divmod(tap, 4)
    return (s0 - (kh == 0) - (kh == 3)) * (s0 - (kw == 0) - (kw == 3))


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How one call of the seed's backward kernels is cut up
    (csrc/seed_bwd.cu), from the shapes, the dtype, the gradients asked
    for and the card's SM count alone, so that a launch is the same on
    every call (and capturable in a CUDA graph).

    Launches: the projection (`r_tiles` tiles of 64 x 64, then
    `colsum_blocks` blocks of g's column sums, `gchunks` chunks of
    `_COLSUM_ROWS` rows); D (bf16: `d_grid` persistent blocks over
    `d_items` tiles of `per` whole images x 128 channels; fp32: a grid of
    64 x 64 tiles), whose warps write `act_slots` slots of dslope and
    dtrans partials (8 a row tile); W (bf16: `w_grid` persistent blocks over
    `w_items` items: dWc tiles in `wc_chunks` K chunks, taps by cost, then
    dz tiles in `splits` chunks of `z_chunk` k-steps, then dwp tiles), each
    block's items in snake order; the reduce, over the `sums` sets of
    partials. `block_items`, `d_item` and `w_item` list the same items as
    the kernels' `item_of`, `d_item` and `w_item`."""

    batch: int
    code: int
    s0: int
    c0: int
    c1: int
    bf16: bool
    need: tuple
    sms: int

    TILE = 128  # the bf16 passes' output tile (kBM = kBN)
    TILE_F32 = 64  # the fp32 passes' (kFT)
    R_TILE = (64, 64)  # the projection's (kRM, kRN)
    WARPS = 8  # D's warps a tile, each with a slot of partials

    @property
    def area(self) -> int:
        return self.s0 * self.s0

    @property
    def proj(self) -> int:
        return self.area * self.c0

    @property
    def nkb(self) -> int:  # k-steps of 64 over the batch
        return _cdiv(self.batch, 64)

    @property
    def z_steps(self) -> int:
        return _cdiv(self.proj, 64)

    @property
    def need_dh(self) -> bool:
        return any(self.need[:5])

    # the projection
    @property
    def r_tiles(self) -> int:
        if not (self.need_dh or self.need[5]):
            return 0
        return _cdiv(self.batch, self.R_TILE[0]) * _cdiv(self.proj, self.R_TILE[1])

    @property
    def gchunks(self) -> int:
        return _cdiv(self.batch * 4 * self.area, _COLSUM_ROWS)

    @property
    def colsum_blocks(self) -> int:
        return _cdiv(self.c1, 128) * self.gchunks if self.need[6] else 0

    # D
    @property
    def per(self) -> int:  # whole images a bf16 tile
        return self.TILE // self.area

    @property
    def d_tiles_m(self) -> int:
        if self.bf16:
            return _cdiv(self.batch, self.per)
        return _cdiv(self.batch * self.area, self.TILE_F32)

    @property
    def d_tiles_n(self) -> int:
        return _cdiv(self.c0, self.TILE if self.bf16 else self.TILE_F32)

    @property
    def d_items(self) -> int:
        return self.d_tiles_m * self.d_tiles_n if self.need_dh else 0

    @property
    def d_grid(self) -> int:
        return min(self.sms, self.d_items) if self.bf16 else self.d_items

    @property
    def act_slots(self) -> int:
        return self.d_tiles_m * self.WARPS

    # W
    @property
    def z_chunk(self) -> int:
        """dz's k-steps a chunk: enough chunks that dz alone fills the card."""
        tiles = _cdiv(self.batch, self.TILE) * _cdiv(self.code, self.TILE)
        return max(_DZ_MIN_KSTEPS, _cdiv(self.z_steps * tiles, self.sms))

    @property
    def splits(self) -> int:
        return _cdiv(self.z_steps, self.z_chunk)

    @property
    def wc_tiles(self) -> int:  # a tap's
        return _cdiv(self.c0, self.TILE) * _cdiv(self.c1, self.TILE)

    @property
    def wc_chunks(self) -> int:
        """dWc's K chunks a tap: as many as the card holds beside the 16
        taps' tiles, no more than the corners' k-steps; 1 in fp32."""
        if not self.bf16:
            return 1
        return max(1, min(self.sms // (16 * self.wc_tiles), (self.s0 - 1) ** 2 * self.nkb))

    @property
    def n_wc(self) -> int:
        return 16 * self.wc_tiles * self.wc_chunks if self.bf16 and self.need[5] else 0

    @property
    def n_z(self) -> int:
        if not (self.bf16 and self.need[0]):
            return 0
        return _cdiv(self.batch, self.TILE) * _cdiv(self.code, self.TILE) * self.splits

    @property
    def n_wp(self) -> int:
        if not (self.bf16 and self.need[1]):
            return 0
        return _cdiv(self.code, self.TILE) * _cdiv(self.proj, self.TILE)

    @property
    def w_items(self) -> int:
        return self.n_wc + self.n_z + self.n_wp

    @property
    def w_grid(self) -> int:
        return min(self.sms, self.w_items)

    def d_item(self, i: int) -> tuple:
        """(kind, first image, first column, tap, k0, k1, slot) of D's item i."""
        m = i // self.d_tiles_n
        return ("d", m * self.per, (i % self.d_tiles_n) * self.TILE, 0, 0,
                16 * _cdiv(self.c1, 64), m)

    def w_item(self, i: int) -> tuple:
        """(kind, m0, n0, tap, k0, k1, slot) of W's item i: "wc" (slot the
        K chunk), "z" (slot the split) or "wp"."""
        t = self.TILE
        if i < self.n_wc:
            ncol = _cdiv(self.c1, t)
            per_tap = _cdiv(self.c0, t) * ncol * self.wc_chunks
            tap = TAPS_BY_COST[i // per_tap]
            tile, chunk = divmod(i % per_tap, self.wc_chunks)
            k = _tap_pairs(self.s0, tap) * self.nkb
            return ("wc", tile // ncol * t, tile % ncol * t, tap, chunk * k // self.wc_chunks,
                    (chunk + 1) * k // self.wc_chunks, chunk)
        i -= self.n_wc
        if i < self.n_z:
            ncol = _cdiv(self.code, t)
            tile, split = divmod(i, self.splits)
            k0 = split * self.z_chunk
            return ("z", tile // ncol * t, tile % ncol * t, 0, k0,
                    min(k0 + self.z_chunk, self.z_steps), split)
        i -= self.n_z
        ncol = _cdiv(self.proj, t)
        return ("wp", i // ncol * t, i % ncol * t, 0, 0, self.nkb, 0)

    def block_items(self, kernel: str, b: int) -> list:
        """The items block b of the persistent pass `kernel` ("d" or "w")
        walks, in order: b, G + b, ... (D) or b, 2G - 1 - b, 2G + b, ...
        (W, snake)."""
        total, grid = (self.d_items, self.d_grid) if kernel == "d" else (self.w_items,
                                                                         self.w_grid)
        out, j = [], 0
        while j * grid < total:
            i = j * grid + (grid - 1 - b if kernel == "w" and j % 2 else b)
            if i < total:
                out.append(i)
            j += 1
        return out

    def scratch(self) -> dict:
        """{name: (shape, "f32" or "dt")} of the buffers the launches use,
        in the kernels' order (unused ones have shape (0,))."""
        n, p = self.batch, self.proj
        need, f32 = self.need, "f32"
        bufs = {
            "s": ((n, p), f32, self.need_dh or need[5]),
            "h": ((n, p), "dt", need[5]),
            "ds": ((n, p), "dt", self.need_dh),
            "dz_part": ((self.splits, n, self.code), f32, need[0]),
            "act_part": ((2, self.act_slots, self.c0), f32, need[3] or need[4]),
            "dbc_part": ((self.gchunks, self.c1), f32, need[6]),
            "dwc_part": ((self.wc_chunks, 16, self.c0, self.c1), f32,
                         need[5] and self.wc_chunks > 1),
        }
        return {k: (shape if used else (0,), kind) for k, (shape, kind, used) in bufs.items()}

    def sums(self) -> list:
        """(gradient, partials, terms, columns) the reduce adds: each
        column of the gradient is the sum of `terms` rows of the partials."""
        need, out = self.need, []
        if need[0]:
            out.append(("dz", "dz_part", self.splits, self.batch * self.code))
        if need[2]:
            out.append(("dbp", "ds", self.batch, self.proj))
        for i, name in ((3, "dslope"), (4, "dtrans")):
            if need[i]:
                out.append((name, f"act_part[{i - 3}]", self.act_slots, self.c0))
        if need[5] and self.wc_chunks > 1:
            out.append(("dwc", "dwc_part", self.wc_chunks, 16 * self.c0 * self.c1))
        if need[6]:
            out.append(("dbc", "dbc_part", self.gchunks, self.c1))
        return out

    def launches(self) -> list:
        """The kernels one call launches, in order."""
        out = []
        if self.r_tiles + self.colsum_blocks:
            out.append("seed_bwd_project")
        if self.need_dh:
            out.append("seed_bwd_gemm<D>" if self.bf16 else "seed_bwd_f32<D>")
        if self.bf16:
            if self.w_items:
                out.append("seed_bwd_gemm<W>")
        else:
            out += [k for k, n in (("seed_bwd_f32<dz>", 0), ("seed_bwd_f32<dwp>", 1),
                                   ("seed_bwd_f32<dWc>", 5)) if self.need[n]]
        if self.sums():
            out.append("seed_bwd_reduce")
        return out

    def dims(self) -> list:
        """The plan's part of the kernels' `dim` (after need and the output
        types)."""
        return [self.z_chunk, self.splits, self.wc_chunks, _COLSUM_ROWS, self.gchunks,
                self.d_tiles_m, self.d_tiles_n, self.d_grid, self.n_wc, self.n_z, self.n_wp,
                self.w_grid, self.r_tiles, self.act_slots]


def backward_plan(batch: int, code: int, s0: int, c0: int, c1: int, bf16: bool, need,
                  sms: int) -> BackwardPlan:
    return BackwardPlan(batch, code, s0, c0, c1, bool(bf16), tuple(bool(n) for n in need), sms)


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
    plan = backward_plan(batch, code, s0, c0, c1, dt == torch.bfloat16, need,
                         _sm_count(dev.index or 0))
    bufs = [torch.empty(shape, dtype=torch.float32 if kind == "f32" else dt, device=dev)
            for shape, kind in plan.scratch().values()]
    ptrs = [t.data_ptr() for t in (z, wp, bp, slope, trans, wc, g, *bufs, *outs)]
    dims = [batch, code, s0, c0, c1, int(plan.bf16),
            sum(1 << i for i, n in enumerate(need) if n),
            sum(1 << i for i in (0, 1, 5) if kinds[i] == torch.bfloat16), *plan.dims()]
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
