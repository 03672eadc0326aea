"""One LIS link, `z + W2 @ tprelu(W1 @ z + b1) + b2`, as one CUDA kernel
(`gea_torch/csrc/lis.cu`), and the backward of a chain of links as
another (`gea_torch/csrc/lis_bwd.cu`).

Replaces `gea/ops/pallas/lis.py::lis_residual_mlp`. Same arguments and the
same rounding: both products accumulate in fp32, the TPReLU runs in fp32,
the hidden row is cast to z's dtype before the second product, and that
product (plus b2) is cast to z's dtype before the residual add.

The link is bound by launch latency (0.1 us of bytes at the flagship shape).
Both kernels run as thread block clusters whose blocks share a tile of
rows: each block computes a slice of the hidden columns and of the output
columns, and the blocks exchange their hidden slices through distributed
shared memory, so no SM reads a weight whole. The bf16 kernel runs on the
tensor cores (mma.sync), clusters of 8 on 16 rows; the fp32 kernel on the
FFMA pipe, clusters of 16 or 8 on 8 or 16 rows with its weight slices
streamed through a ring, as the host plan `forward_plan` lays it out, each
output one fmaf chain in k order (the same bits whatever the plan or the
batch).

The kernel is the custom op `gea_torch::lis_residual_mlp` (`torch.library`),
so `torch.export` records it as one node of an exported graph: its CPU
implementation is the plain version, its CUDA one launches the kernel (and
counts the launch in `lis_residual_mlp.launches`) or raises, and its fake
implementation gives the output's shape and dtype to the tracer.

The backward, that of `gea/ops/pallas/lis.py::_bwd` (the gradients of z,
w1, b1, slope, trans, w2 and b2) taken link after link down a chain, is
the custom op `gea_torch::lis_chain_backward`: one call for the cotangents
of every output of a chain z_{j+1} = link_j(z_j), one launch of the chain
kernel (and one of a fixed-order reduce where weights or sums are asked
for), laid out by the host plan `backward_plan`. `lis_chain_backward_plain`
is its plain version: `lis_residual_mlp_backward_plain` from the last link
down, each link's cotangent g + dz of the link above added in z's dtype.
The generator's links run as `LISChain` (`lis_chain`) where gradients are
recorded, whose backward is that call; a link alone (`LISResidualMLP`) has
`gea_torch::lis_residual_mlp_backward`, the chain kernel on a chain of
one. Both recompute the hidden row from the saved inputs, pre exactly
(fp64 products and sums, rounded once to fp32, as the plain version
computes it, so that both put each TPReLU input on the same side of 0),
and compute only the gradients asked for (a frozen link asks for dz
alone). The gradient is not differentiable again (no path needs it): a
second derivative raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
    lib.gea_lis_forward.argtypes = [p] * 8 + [i, i, i, i, ctypes.POINTER(i), p]
    lib.gea_lis_forward.restype = ctypes.c_int
    lib.gea_lis_smem_bytes.argtypes = [i] * 6
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
    if not bf16 and (code % 4 or hidden % 4):
        raise ValueError(
            f"lis_residual_mlp: the fp32 kernel takes code and hidden divisible by 4; "
            f"got code={code}, hidden={hidden}"
        )
    plan = forward_plan(batch, code, hidden, bf16, _sm_count(z.device.index or 0))
    if plan.config is None:
        raise ValueError(f"lis_residual_mlp: code+hidden={code + hidden} too wide")
    lib = _lib()
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
            batch, code, hidden, int(bf16), (ctypes.c_int * 5)(*plan.dims()),
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


def lis_chain_backward_plain(zs, w1s, b1s, slopes, transes, w2s, gs, needs) -> list:
    """The gradients of a chain of `lis_residual_mlp` links, z_{j+1} =
    link_j(z_j), for the cotangents gs[j] of the outputs z_{j+1}: per link
    [dz, dw1, db1, dslope, dtrans, dw2, db2], None where `needs[j]` is False
    and for every link's dz but the first's (the others flow down the
    chain). `zs[j]` is link j's input; `needs[j][0]`, for j > 0, is whether
    any link below asks for anything (`check_chain_needs`). Composes
    `lis_residual_mlp_backward_plain` from the last link down, each on its
    total cotangent G = g (the last link) or g + dz of the link above, added
    in z's dtype as the autograd engine adds the two."""
    check_chain_needs(needs)
    dt = zs[0].dtype
    out = [[None] * _GRADS for _ in zs]
    for j in range(len(zs) - 1, -1, -1):
        if not any(needs[j]):  # nor does any link below
            break
        cot = gs[j].to(dt) if j == len(zs) - 1 else gs[j].to(dt) + dz
        grads = lis_residual_mlp_backward_plain(zs[j], w1s[j], b1s[j], slopes[j], transes[j],
                                                w2s[j], cot, needs[j])
        dz = grads[0]
        out[j] = [None] + list(grads[1:]) if j else list(grads)
    return out


def check_chain_needs(needs) -> None:
    """Each link's seven flags (dz, dw1, db1, dslope, dtrans, dw2, db2);
    for j > 0, dz is the cotangent link j hands down, asked for exactly
    when a link below asks for any gradient."""
    below = False
    for j, need in enumerate(needs):
        if len(need) != _GRADS:
            raise ValueError(f"link {j}: need has {len(need)} flags, not {_GRADS}")
        if j and bool(need[0]) != below:
            raise ValueError(f"link {j}: need[0] is {bool(need[0])}, but the links below "
                             f"{'ask' if below else 'do not ask'} for gradients")
        below = below or any(need)


# ------------------------------------------------------------ the forward's plan

FWD_THREADS = 256  # threads of a block of the fp32 kernel
FWD_CHUNK = 64  # weight k-rows a ring slot holds
FWD_SLOTS = 32  # ring slots at most (one mbarrier each, 8 bytes)
FWD_TILES = ((1, 1), (1, 2), (2, 2), (2, 4))  # a thread's outputs, rows x columns
FWD_CLUSTERS = (16, 8)
FWD_ROWS = (8, 16)
BF16_ROWS, BF16_CLUSTER = 16, 8  # the bf16 kernel's (`lis.cu`: kRows, kCluster)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def bf16_slices(code: int, hidden: int) -> tuple:
    """(wh, wo): the hidden and output columns of a block of the bf16
    kernel, an eighth of each rounded up to whole 16-byte pieces."""
    return _up(_cdiv(hidden, BF16_CLUSTER), 8), _up(_cdiv(code, BF16_CLUSTER), 8)


def bf16_smem_bytes(code: int, hidden: int) -> int:
    """Shared memory of a block of the bf16 kernel (`ClusterLayout`)."""
    kz, rows = _up(code, 16), BF16_ROWS
    wh, wo = bf16_slices(code, hidden)
    elems = (rows * (kz + 8) + kz * (wh + 8) + hidden * (wo + 8) + rows * (wh + 8)
             + rows * (hidden + 8) + 2 * (3 * wh + wo))
    return 2 * elems


def f32_slices(code: int, hidden: int, cluster: int) -> tuple:
    """(wh, wo): the hidden and output columns of a block of the fp32
    kernel, its cluster's share rounded up to whole 16-byte pieces."""
    return _up(_cdiv(hidden, cluster), 4), _up(_cdiv(code, cluster), 4)


def f32_smem_bytes(code: int, hidden: int, rows: int, cluster: int, depth: int) -> int:
    """Shared memory of a block of the fp32 kernel (`F32Layout`): 128 bytes
    to align its base, the ring's mbarriers, z's rows in chunks of
    FWD_CHUNK columns, `depth` ring slots of FWD_CHUNK k-rows of the wider
    slice, the full hidden rows (padded by 4 floats), the block's slice of
    them and the vector slices."""
    wh, wo = f32_slices(code, hidden, cluster)
    floats = (_cdiv(code, FWD_CHUNK) * rows * FWD_CHUNK + depth * FWD_CHUNK * max(wh, wo)
              + rows * (hidden + 4) + rows * wh + 3 * wh + wo)
    return 128 + 8 * FWD_SLOTS + 4 * floats


def thread_tile(rows: int, w: int) -> tuple:
    """(rows, columns) of the outputs a thread of the fp32 kernel holds for
    a layer of rows x w outputs (`tile_size` in `lis.cu`): the first tile of
    FWD_TILES whose tiles the block's threads cover."""
    return next((t for t in FWD_TILES if rows * w <= t[0] * t[1] * FWD_THREADS), FWD_TILES[-1])


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """How one launch of the LIS forward (`csrc/lis.cu`) is cut: the batch
    into tiles of `rows` rows, one thread block cluster of `cluster` blocks
    a tile; block `rank` of a cluster computes hidden columns [rank wh,
    +wh) and output columns [rank wo, +wo). bf16: the kernel's fixed 16
    rows on clusters of 8. fp32: clusters of 16 where each block still gets
    at least 8 columns of the narrower width, else 8; 8 rows a tile while
    the clusters' blocks fit `sms` SMs, else 16; the ring as deep as the
    chunks where shared memory holds them (all copies in flight at once),
    else the deepest ring that fits (of 2 slots or more where one does). A
    pure function of its fields; the launch takes its grid and shared bytes
    from `dims` and refuses any other shared size."""

    batch: int
    code: int
    hidden: int
    bf16: bool
    sms: int = 132

    @property
    def chunks(self) -> int:
        """Ring chunks: W1's k-rows (code), then W2's (hidden)."""
        return _cdiv(self.code, FWD_CHUNK) + _cdiv(self.hidden, FWD_CHUNK)

    @functools.cached_property
    def config(self):
        """(rows, cluster, ring depth), or None if no layout fits."""
        if self.bf16:
            fits = bf16_smem_bytes(self.code, self.hidden) <= build.SMEM_LIMIT
            return (BF16_ROWS, BF16_CLUSTER, 0) if fits else None
        clusters = FWD_CLUSTERS if min(self.code, self.hidden) >= 8 * FWD_CLUSTERS[0] else (
            FWD_CLUSTERS[::-1])
        most = FWD_TILES[-1][0] * FWD_TILES[-1][1] * FWD_THREADS
        for least in (2, 1):  # a ring of one slot only where no deeper one fits
            for cluster in clusters:
                few = _cdiv(self.batch, FWD_ROWS[0]) * cluster <= self.sms
                for rows in (FWD_ROWS if few else FWD_ROWS[::-1]):
                    if rows * max(f32_slices(self.code, self.hidden, cluster)) > most:
                        continue
                    for depth in range(min(self.chunks, FWD_SLOTS), least - 1, -1):
                        if f32_smem_bytes(self.code, self.hidden, rows, cluster,
                                          depth) <= build.SMEM_LIMIT:
                            return rows, cluster, depth
        return None

    @property
    def rows(self) -> int:
        return self.config[0]

    @property
    def cluster(self) -> int:
        return self.config[1]

    @property
    def depth(self) -> int:
        return self.config[2]

    @property
    def blocks(self) -> int:
        return _cdiv(self.batch, self.rows) * self.cluster

    @property
    def smem_bytes(self) -> int:
        if self.bf16:
            return bf16_smem_bytes(self.code, self.hidden)
        return f32_smem_bytes(self.code, self.hidden, self.rows, self.cluster, self.depth)

    def slices(self) -> tuple:
        """(wh, wo) of a block."""
        if self.bf16:
            return bf16_slices(self.code, self.hidden)
        return f32_slices(self.code, self.hidden, self.cluster)

    def blocks_layout(self) -> list:
        """(rows, hidden columns, output columns) each block computes, in
        launch order (block b: tile b // cluster, rank b % cluster)."""
        wh, wo = self.slices()
        out = []
        for b in range(self.blocks):
            tile, rank = divmod(b, self.cluster)
            r0 = tile * self.rows
            out.append((range(r0, min(self.batch, r0 + self.rows)),
                        range(min(self.hidden, rank * wh), min(self.hidden, (rank + 1) * wh)),
                        range(min(self.code, rank * wo), min(self.code, (rank + 1) * wo))))
        return out

    def dims(self) -> list:
        """The launch's `plan`: rows, cluster, ring depth, blocks, shared
        bytes."""
        rows, cluster, depth = self.config
        return [rows, cluster, depth, self.blocks, self.smem_bytes]


@functools.lru_cache(maxsize=256)
def forward_plan(batch: int, code: int, hidden: int, bf16: bool, sms: int = 132) -> ForwardPlan:
    return ForwardPlan(batch, code, hidden, bool(bf16), sms)


# ----------------------------------------------------------- the backward's plan

CHAIN_ROWS = 16  # rows of a row group: one cluster walks them down the chain
MAX_LINKS = 8
CLUSTERS = (16, 8)  # cluster sizes, by preference
DEPTHS = (4, 3, 2, 1)  # ring slots, by preference
_REDUCE_ELEMS = 1024  # elements a block of the reduce takes per pass (256 threads x 4)
SMEM_LIMIT = build.SMEM_LIMIT - 1024  # a block's dynamic shared memory: the links' copy aside


def chain_smem_bytes(code: int, hidden: int, links: int, cluster: int, depth: int,
                     esize: int) -> int:
    """Shared memory of a block of the chain kernel (`Layout` in
    `csrc/lis_bwd.cu`, which the check script holds this to)."""
    kz, wh, wo = _up(code, 16), _up(_cdiv(hidden, cluster), 16), _up(_cdiv(code, cluster), 16)
    ld_z, ld_h, ld_o, ld_f = kz, wh + 8, wo + 8, cluster * wh
    w1c_rows = _up(kz, min(kz, 256))
    zb, vb = _up(CHAIN_ROWS * ld_z * esize, 16), _up(3 * wh * 4, 16)
    p_item = _up(zb, 128) + _up(w1c_rows * wh * esize, 16) + vb
    w_item = (zb + _up(wh * ld_z * esize, 16) + _up(wo * ld_f * esize, 16)
              + _up(CHAIN_ROWS * ld_o * esize, 16) + vb)
    rest = (2 * _up(cluster * CHAIN_ROWS * ld_o * esize, 16)
            + _up(cluster * CHAIN_ROWS * ld_h * esize, 16)
            + _up(CHAIN_ROWS * ld_o * esize, 16) + _up(CHAIN_ROWS * ld_h * esize, 16)
            + links * _up(CHAIN_ROWS * ld_h * esize, 16) + links * _up(CHAIN_ROWS * wh * 4, 16)
            + _up(CHAIN_ROWS * wh * 4, 16) + 8 * max(wh, wo) // 16 * 1024
            + 8 * 16 * (16 * 4 + 16) + 8 * 8)
    return depth * _up(max(p_item, w_item), 128) + rest


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """How one call of the chain kernel (`csrc/lis_bwd.cu`) is cut: the
    batch into row groups of CHAIN_ROWS rows, one cluster each; the cluster
    size and the ring's depth that fit shared memory (all row groups
    resident at once where a cluster size allows it, by `resident`: the
    clusters of each size the card holds at once); the fp32 slots of every
    partial sum (row group by row group), and the reduce's jobs. A pure
    function of its fields."""

    batch: int
    code: int
    hidden: int
    bf16: bool
    needs: tuple
    sms: int
    resident: tuple = ()  # ((cluster size, clusters resident at once), ...)

    @property
    def links(self) -> int:
        return len(self.needs)

    @property
    def groups(self) -> int:
        return _cdiv(self.batch, CHAIN_ROWS)

    @property
    def first(self) -> int:
        """The lowest link asked for anything (the walk ends there)."""
        return next(j for j, n in enumerate(self.needs) if any(n))

    def row_groups(self) -> list:
        """(first row, rows) of each row group, cluster by cluster."""
        return [(r * CHAIN_ROWS, min(CHAIN_ROWS, self.batch - r * CHAIN_ROWS))
                for r in range(self.groups)]

    @property
    def config(self):
        """(cluster, ring depth) or None if no cluster fits."""
        esize = 2 if self.bf16 else 4
        options = [(c, d) for d in DEPTHS for c in CLUSTERS]
        fit = [o for o in options if chain_smem_bytes(
            self.code, self.hidden, self.links, o[0], o[1], esize) <= SMEM_LIMIT]
        held = dict(self.resident)
        resident = [o for o in fit if self.groups <= held.get(o[0], 0)]
        return (resident or fit or [None])[0]

    @property
    def smem_bytes(self) -> int:
        cluster, depth = self.config
        return chain_smem_bytes(self.code, self.hidden, self.links, cluster, depth,
                                2 if self.bf16 else 4)

    def sizes(self) -> tuple:
        """Elements of a row group's slot of each slotted gradient (dw1,
        db1, dslope, dtrans, dw2, db2)."""
        c, h = self.code, self.hidden
        return (c * h, h, h, h, h * c, c)

    def slots(self) -> dict:
        """{(link, gradient 0-5 of dw1..db2): fp32 offset of its row groups'
        slots, one after another} for every slotted gradient asked for."""
        out, at = {}, 0
        for j, need in enumerate(self.needs):
            for k, n in enumerate(self.sizes()):
                if need[1 + k]:
                    out[(j, k)] = at
                    at += self.groups * n
        return out

    @property
    def part_floats(self) -> int:
        return sum(self.groups * self.sizes()[k] for _, k in self.slots())

    @property
    def reduce_blocks(self) -> int:
        """Blocks of the reduce per job: enough to fill the card."""
        jobs = len(self.slots())
        if not jobs:
            return 0
        most = max(self.sizes()[k] for _, k in self.slots())
        return max(1, min(_cdiv(most, _REDUCE_ELEMS), _cdiv(2 * self.sms, jobs)))

    def launches(self) -> list:
        """The kernels one call launches, in order."""
        out = ["lis_chain_kernel<bf16>" if self.bf16 else "lis_chain_kernel<float>"]
        return out + (["lis_chain_reduce"] if self.slots() else [])

    def dims(self, f32_weights) -> list:
        """The kernel's `dim` (`gea_lis_chain_backward`); f32_weights[j]:
        link j's (dW1 in fp32, dW2 in fp32)."""
        cluster, depth = self.config
        out = [self.links, self.first, self.batch, self.code, self.hidden, int(self.bf16),
               cluster, depth, self.groups, self.reduce_blocks]
        slots = self.slots()
        for j, need in enumerate(self.needs):
            out += [sum(1 << i for i, n in enumerate(need) if n), *map(int, f32_weights[j])]
            out += [slots.get((j, k), -1) for k in range(_GRADS - 1)]
        return out


def backward_plan(batch: int, code: int, hidden: int, bf16: bool, needs, sms: int,
                  resident=()) -> ChainPlan:
    needs = tuple(tuple(bool(n) for n in need) for need in needs)
    check_chain_needs(needs)
    return ChainPlan(batch, code, hidden, bool(bf16), needs, sms,
                     tuple(sorted(dict(resident).items())))


# ------------------------------------------------------------------ the ops

@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("lis_bwd")
    lib.gea_lis_chain_backward.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                           ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.gea_lis_chain_backward.restype = ctypes.c_int
    lib.gea_lis_chain_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.gea_lis_chain_smem_bytes.restype = ctypes.c_int
    lib.gea_lis_chain_max_clusters.argtypes = [ctypes.c_int] * 2
    lib.gea_lis_chain_max_clusters.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def resident_clusters(index: int, bf16: bool) -> tuple:
    """((cluster size, clusters of the chain kernel the card holds at
    once), ...), each block taking a whole SM's shared memory."""
    lib = _bwd_lib()
    out = []
    with torch.cuda.device(index):
        for cluster in CLUSTERS:
            n = lib.gea_lis_chain_max_clusters(cluster, int(bf16))
            if n < 0:
                build.check(lib, -n, "lis_chain_backward (occupancy)")
            out.append((cluster, n))
    return tuple(out)


def _grad_likes(z, w1, b1, slope, trans, w2) -> tuple:
    """Each gradient's dtype and shape, by the input it is like: db2 is
    fp32 (float64 for float64 z) of b2's shape, (code,)."""
    return (z, w1, b1, slope, trans, w2,
            z.new_empty(z.shape[1], dtype=torch.promote_types(z.dtype, torch.float32)))


def _chain_likes(zs, w1s, b1s, slopes, transes, w2s) -> list:
    return [_grad_likes(*link) for link in zip(zs, w1s, b1s, slopes, transes, w2s)]


def _flat_needs(needs, links: int) -> list:
    if len(needs) != _GRADS * links:
        raise ValueError(f"need has {len(needs)} flags, not {_GRADS} for each of {links} links")
    return [tuple(needs[_GRADS * j:_GRADS * (j + 1)]) for j in range(links)]


def _launch_chain(what, zs, w1s, b1s, slopes, transes, w2s, gs, needs) -> tuple:
    """The chain kernel's launch for CUDA tensors: (per link the seven
    gradients, empty where not asked for (and for every dz but the first
    link's), whether it launched)."""
    n = len(zs)
    if not 1 <= n <= MAX_LINKS or not n == len(w1s) == len(b1s) == len(slopes) == len(
            transes) == len(w2s) == len(gs):
        raise ValueError(f"{what}: {n} links (1 to {MAX_LINKS}, each with all its inputs)")
    build.check_cuda_inputs(what, *zs, *w1s, *b1s, *slopes, *transes, *w2s, *gs)
    check_chain_needs(needs)
    dt = zs[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: unsupported dtype {dt}")
    batch, code = zs[0].shape
    hidden = w1s[0].shape[1]
    for z, w1, w2, g in zip(zs, w1s, w2s, gs):
        if (z.dtype != dt or z.shape != (batch, code) or w1.shape != (code, hidden)
                or w2.shape != (hidden, code) or g.shape != z.shape):
            raise ValueError(f"{what}: z {tuple(z.shape)} {z.dtype} / w1 {tuple(w1.shape)} / w2 "
                             f"{tuple(w2.shape)} / g {tuple(g.shape)} do not fit a chain on z "
                             f"{(batch, code)} {dt}")
    bf16 = dt == torch.bfloat16
    piece = 8 if bf16 else 4  # elements of a 16-byte copy
    if code % piece or hidden % piece:
        raise ValueError(f"{what}: the {'bf16' if bf16 else 'fp32'} kernel takes code and "
                         f"hidden divisible by {piece}; got code={code}, hidden={hidden}")
    dev = zs[0].device
    likes = _chain_likes(zs, w1s, b1s, slopes, transes, w2s)
    grads = [[torch.empty(x.shape if need[i] and (i or not j) else (0,), dtype=x.dtype,
                          device=dev) for i, x in enumerate(like)]
             for j, (like, need) in enumerate(zip(likes, needs))]
    if batch == 0 or not any(map(any, needs)):  # no launch; the sums of nothing are zero
        return [[d.zero_() for d in link] for link in grads], False
    plan = backward_plan(batch, code, hidden, bf16, needs, _sm_count(dev.index or 0),
                         resident_clusters(dev.index or 0, bf16))
    if plan.config is None:
        raise ValueError(f"{what}: code={code}, hidden={hidden} over {n} links too wide for "
                         f"shared memory")
    # What the kernels write: dz in z's dtype, dw1 and dw2 in bf16 or fp32,
    # the sums in fp32; another dtype goes through a copy.
    outs = []
    for link in grads:
        kinds = [dt if i == 0 else d.dtype if i in (1, 5) and d.dtype in (torch.bfloat16,
                                                                           torch.float32)
                 else torch.float32 for i, d in enumerate(link)]
        outs.append([d if d.dtype == k else torch.empty_like(d, dtype=k)
                     for d, k in zip(link, kinds)])
    # The kernel copies every operand in 16-byte pieces.
    ins = []
    for z, w1, b1, slope, trans, w2, g in zip(zs, w1s, b1s, slopes, transes, w2s, gs):
        z, w1, w2, g = (build.aligned16(t.to(dt).contiguous()) for t in (z, w1, w2, g))
        b1, slope, trans = (build.aligned16(v.float().contiguous()) for v in (b1, slope, trans))
        ins += [z, w1, b1, slope, trans, w2, g]
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in ins]
    for j, (link, need) in enumerate(zip(outs, needs)):
        ptrs += [d.data_ptr() if need[i] else 0 for i, d in enumerate(link) if i]
    ptrs += [outs[0][0].data_ptr() if needs[0][0] else 0, part.data_ptr()]
    dims = plan.dims([(o[1].dtype == torch.float32, o[5].dtype == torch.float32) for o in outs])
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        rc = lib.gea_lis_chain_backward((ctypes.c_uint64 * len(ptrs))(*ptrs),
                                        (ctypes.c_longlong * len(dims))(*dims),
                                        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, what)
    for link, out in zip(grads, outs):
        for d, o in zip(link, out):
            if o is not d:
                d.copy_(o)
    return grads, True


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


@lis_backward_op.register_fake
def _(z, w1, b1, slope, trans, w2, g, need):
    return tuple(x.new_empty(x.shape if n else (0,))
                 for x, n in zip(_grad_likes(z, w1, b1, slope, trans, w2), need))


@lis_backward_op.register_kernel("cuda")
def _launch_backward(z, w1, b1, slope, trans, w2, g, need):
    """One link: the chain kernel on a chain of one."""
    what = "lis_residual_mlp_backward"
    if len(need) != _GRADS:
        raise ValueError(f"{what}: need has {len(need)} flags, not {_GRADS}")
    (grads,), launched = _launch_chain(what, [z], [w1], [b1], [slope], [trans], [w2], [g],
                                       [tuple(need)])
    lis_residual_mlp_backward.launches += launched
    return tuple(grads)


def lis_residual_mlp_backward(z, w1, b1, slope, trans, w2, g, need=(True,) * _GRADS) -> tuple:
    """The gradients of `lis_residual_mlp` for the cotangent g: (dz, dw1,
    db1, dslope, dtrans, dw2, db2), None where `need` is False. The kernel
    on CUDA tensors, the plain version on CPU ones."""
    grads = lis_backward_op(z, w1, b1, slope, trans, w2, g, [bool(n) for n in need])
    return tuple(d if n else None for d, n in zip(grads, need))


@torch.library.custom_op("gea_torch::lis_chain_backward", mutates_args=(), device_types="cpu")
def lis_chain_op(
    zs: list[torch.Tensor], w1s: list[torch.Tensor], b1s: list[torch.Tensor],
    slopes: list[torch.Tensor], transes: list[torch.Tensor], w2s: list[torch.Tensor],
    gs: list[torch.Tensor], need: list[bool],
) -> list[torch.Tensor]:
    """The op on the CPU: the plain version; per link its seven gradients
    in order, empty where not asked for (and every dz but the first
    link's). `need` holds each link's seven flags in turn."""
    needs = _flat_needs(need, len(zs))
    grads = lis_chain_backward_plain(zs, w1s, b1s, slopes, transes, w2s, gs, needs)
    likes = _chain_likes(zs, w1s, b1s, slopes, transes, w2s)
    return [d.contiguous() if d is not None else x.new_empty(0)
            for link, like in zip(grads, likes) for d, x in zip(link, like)]


@lis_chain_op.register_fake
def _(zs, w1s, b1s, slopes, transes, w2s, gs, need):
    needs = _flat_needs(need, len(zs))
    return [x.new_empty(x.shape if n[i] and (i or not j) else (0,))
            for j, (like, n) in enumerate(zip(_chain_likes(zs, w1s, b1s, slopes, transes, w2s),
                                               needs))
            for i, x in enumerate(like)]


@lis_chain_op.register_kernel("cuda")
def _launch_chain_backward(zs, w1s, b1s, slopes, transes, w2s, gs, need):
    needs = _flat_needs(need, len(zs))
    grads, launched = _launch_chain("lis_chain_backward", zs, w1s, b1s, slopes, transes, w2s,
                                    gs, needs)
    lis_chain_backward.launches += launched
    return [d for link in grads for d in link]


def lis_chain_backward(zs, w1s, b1s, slopes, transes, w2s, gs, needs) -> list:
    """The gradients of a chain of links (`lis_chain_backward_plain`'s
    arguments and result): the chain kernel on CUDA tensors, the plain
    version on CPU ones."""
    flat = lis_chain_op(list(zs), list(w1s), list(b1s), list(slopes), list(transes), list(w2s),
                        list(gs), [bool(n) for need in needs for n in need])
    return [[d if n and (i or not j) else None for i, (d, n) in enumerate(
        zip(flat[_GRADS * j:_GRADS * (j + 1)], need))] for j, need in enumerate(needs)]


def _backward(z, w1, b1, slope, trans, w2, g, need) -> tuple:
    return lis_residual_mlp_backward(z, w1, b1, slope, trans, w2, g, need)


def _chain_backward(zs, w1s, b1s, slopes, transes, w2s, gs, needs) -> list:
    return lis_chain_backward(zs, w1s, b1s, slopes, transes, w2s, gs, needs)


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


class LISChain(torch.autograd.Function):
    """A chain of links z_{j+1} = link_j(z_j) from z0, each link's (w1, b1,
    slope, trans, w2, b2) in turn: the forward one link op a link, the
    backward one call of `lis_chain_backward` for every output's cotangent
    at once."""

    @staticmethod
    def forward(ctx, z0, *links):
        n = len(links) // 6
        zs = [z0]
        for j in range(n):
            zs.append(_forward(zs[-1], *links[6 * j:6 * j + 6]))
        ctx.links = n
        ctx.save_for_backward(*zs[:-1], *(t for j in range(n) for t in links[6 * j:6 * j + 5]))
        return tuple(zs[1:])

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        """The gradients that `ctx.needs_input_grad` asks for, None for the
        others: each link's dz flag is whether anything below it asks."""
        n, saved, asked = ctx.links, ctx.saved_tensors, ctx.needs_input_grad
        w = [saved[n + 5 * j:n + 5 * j + 5] for j in range(n)]
        needs, below = [], bool(asked[0])
        for j in range(n):
            own = tuple(bool(a) for a in asked[1 + 6 * j:7 + 6 * j])
            needs.append((below, *own))
            below = below or any(own)
        grads = _chain_backward(saved[:n], *(list(x) for x in zip(*w)), gs, needs)
        return (grads[0][0], *(d for link in grads for d in link[1:]))


def lis_chain(z0, links) -> tuple:
    """The outputs (z1, ..., zN) of the links (each (w1, b1, slope, trans,
    w2, b2)) from z0; differentiable, with one backward call for the
    chain."""
    return LISChain.apply(z0, *(t for link in links for t in link))


lis_residual_mlp.launches = 0
lis_residual_mlp_backward.launches = 0
lis_chain_backward.launches = 0
