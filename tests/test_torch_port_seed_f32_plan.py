"""The host-side plans of the seed kernel's fp32 instances, which run on the
register-tiled fp32 product core (`csrc/sgemm_f32.cuh`): the forward's two
passes (`gea_torch.ops.seed.forward_plan`) and the backward plan's fp32
branch (`BackwardPlan.f32_passes`, `f32_tiles`). At batches 1, 3, 64 and
256, s0 4-7, and the flagship's, config 5's and the tiny tests' widths
(and every set of gradients a path asks for), each output element is
written by exactly one block (per K chunk), the K chunks cover K, D's
dslope/dtrans slots are each written once, and every block's shared memory
fits the card with a ring at least 2 deep. The launches take these grids
and shared bytes from the plans (`csrc/seed.cu::launch_f32`,
`csrc/seed_bwd.cu::backward`), and refuse shared bytes other than the
kernels' own."""

import numpy as np
import pytest
import torch

from gea_torch.ops import build
from gea_torch.ops.seed import (
    F32_BLOCKS_PER_SM,
    F32_BK,
    F32_RING_BYTES,
    F32_STAGES,
    F32_THREADS,
    F32_TILE,
    F32_WALK_INTS,
    TAPS_BY_COST,
    _check_shapes,
    _tap_pairs,
    backward_plan,
    forward_plan,
    pad4,
    parity_pixel,
    pixel_major,
)

WIDTHS = {"flagship": (256, 512, 256), "config5": (256, 512, 512), "tiny": (16, 8, 4)}
SHAPES = [(batch, s0, width) for batch in (1, 3, 64, 256) for s0 in (4, 5, 6, 7)
          for width in WIDTHS]
NEEDS = {"every gradient": (True,) * 7, "dz alone": (True,) + (False,) * 6,
         "weights alone": (False,) + (True,) * 6}
SM_BYTES = 233472  # shared memory of one SM on Hopper (228 KB)
SMS = 132


def dims(shape):
    batch, s0, width = shape
    code, c0, c1 = WIDTHS[width]
    return batch, code, s0, c0, c1


def ids(shape):
    return f"b{shape[0]}-s0{shape[1]}-{shape[2]}"


def fits(smem: int) -> bool:
    """A block's shared memory within the card's limit, and the blocks the
    plan counts on resident together (each with its 1 KB reserve)."""
    return smem <= build.SMEM_LIMIT and F32_BLOCKS_PER_SM * (smem + 1024) <= SM_BYTES


def test_the_core_constants():
    """8 x 8 outputs a thread on a 128 x 128 tile; the ring's bytes are
    F32_STAGES k-steps of both operands' k-major tiles, k-rows padded by 4."""
    assert F32_TILE[0] * F32_TILE[1] == 64 * F32_THREADS
    assert F32_STAGES >= 2 and F32_BK in (8, 16, 32)
    assert F32_RING_BYTES == F32_STAGES * 2 * F32_BK * (F32_TILE[0] + 4) * 4
    assert F32_WALK_INTS == 2 + 16


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_forward_plan_covers_each_output_once(shape):
    batch, code, s0, c0, c1 = dims(shape)
    plan = forward_plan(batch, code, s0, c0, c1)
    passes = plan.passes()
    assert list(passes) == ["project", "conv"]
    assert passes["project"][1] == code and passes["conv"][1] == 4 * c0
    for _, _, smem in passes.values():
        assert fits(smem)

    # Pass A: every element of the seed map (batch, s0*s0*c0) once.
    proj = s0 * s0 * c0
    seen = np.zeros((batch, proj), np.uint8)
    for z, rows, cols in plan.tiles("project"):
        assert z == 0
        seen[rows.start:min(rows.stop, batch), cols.start:min(cols.stop, proj)] += 1
    assert (seen == 1).all()

    # Pass B: parity z writes out[n, 2i + du, 2j + dv, :] of its rows'
    # pixels (n, i, j), pixel-major over the padded batch in the parity's
    # order (padding rows write nothing); every output element once.
    side = 2 * s0
    assert plan.batch_p == pad4(batch) and plan.conv_rows == plan.batch_p * s0 * s0
    seen = np.zeros((batch, side, side, c1), np.uint8)
    rows_of = [[np.array(v) for v in zip(*(pixel_major(m, batch, s0, z)
                                          for m in range(plan.conv_rows)))] for z in range(4)]
    for z, rows, cols in plan.tiles("conv"):
        du, dv = z >> 1, z & 1
        n, i, j = rows_of[z]
        r = np.arange(rows.start, min(rows.stop, n.size))
        r = r[n[r] < batch]
        for c in range(cols.start, min(cols.stop, c1)):
            seen[n[r], 2 * i[r] + du, 2 * j[r] + dv, c] += 1
    assert (seen == 1).all()


def test_pixel_major_rows():
    """Row m of the fp32 convolutions is image m % pad4(batch) at pixel m //
    pad4(batch); every (n, i, j) of the padded batch once, so 4 rows from a
    multiple of 4 are 4 images of one pixel."""
    batch, s0 = 3, 4
    assert [pad4(b) for b in (1, 3, 4, 5, 64, 65)] == [4, 4, 4, 8, 64, 68]
    got = [pixel_major(m, batch, s0) for m in range(pad4(batch) * s0 * s0)]
    assert sorted(got) == [(n, i, j) for n in range(pad4(batch)) for i in range(s0)
                           for j in range(s0)]
    assert got[:5] == [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0), (0, 0, 1)]
    for m in range(0, len(got), 4):
        assert len({(i, j) for _, i, j in got[m:m + 4]}) == 1


@pytest.mark.parametrize("s0", [4, 5, 6, 7])
def test_the_conv_rows_put_the_costliest_pixels_first(s0):
    """Each output parity's order of the map's pixels (`parity_pixel`) is
    a permutation of them whose taps inside the map, 4 then 2 then 1, never
    rise along it, so the forward's row tiles start costliest first."""
    for z in range(4):
        du, dv = z >> 1, z & 1
        order = [parity_pixel(q, z, s0) for q in range(s0 * s0)]
        assert sorted(order) == [(i, j) for i in range(s0) for j in range(s0)]
        taps = [sum(0 <= i + du + a - 1 < s0 and 0 <= j + dv + b - 1 < s0
                    for a in (0, 1) for b in (0, 1)) for i, j in order]
        assert taps == [4] * (s0 - 1) ** 2 + [2] * (2 * s0 - 2) + [1]


@pytest.mark.parametrize("need", list(NEEDS))
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_the_launches_take_the_plans_grids(shape, need):
    """What the fp32 launches read from the host: the forward's batch_p and
    each pass's grid and shared bytes (`ForwardPlan.dims`), the backward's
    grid and shared bytes of D, dz, dwp and dWc after the bf16 plan's
    numbers (`BackwardPlan.dims`), zeros for a pass not launched and in
    bf16."""
    batch, code, s0, c0, c1 = dims(shape)
    fwd = forward_plan(batch, code, s0, c0, c1)
    (ga, _, sa), (gb, _, sb) = fwd.passes().values()
    assert fwd.dims() == [pad4(batch), *ga, sa, *gb, sb]
    bwd = backward_plan(batch, code, s0, c0, c1, False, NEEDS[need], SMS)
    passes = bwd.f32_passes()
    grids = bwd.dims()[14:]
    assert len(grids) == 16
    for i, name in enumerate(("D", "dz", "dwp", "dWc")):
        want = [*passes[name][0], passes[name][1]] if name in passes else [0] * 4
        assert grids[4 * i:4 * i + 4] == want
    if c1 % 8 == 0:
        bf16 = backward_plan(batch, code, s0, c0, c1, True, NEEDS[need], SMS)
        assert bf16.dims()[14:] == [0] * 16


@pytest.mark.parametrize("need", list(NEEDS))
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_backward_f32_plan_covers_each_output_once(shape, need):
    batch, code, s0, c0, c1 = dims(shape)
    plan = backward_plan(batch, code, s0, c0, c1, False, NEEDS[need], SMS)
    want = dict(zip(("D", "dz", "dwp", "dWc"),
                    (plan.need_dh, plan.need[0], plan.need[1], plan.need[5])))
    passes = plan.f32_passes()
    assert set(passes) == {k for k, v in want.items() if v}
    launched = [k[len("seed_bwd_f32<"):-1] for k in plan.launches()
                if k.startswith("seed_bwd_f32<")]
    assert [k.lower() for k in launched] == [k.lower() for k in passes]
    # dWc, on its side stream, is launched right after D, before dz and dwp.
    assert list(passes) == [k for k in ("D", "dWc", "dz", "dwp") if k in passes]
    # D reads Wc and g transposed, made by two launches just before it.
    assert [k for k in plan.launches() if "transpose" in k] == (
        ["seed_bwd_f32_transpose<Wc>", "seed_bwd_f32_transpose<g>"] if "D" in passes else [])
    assert plan.scratch()["wct"][0] == ((16, c1, c0) if "D" in passes else (0,))
    assert plan.scratch()["gt"][0] == ((4 * s0 * s0 * c1, pad4(batch)) if "D" in passes
                                       else (0,))
    for _, smem in passes.values():
        assert fits(smem)
    area, proj = s0 * s0, s0 * s0 * c0
    r = F32_TILE[0]

    if "D" in passes:
        # ds (batch * area, c0) once, its tile rows pixel-major; each of the
        # 8 slots of a row tile is a warp's 16 rows of one half of the tile,
        # written for each of the tile's columns once.
        seen = np.zeros((batch * area, c0), np.uint8)
        slots = np.zeros((plan.act_slots, c0), np.uint8)
        ds_row = np.array([n * area + i * s0 + j if n < batch else -1 for n, i, j in
                           (pixel_major(m, batch, s0) for m in range(pad4(batch) * area))])
        for what, rows, cols, k in plan.f32_tiles("D"):
            assert what == "ds" and k == (0, 16 * c1)
            cs = slice(cols.start, min(cols.stop, c0))
            dr = ds_row[rows.start:min(rows.stop, ds_row.size)]
            seen[dr[dr >= 0], cs] += 1
            slots[rows.start // r * plan.WARPS:(rows.start // r + 1) * plan.WARPS, cs] += 1
        assert (seen == 1).all() and (slots == 1).all()
        assert plan.act_slots == plan.d_tiles_m * plan.WARPS
        assert plan.scratch()["act_part"][0] in ((0,), (2, plan.act_slots, c0))

    if "dz" in passes:
        # Each K chunk's partials (batch, code) once; the chunks cover proj.
        seen = np.zeros((plan.splits, batch, code), np.uint8)
        spans = set()
        for (what, z), rows, cols, k in plan.f32_tiles("dz"):
            assert what == "dz_part" and k[1] > k[0]
            spans.add(k)
            seen[z, rows.start:min(rows.stop, batch), cols.start:min(cols.stop, code)] += 1
        assert (seen == 1).all()
        spans = sorted(spans)
        assert spans[0][0] == 0 and spans[-1][1] == proj
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert len(spans) == plan.splits == plan.scratch()["dz_part"][0][0]

    if "dwp" in passes:
        seen = np.zeros((code, proj), np.uint8)
        for what, rows, cols, k in plan.f32_tiles("dwp"):
            assert what == "dwp" and k == (0, batch)
            seen[rows.start:min(rows.stop, code), cols.start:min(cols.stop, proj)] += 1
        assert (seen == 1).all()

    if "dWc" in passes:
        # Every tap's (c0, c1) once a K chunk, the taps by cost along z and
        # each tap's chunks together covering its pixel pairs over the
        # batch; with more than one chunk the partials go to dwc_part, which
        # the reduce sums.
        chunks = plan.wc_chunks
        seen = np.zeros((chunks, 16, c0, c1), np.uint8)
        spans, order = {}, []
        for (what, tap, chunk), rows, cols, k in plan.f32_tiles("dWc"):
            assert what == "dwc" and k[1] > k[0]
            spans.setdefault(tap, set()).add(k)
            if not order or order[-1] != tap:
                order.append(tap)
            seen[chunk, tap, rows.start:min(rows.stop, c0), cols.start:min(cols.stop, c1)] += 1
        assert (seen == 1).all() and order == list(TAPS_BY_COST)
        for tap, ks in spans.items():
            ks = sorted(ks)
            assert len(ks) == chunks and ks[0][0] == 0
            assert ks[-1][1] == _tap_pairs(s0, tap) * batch
            assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))
        want = (0,) if chunks == 1 else (chunks, 16, c0, c1)
        assert plan.scratch()["dwc_part"][0] == want
        assert (("dwc", "dwc_part", chunks, 16 * c0 * c1) in plan.sums()) == (chunks > 1)
        assert chunks == 1 or (2 * SMS) // (16 * plan.wc_tiles) > 1


def test_flagship_grids():
    """The flagship's G-LIS step (256 stacked codes): the forward's passes
    and the backward's, at least one block for every SM in each big pass."""
    plan = forward_plan(256, 256, 5, 512, 256)
    assert plan.passes()["project"][0] == (100, 2, 1)
    assert plan.passes()["conv"][0] == (2, 4, 50)
    bwd = backward_plan(256, 256, 5, 512, 256, False, NEEDS["every gradient"], SMS)
    assert {k: g for k, (g, _) in bwd.f32_passes().items()} == {
        "D": (4, 50, 1), "dz": (2, 2, bwd.splits), "dwp": (100, 2, 1), "dWc": (2, 4, 32)}
    assert bwd.wc_chunks == 2  # 8 tiles a tap: two K chunks fill 2 blocks an SM


@pytest.mark.parametrize("c1", [2, 6, 98])
def test_fp32_widths_the_kernels_refuse(c1):
    """The fp32 kernels copy c1's rows in 16-byte pieces: a c1 that is not
    a multiple of 4 raises, as code and c0 do, before any launch."""
    z = torch.zeros(3, 16)
    wp = torch.zeros(16, 5 * 5 * 8)
    wc = torch.zeros(4, 4, 8, c1)
    with pytest.raises(ValueError, match="divisible by 4"):
        _check_shapes("fused_seed", z, wp, wc, 5)
    _check_shapes("fused_seed", z, wp, torch.zeros(4, 4, 8, 4 * (c1 // 4 + 1)), 5)
