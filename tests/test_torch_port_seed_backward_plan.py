"""The host-side plan of the seed's backward kernels
(`gea_torch.ops.seed.backward_plan`): at every shape that the card's checks
run (`scripts/torch_seed_backward_check.py`, `chip_smoke.py`'s seed cases),
in both dtypes, for every set of gradients a path asks for and at SM counts
1, 7 and 132, each output tile and each partial slot is assigned exactly
once, the K chunks of a tile cover its K exactly, and the reduce reads every
slot that the passes write. The kernels list their items with the same
arithmetic (`csrc/seed_bwd.cu`: `item_of`, `d_item`, `w_item`)."""

import collections

import pytest

from gea_torch.ops.seed import TAPS_BY_COST, _cdiv, _tap_pairs, backward_plan, pad4

SHAPES = [  # (batch, code, s0, c0, c1): the check script's, the G-LIS step's and R-iterative's
    (8, 16, 5, 32, 16), (3, 8, 4, 16, 8), (5, 8, 7, 16, 24), (33, 40, 7, 256, 96),
    (7, 256, 5, 512, 512), (64, 256, 5, 512, 256), (256, 256, 5, 512, 256),
]
NEEDS = {"all": (True,) * 7, "dz": (True,) + (False,) * 6, "weights": (False,) + (True,) * 6}
SMS = (1, 7, 132)
CASES = [(shape, bf16, need, sms) for shape in SHAPES for bf16 in (True, False)
         for need in NEEDS for sms in SMS
         if not (bf16 and any(v % 8 for v in (shape[1], shape[3], shape[4])))]


def ids(case):
    shape, bf16, need, sms = case
    return f"{'x'.join(map(str, shape))}-{'bf16' if bf16 else 'fp32'}-{need}-sm{sms}"


def plan_of(case):
    shape, bf16, need, sms = case
    return backward_plan(*shape, bf16, NEEDS[need], sms)


def walked(plan, kernel):
    """Every item of a persistent pass with the block that takes it."""
    grid = plan.d_grid if kernel == "d" else plan.w_grid
    return [(b, i) for b in range(grid) for i in plan.block_items(kernel, b)]


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_each_tile_and_slot_is_assigned_once(case):
    plan = plan_of(case)
    need = plan.need
    area, proj, t = plan.area, plan.proj, plan.TILE
    assert plan.r_tiles == (_cdiv(plan.batch, 64) * _cdiv(proj, 64)
                            if plan.need_dh or need[5] else 0)

    # D: every tile once; its images and columns cover the output once; every
    # dslope/dtrans slot written once.
    slots = collections.Counter()
    if plan.bf16:
        assert 0 < plan.d_grid <= plan.sms if plan.need_dh else plan.d_grid == 0
        items = walked(plan, "d")
        assert sorted(i for _, i in items) == list(range(plan.d_items))
        assert all(plan.block_items("d", b) for b in range(plan.d_grid))
        cells = collections.Counter()
        for _, i in items:
            kind, img0, n0, _, k0, k1, m = plan.d_item(i)
            assert kind == "d" and (k0, k1) == (0, 16 * _cdiv(plan.c1, 64))
            assert img0 == m * plan.per and plan.per * area <= t
            for img in range(img0, min(img0 + plan.per, plan.batch)):
                for col in range(n0, min(n0 + t, plan.c0)):
                    cells[img, col] += 1
            for w in range(plan.WARPS):
                for col in range(n0, min(n0 + t, plan.c0)):
                    slots[m * plan.WARPS + w, col] += 1
        if plan.need_dh:
            assert set(cells.values()) == {1} and len(cells) == plan.batch * plan.c0
    elif plan.need_dh:
        ft = plan.TILE_F32
        assert plan.d_grid == plan.d_tiles_m * plan.d_tiles_n
        rows = pad4(plan.batch) * area  # pixel-major over the padded batch
        assert plan.d_tiles_m * ft >= rows > (plan.d_tiles_m - 1) * ft
        assert plan.d_tiles_n * ft >= plan.c0 > (plan.d_tiles_n - 1) * ft
        for m in range(plan.d_tiles_m):
            for n in range(plan.d_tiles_n):
                for w in range(plan.WARPS):
                    for col in range(n * ft, min(n * ft + ft, plan.c0)):
                        slots[m * plan.WARPS + w, col] += 1
    if plan.need_dh:
        assert set(slots.values()) == {1}
        assert len(slots) == plan.act_slots * plan.c0

    # W (bf16): every item once, each block's list non-empty; every output
    # element of dz, dwp and dWc once per K chunk, the chunks covering K.
    if plan.bf16:
        assert plan.w_grid <= plan.sms
        items = walked(plan, "w")
        assert sorted(i for _, i in items) == list(range(plan.w_items))
        assert all(plan.block_items("w", b) for b in range(plan.w_grid))
        kspan = collections.defaultdict(list)
        out = collections.Counter()
        for _, i in items:
            kind, m0, n0, tap, k0, k1, slot = plan.w_item(i)
            assert k1 > k0
            kspan[kind, m0, n0, tap].append((k0, k1))
            out[kind, m0, n0, tap, slot] += 1
        assert set(out.values()) <= {1}
        want = collections.Counter()
        if need[5]:
            for tap in range(16):
                for m0 in range(0, plan.c0, t):
                    for n0 in range(0, plan.c1, t):
                        want["wc", _tap_pairs(plan.s0, tap) * plan.nkb] += 1
                        assert len(kspan["wc", m0, n0, tap]) == plan.wc_chunks
        if need[0]:
            for m0 in range(0, plan.batch, t):
                for n0 in range(0, plan.code, t):
                    want["z", plan.z_steps] += 1
                    assert len(kspan["z", m0, n0, 0]) == plan.splits
        if need[1]:
            for m0 in range(0, plan.code, t):
                for n0 in range(0, proj, t):
                    want["wp", plan.nkb] += 1
        got = collections.Counter()
        for (kind, *_), spans in kspan.items():
            spans.sort()
            assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            got[kind, spans[-1][1]] += 1
        assert got == want
        assert plan.n_wc == (16 * plan.wc_tiles * plan.wc_chunks if need[5] else 0)
    else:  # fp32: dz, dwp and dWc are launches of their own (test_torch_port_seed_f32_plan.py)
        assert plan.w_items == 0


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_the_reduce_reads_every_slot(case):
    """Each set of partials the passes write has the shape the reduce
    reads: as many terms as slots, as many columns as the gradient."""
    plan = plan_of(case)
    need, scratch = plan.need, plan.scratch()
    sums = {name: (src, terms, cols) for name, src, terms, cols in plan.sums()}
    assert set(sums) == {name for name, n in zip(
        ("dz", "dbp", "dslope", "dtrans", "dwc", "dbc"), (0, 2, 3, 4, 5, 6))
        if need[n] and (name != "dwc" or plan.wc_chunks > 1)}
    if need[0]:
        splits = {plan.w_item(i)[6] for i in range(plan.n_wc, plan.n_wc + plan.n_z)}
        assert not plan.bf16 or splits == set(range(plan.splits))
        assert scratch["dz_part"][0] == (plan.splits, plan.batch, plan.code)
        assert sums["dz"] == ("dz_part", plan.splits, plan.batch * plan.code)
    if need[2]:
        assert sums["dbp"] == ("ds", plan.batch, plan.proj)
        assert scratch["ds"][0] == (plan.batch, plan.proj)
    for i, name in ((3, "dslope"), (4, "dtrans")):
        if need[i]:
            assert scratch["act_part"][0] == (2, plan.act_slots, plan.c0)
            assert sums[name] == (f"act_part[{i - 3}]", plan.act_slots, plan.c0)
    if need[5] and plan.wc_chunks > 1:
        chunks = {plan.w_item(i)[6] for i in range(plan.n_wc)}
        assert not plan.bf16 or chunks == set(range(plan.wc_chunks))
        assert scratch["dwc_part"][0] == (plan.wc_chunks, 16, plan.c0, plan.c1)
        assert sums["dwc"] == ("dwc_part", plan.wc_chunks, 16 * plan.c0 * plan.c1)
    else:
        assert scratch["dwc_part"][0] == (0,)
    if need[6]:
        rows = plan.batch * 4 * plan.area
        assert plan.gchunks * 128 >= rows > (plan.gchunks - 1) * 128
        assert plan.colsum_blocks == _cdiv(plan.c1, 128) * plan.gchunks
        assert sums["dbc"] == ("dbc_part", plan.gchunks, plan.c1)
        assert scratch["dbc_part"][0] == (plan.gchunks, plan.c1)
    unused = {"s": not (plan.need_dh or need[5]), "h": not need[5], "ds": not plan.need_dh,
              "dz_part": not need[0], "act_part": not (need[3] or need[4]),
              "dbc_part": not need[6]}
    for name, empty in unused.items():
        assert (scratch[name][0] == (0,)) == empty, name


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("need", list(NEEDS))
def test_launches_a_call(need, sms):
    """The G-LIS step's shape: the bf16 call makes at most 5 launches (4:
    the projection, D with the ds step, W, the reduce); the persistent
    passes take at most one block a SM."""
    plan = backward_plan(256, 256, 5, 512, 256, True, NEEDS[need], sms)
    launches = plan.launches()
    assert len(launches) <= 5 and launches[0] == "seed_bwd_project"
    assert launches == ["seed_bwd_project", "seed_bwd_gemm<D>", "seed_bwd_gemm<W>",
                        "seed_bwd_reduce"]
    assert plan.d_grid == min(sms, plan.d_items) and plan.w_grid == min(sms, plan.w_items)
    f32 = backward_plan(256, 256, 5, 512, 256, False, NEEDS[need], sms).launches()
    assert f32[0] == "seed_bwd_project" and f32[-1] == "seed_bwd_reduce"


def test_taps_by_cost_and_the_snake():
    """The taps in order of their pixel pairs, each once; the W pass deals
    a block its items in snake order and D in turn."""
    assert sorted(TAPS_BY_COST) == list(range(16))
    for s0 in (4, 5, 7):
        pairs = [_tap_pairs(s0, t) for t in TAPS_BY_COST]
        assert pairs == sorted(pairs, reverse=True) and pairs[0] == s0 * s0
    plan = backward_plan(256, 256, 5, 512, 256, True, NEEDS["all"], 7)
    assert plan.block_items("w", 0)[:3] == [0, 13, 14]
    assert plan.block_items("w", 6)[:3] == [6, 7, 20]
    assert plan.block_items("d", 2)[:3] == [2, 9, 16]
    # The longest items first: the centre taps' dWc tiles.
    assert plan.w_item(0)[:4] == ("wc", 0, 0, 5)
    costs = [plan.w_item(i)[5] - plan.w_item(i)[4] for i in range(plan.w_items)]
    assert costs[:plan.n_wc] == sorted(costs[:plan.n_wc], reverse=True)
