"""The host plan of the LIS forward's kernels (`gea_torch.ops.lis.forward_plan`):
at batches 1, 3, 17, 30, 33, 64, 128 and 256, at the flagship's widths
(code = hidden = 256), at `lis_hidden_mult` 2 (hidden 512), at widths below
one slice of 16 (40, 48) and at the tiny tests' (128, 128), in fp32 and
bf16, every (row, hidden column) and every (row, output column) is computed
by exactly one block, the blocks' slices cover hidden and code, the cluster
size is one the launch takes, every block's shared memory fits the card,
and in fp32 each layer's register tiles fit the block's threads. The
launch (`csrc/lis.cu::gea_lis_forward`) takes the plan's `dims` and refuses
any other grid or shared size; `tests/test_torch_port_kernels_card.py` holds the kernel's
own
layout (`gea_lis_smem_bytes`) to the plan's bytes at every edge shape on
the card, where both can be read."""

import numpy as np
import pytest

from gea_torch.ops import build
from gea_torch.ops.lis import (
    BF16_CLUSTER,
    BF16_ROWS,
    FWD_CHUNK,
    FWD_CLUSTERS,
    FWD_ROWS,
    FWD_SLOTS,
    FWD_THREADS,
    FWD_TILES,
    bf16_smem_bytes,
    f32_smem_bytes,
    forward_plan,
    thread_tile,
)

BATCHES = (1, 3, 17, 30, 33, 64, 128, 256)
WIDTHS = {"flagship": (256, 256), "hidden512": (256, 512), "narrow": (40, 48),
          "tiny": (128, 128)}
SHAPES = [(batch, width, bf16) for batch in BATCHES for width in WIDTHS for bf16 in (False, True)]
SMS = 132


def ids(shape):
    return f"b{shape[0]}-{shape[1]}-{'bf16' if shape[2] else 'fp32'}"


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_forward_plan_covers_each_output_once(shape):
    batch, width, bf16 = shape
    code, hidden = WIDTHS[width]
    plan = forward_plan(batch, code, hidden, bf16, SMS)
    rows, cluster, depth = plan.config
    if bf16:
        assert (rows, cluster, depth) == (BF16_ROWS, BF16_CLUSTER, 0)
        assert plan.smem_bytes == bf16_smem_bytes(code, hidden)
    else:
        assert rows in FWD_ROWS and cluster in FWD_CLUSTERS
        assert 1 <= depth <= min(plan.chunks, FWD_SLOTS)
        assert plan.chunks == -(-code // FWD_CHUNK) + -(-hidden // FWD_CHUNK)
        assert plan.smem_bytes == f32_smem_bytes(code, hidden, rows, cluster, depth)
    assert plan.smem_bytes <= build.SMEM_LIMIT
    assert plan.blocks == -(-batch // rows) * cluster
    assert plan.dims() == [rows, cluster, depth, plan.blocks, plan.smem_bytes]

    hid = np.zeros((batch, hidden), np.uint8)
    out = np.zeros((batch, code), np.uint8)
    layout = plan.blocks_layout()
    assert len(layout) == plan.blocks
    for r, h, o in layout:
        hid[r.start:r.stop, h.start:h.stop] += 1
        out[r.start:r.stop, o.start:o.stop] += 1
    assert (hid == 1).all() and (out == 1).all()

    # Within a cluster the slices tile hidden and code in rank order, and
    # no block holds a weight whole (but where one slice is all there is).
    wh, wo = plan.slices()
    assert wh * cluster >= hidden and wo * cluster >= code
    first = layout[:cluster]
    assert [h.start for _, h, _ in first if h] == list(range(0, hidden, wh))
    assert [o.start for _, _, o in first if o] == list(range(0, code, wo))
    assert wh < hidden and wo < code

    if not bf16:
        # Each layer's outputs, rows x slice, in register tiles of the
        # block's threads (`tile_size` in lis.cu).
        assert wh % 4 == 0 and wo % 4 == 0
        for w in (wh, wo):
            rt, ct = thread_tile(rows, w)
            assert (rt, ct) in FWD_TILES and rows % rt == 0 and w % ct == 0
            assert (rows // rt) * (w // ct) <= FWD_THREADS


def test_flagship_plan():
    """The flagship link (batch 64, code = hidden = 256) in fp32: 8 clusters
    of 16 blocks on 8 rows each (128 SMs), every block a sixteenth of each
    weight, the whole ring in shared memory (8 chunks of 64 k-rows, all in
    flight at once), one output a thread; its stacked batch of 256 on
    clusters of 16 rows."""
    plan = forward_plan(64, 256, 256, False, SMS)
    assert plan.dims() == [8, 16, 8, 128, 50432]
    assert plan.slices() == (16, 16) and plan.depth == plan.chunks
    assert thread_tile(8, 16) == (1, 1)
    assert forward_plan(256, 256, 256, False, SMS).dims()[:4] == [16, 16, 8, 256]
    assert forward_plan(64, 256, 256, True, SMS).dims() == [16, 8, 0, 32, 59648]


@pytest.mark.parametrize("shape,tiles", [
    ((20, 1024, 1024), [(1, 2), (1, 2)]),
    ((9, 512, 2048), [(2, 2), (1, 1)]),
    ((72, 256, 2048), [(2, 4), (1, 1)]),
], ids=["1024x1024", "512x2048", "256x2048"])
def test_the_ring_cases_stream_their_weights(shape, tiles):
    """The shapes `tests/test_torch_port_kernels_card.py` runs to check the ring on the
    card: wider
    than shared memory holds whole, so the ring is shallower than the
    chunks (at least 2 slots), and together they reach every register tile
    the kernel has."""
    plan = forward_plan(*shape, False, SMS)
    assert 2 <= plan.depth < plan.chunks
    assert plan.smem_bytes <= build.SMEM_LIMIT
    wh, wo = plan.slices()
    assert [thread_tile(plan.rows, w) for w in (wh, wo)] == tiles


def test_a_plan_that_fits_nothing():
    """No layout holds rows this wide: the plan says so (config None) and
    the wrapper raises the ValueError "too wide" before any launch."""
    assert forward_plan(8, 8192, 8192, False, SMS).config is None
    assert forward_plan(8, 4096, 4096, True, SMS).config is None


def test_the_plan_is_a_pure_function():
    a = forward_plan(33, 256, 512, False, SMS)
    assert a is forward_plan(33, 256, 512, False, SMS)  # cached
    assert a.dims() == forward_plan.__wrapped__(33, 256, 512, False, SMS).dims()
    # More SMs keep 8-row tiles at larger batches.
    assert forward_plan(128, 256, 256, False, 264).rows == 8
