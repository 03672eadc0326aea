"""The port's CUDA and Triton kernels on the card against their plain
versions, at the flagship train step's and scored render's shapes and at
edge shapes, in fp32 and bf16: the forwards within `TOL`, TPReLU's
backward (dx bit for bit, da and db within `BWD_SUM_TOL`), the seed's
backward (every gradient, dz alone and the weights alone within
`SEED_BWD_TOL` and `SEED_BWD_MEAN_TOL`, two calls bit for bit) and LIS's
chain backward (the G-LIS, batch-norm, R-separate and every-gradient need
sets, at the flagship chain and at its near-zero case, within
`LIS_BWD_TOL` and `LIS_BWD_MEAN_TOL`); and for each bf16 backward the
control: what a kernel that left one of the plain version's roundings out
would read must exceed the limit. Cases and limits are in
`torch_port_card_cases.py`. Needs an NVIDIA card and skips without one;
imports no JAX, so on the card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_port_kernels_card.py
"""

import pytest
import torch
from torch_port_card_cases import (
    BATCH,
    BWD_SUM_TOL,
    KERNEL,
    LIS_BWD_MEAN_TOL,
    LIS_NEEDS,
    PLAIN,
    SEED_BWD_MEAN_TOL,
    SEED_NEEDS,
    backward_cases,
    card,  # noqa: F401 -- the session fixture
    cases,
    check_lis_chain_smem,
    check_lis_forward,
    compare,
    compare_backward,
    compare_lis_backward,
    compare_lis_chain,
    compare_seed_backward,
    left_out_roundings,
    lis_backward_args,
    lis_chain_args,
    lis_chain_near_zero,
    lis_chain_needs,
    lis_left_out_rounding,
    randn,
    seed_backward_cases,
    seed_left_out_rounding,
)

from gea_torch import FLAGSHIP, ops

pytestmark = [pytest.mark.card, pytest.mark.usefixtures("card")]
DTYPES = (torch.float32, torch.bfloat16)


def test_every_kernel_library_builds():
    """nvcc built every source of `gea_torch/csrc/` (the fixture built
    them); ptxas's registers and spills of each entry are printed."""
    from gea_torch.ops import build

    paths = build.build_all()
    assert paths and all(p.exists() for p in paths.values()), paths
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build] {name}: {line.strip()}")


def test_forwards_match_their_plain_versions():
    """Each forward kernel at every case of the flagship step and scored
    render (and the shapes only the R trainers give it) within TOL."""
    for name, label, _, _, make in cases(FLAGSHIP):
        for dt in DTYPES:
            args = make(dt)
            err = compare(name, label, dt, KERNEL[name](*args), PLAIN[name](*args))
            print(f"[kernel] {name} {label} {str(dt)[6:]} max|err| {err:.3e}")
            del args


def test_tprelu_backward_matches_its_plain_version():
    """TPReLU's backward at every TPReLU case's shape, with da and db and
    without; in bf16 a kernel with a rounding left out would read more
    than BWD_SUM_TOL."""
    left_out = {}
    for label, per_step, make in backward_cases(FLAGSHIP):
        for dt in DTYPES:
            x, a, b, g = make(dt)
            if dt == torch.bfloat16 and per_step:
                for what, r in left_out_roundings(x, a, b, g).items():
                    left_out[what] = min(left_out.get(what, 1.0), r)
            for need in (True, False):
                rel, _ = compare_backward(label, dt, (x, a, b, g, need))
                print(f"[kernel] fused_tprelu_backward {label} {str(dt)[6:]} need_ab {need}: "
                      f"da/db max|err|/max {rel:.3e}")
            del x, a, b, g
    print(f"[kernel] fused_tprelu_backward: a kernel with a rounding left out reads {left_out}")
    missed = left_out["products in fp32"]
    assert missed > BWD_SUM_TOL, (f"BWD_SUM_TOL {BWD_SUM_TOL} would pass a kernel that left the "
                                  f"bf16 product rounding out ({missed:.3e})")


def test_seed_backward_matches_its_plain_version():
    """The seed's backward at both seed shapes (the G-LIS step's stacked
    codes and R-iterative's batch) with every gradient, dz alone and the
    weights alone; a second call equal to the first bit for bit; in bf16
    a kernel without the ds rounding would read more than
    SEED_BWD_MEAN_TOL."""
    missed = 1.0
    for label, _, make in seed_backward_cases(FLAGSHIP):
        for dt in DTYPES:
            args = make(dt)
            for what, need in SEED_NEEDS.items():
                rel, mean_rel, _ = compare_seed_backward(label, dt, args, need)
                first = ops.fused_seed_backward(*args, need)
                again = ops.fused_seed_backward(*args, need)
                assert all(a is None or torch.equal(a, b) for a, b in zip(first, again)), (
                    f"fused_seed_backward {label} {dt} {what}: two calls on the same inputs differ")
                del first, again
                print(f"[kernel] fused_seed_backward {label} {str(dt)[6:]} {what}: max|err|/max "
                      f"{rel:.3e}, mean|err|/mean {mean_rel:.3e}")
            if dt == torch.bfloat16:
                missed = min(missed, seed_left_out_rounding(args))
            del args
    tol = SEED_BWD_MEAN_TOL[torch.bfloat16]
    print(f"[kernel] fused_seed_backward: a kernel without the ds rounding reads {missed:.3e}")
    assert missed > tol, (f"SEED_BWD_MEAN_TOL {tol} would pass a kernel that left the ds "
                          f"rounding out ({missed:.3e})")


def test_lis_chain_backward_matches_its_plain_version():
    """LIS's chain backward on the G-LIS step's chain and its near-zero
    case, with each path's need sets (`compare_lis_chain`: two calls bit
    for bit, the chain and each link; the kernel's shared bytes the
    plan's); in bf16 a kernel without the
    roundings of h and dh_pre would read more than LIS_BWD_MEAN_TOL at the
    last link."""
    gen = torch.Generator().manual_seed(5)
    code, hidden = FLAGSHIP.code_size, FLAGSHIP.code_size * FLAGSHIP.lis_hidden_mult
    links = FLAGSHIP.r_iterations
    missed = 1.0
    for case in ("flagship", "near zero"):
        for dt in DTYPES:
            args = lis_chain_args(BATCH, code, hidden, links, dt, gen)
            label = f"LIS chain {links} x ({BATCH}, {code}) x ({code}, {hidden})"
            if case == "near zero":
                args, flips = lis_chain_near_zero(args)
                label += f" near zero ({flips} fp32 flips)"
            for what, needs in lis_chain_needs(links).items():
                check_lis_chain_smem(label, dt, args, needs)
                rel, mean_rel, _, chain_rel = compare_lis_chain(label, dt, args, needs)
                print(f"[kernel] lis_chain_backward {label} {str(dt)[6:]} {what}: max|err|/max "
                      f"{rel:.3e} (the chain {chain_rel:.3e}), mean|err|/mean {mean_rel:.3e}")
            if dt == torch.bfloat16:
                missed = min(missed, lis_left_out_rounding(tuple(col[-1] for col in args)))
            del args
    tol = LIS_BWD_MEAN_TOL[torch.bfloat16]
    print(f"[kernel] lis_chain_backward: a kernel without the roundings reads {missed:.3e}")
    assert missed > tol, (f"LIS_BWD_MEAN_TOL {tol} would pass a kernel that left the roundings "
                          f"of h and dh_pre out ({missed:.3e})")


def test_edge_shapes():
    """Shapes the flagship never reaches, which exercise the kernels'
    masks: a ragged batch, the smallest and largest s0, widths that are not
    tile multiples or below one tile. Each kernel against its plain version
    at the stated limits; the seed's forward and backward and LIS's forward
    two calls bit for bit; LIS's chain backward's shared bytes the plan's,
    and its single-link op (`lis_residual_mlp_backward`) with each need
    set; LIS's fp32 forward also where its ring is shallower than its
    chunks."""
    gen = torch.Generator().manual_seed(1)
    errs = {}
    seed_shapes = [  # (batch, code, s0, c0, c1)
        (33, 256, 4, 256, 96),
        (33, 40, 7, 256, 96),
        (7, 256, 5, 512, 256),
        (9, 256, 5, 512, 512),  # config 5's widths (the DP step's)
        # Tile remainders of the fp32 product core (128 x 128): rows (batch x
        # s0^2) and c1 that no tile divides.
        (100, 256, 5, 512, 136),
        (65, 256, 6, 128, 200),
        # Widths below one tile.
        (8, 16, 5, 32, 16), (3, 8, 4, 16, 8), (5, 8, 7, 16, 24),
    ]
    # (batch, code, hidden): batches that are not a multiple of the
    # forward's row tile or the backward's chunk, widths below one tile, one
    # row, and lis_hidden_mult 2 (the backward then walks the batch in smaller chunks).
    lis_shapes = [(30, 256, 256), (30, 40, 48), (1, 256, 512), (17, 256, 256), (33, 256, 256),
                  (128, 256, 256), (256, 256, 256), (64, 256, 512)]
    # The backward alone also at the flagship link, one row of it, and
    # widths below one tile.
    lis_backward_shapes = lis_shapes + [(64, 256, 256), (1, 256, 256), (5, 16, 32)]
    # (rows, channels): C not a power of two, one row, rows that are not a
    # multiple of the backward's tile (32 rows at C = 64) nor of the forward's;
    # the backward with da and db at each, and at each one more case: dx
    # only, or an fp32 cotangent into bf16 x (eager promotion: the products
    # in fp32; with fp32 x that is the first case again).
    tprelu_shapes = [((777, 3), "dx only"), ((130, 5), "fp32 g"), ((333, 96), "dx only"),
                     ((45, 1000), "fp32 g"), ((1, 64), "dx only"), ((4097, 64), "fp32 g"),
                     ((3, 2, 7, 96), "dx only")]
    for dt in DTYPES:
        for shape, extra in tprelu_shapes:
            c = shape[-1]
            x, g = randn(shape, gen, 1.0, dt), randn(shape, gen, 0.1, dt)
            a, b = torch.rand(c, generator=gen).cuda() * 0.5, randn(c, gen, 0.1)
            label = f"TPReLU {shape}"
            errs[f"{label} {str(dt)[6:]}"] = compare("fused_tprelu", label, dt, ops.fused_tprelu(
                x, a, b), ops.fused_tprelu_plain(x, a, b))
            variants = [(g, True)]
            if extra == "dx only":
                variants.append((g, False))
            elif dt == torch.bfloat16:
                variants.append((g.float(), True))
            for g_, need in variants:
                what = (f"backward {label} g {str(g_.dtype)[6:]} "
                        f"{'dx, da, db' if need else 'dx only'}")
                errs[f"{what} {str(dt)[6:]}"] = compare_backward(what, dt, (x, a, b, g_, need))[0]
    for dt in DTYPES:
        for batch, code, s0, c0, c1 in seed_shapes:
            p = s0 * s0 * c0
            args = (randn((batch, code), gen, 1.0, dt), randn((code, p), gen, code**-0.5, dt),
                    randn(p, gen, 0.1), torch.rand(c0, generator=gen).cuda() * 0.5,
                    randn(c0, gen, 0.1), randn((4, 4, c0, c1), gen, (16 * c0) ** -0.5, dt),
                    randn(c1, gen, 0.1), s0)
            label = f"seed batch {batch} code {code} s0 {s0} c0 {c0} c1 {c1}"
            first = ops.fused_seed(*args)
            errs[f"{label} {str(dt)[6:]}"] = compare(
                "fused_seed", label, dt, first, ops.fused_seed_plain(*args))
            assert torch.equal(first, ops.fused_seed(*args)), (
                f"fused_seed {label} {dt}: two calls differ")
            g = randn((batch, 2 * s0, 2 * s0, c1), gen, 0.1, dt)
            for needed, need in SEED_NEEDS.items():
                what = f"backward {label} {needed}"
                bwd = (*args[:7], g, s0)
                errs[f"{what} {str(dt)[6:]}"] = compare_seed_backward(what, dt, bwd, need)[0]
                one, two = ops.fused_seed_backward(*bwd, need), ops.fused_seed_backward(*bwd, need)
                assert all(a is None or torch.equal(a, b) for a, b in zip(one, two)), (
                    f"fused_seed_backward {what} {dt}: two calls differ")
        for batch, code, hidden in lis_backward_shapes:
            label = f"LIS batch {batch} code {code} hidden {hidden}"
            if (batch, code, hidden) in lis_shapes:
                args = (randn((batch, code), gen, 1.0, dt),
                        randn((code, hidden), gen, code**-0.5, dt), randn(hidden, gen, 0.1),
                        torch.rand(hidden, generator=gen).cuda() * 0.5, randn(hidden, gen, 0.1),
                        randn((hidden, code), gen, hidden**-0.5, dt), randn(code, gen, 0.1))
                errs[f"{label} {str(dt)[6:]}"] = check_lis_forward(label, dt, args)
            for links in (1, 2, 3):
                chain = lis_chain_args(batch, code, hidden, links, dt, gen)
                for what, needs in lis_chain_needs(links).items():
                    check_lis_chain_smem(f"backward {label} x{links} {what}", dt, chain, needs)
                    errs[f"backward {label} x{links} {what} {str(dt)[6:]}"] = compare_lis_chain(
                        f"backward {label} x{links} {what}", dt, chain, needs)[0]
            one = lis_backward_args(batch, code, hidden, dt, gen)
            for what, need in LIS_NEEDS.items():
                errs[f"backward {label} one link {what} {str(dt)[6:]}"] = compare_lis_backward(
                    f"backward {label} one link {what}", dt, one, need)[0]
    # A ring shallower than the chunks (wider than the flagship: the fp32
    # kernel streams its weight slices through the ring).
    for batch, code, hidden in [(20, 1024, 1024), (9, 512, 2048), (72, 256, 2048)]:
        args = (randn((batch, code), gen), randn((code, hidden), gen, code**-0.5),
                randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
                randn(hidden, gen, 0.1), randn((hidden, code), gen, hidden**-0.5),
                randn(code, gen, 0.1))
        plan = ops.lis.forward_plan(batch, code, hidden, False, ops.lis._sm_count(0))
        assert plan.depth < plan.chunks, (f"LIS ring case {batch, code, hidden}: the plan "
                                          f"{plan.dims()} holds all {plan.chunks} chunks")
        label = f"LIS batch {batch} code {code} hidden {hidden} ring {plan.depth}/{plan.chunks}"
        errs[f"{label} float32"] = check_lis_forward(label, torch.float32, args)
    for k, v in errs.items():
        print(f"[edge] {k:52s} max|err| {v:.3e}")
