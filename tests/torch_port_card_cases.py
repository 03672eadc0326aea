"""Kernel cases of the card modules (`tests/test_torch_port_*_card.py`): the
shapes and seeded inputs of the port's kernels at the flagship train step,
its scored render and the edges, each kernel held against its plain
version (`compare` and the `compare_*` of the backwards) within the
tolerances below, and the session fixture `card` that every card module
uses. Imports no JAX and builds nothing at import: `card` builds the
kernels, on a host with an NVIDIA card, and skips the test without one.
`scripts/torch_kernel_times.py` times the same cases."""

from __future__ import annotations

import hashlib
import os
import subprocess

import pytest
import torch

from gea_torch import ops
from gea_torch.config import generator_plan

BATCH = 64  # the train step's batch, and a scored render's
R_HIDDEN = 512  # the reverser's head width (`gea`'s r_hidden default)

# Tolerance |kernel - plain| <= atol + rtol * |plain|, per dtype. fp32: the
# two differ only in the order of fp32 sums. bf16: a different sum order can
# flip a rounding to bf16 (one step is 2^-8 relative); a flipped hidden or
# seed-map value moves the output by about one more such step.
TOL = {
    "fused_tprelu": {torch.float32: (1e-6, 1e-6), torch.bfloat16: (1e-5, 8e-3)},
    "lis_residual_mlp": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)},
    "fused_seed": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)},
}

# TPReLU's backward: the kernel and its plain version round the same
# products to the same type and sum them in fp32, in another order, in both
# dtypes. Sound runs read about 5e-7 of the largest da and db; a kernel
# that left a bf16 rounding out reads about 1e-3 (`left_out_roundings`).
BWD_SUM_TOL = 1e-5

# The seed's backward: the kernels and the plain version round dh and ds to
# z's dtype and sum in fp32, in other orders. fp32: each gradient within
# SEED_BWD_TOL of its max. bf16: another order of the fp32 sum behind dh can
# round an element of dh (so of ds) to the neighbouring bf16 value, and dz,
# dwp and dwc are rounded to bf16 themselves, so single elements move by a
# step of 2^-8 of their size: the max is held at 2e-2 of the gradient's max
# (as GRAD_TOL). A rounding left out moves every element instead: the mean
# |error| over the mean |gradient| of dwp, dbp and dwc (sums over the batch,
# short enough that the order of their fp32 sums leaves them nearly exact;
# sound runs read up to 4.6e-5 in bf16) is held at SEED_BWD_MEAN_TOL, which
# a kernel that left the ds rounding out must exceed (4.0e-4 on the H100,
# `seed_left_out_rounding`). dz, dslope and dtrans sum over thousands of
# terms that cancel: there the order alone moves the mean by up to 1.2e-4.
SEED_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SEED_BWD_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.5e-4}
SEED_MEAN_CHECKED = ("dwp", "dbp", "dwc")
SEED_GRADS = ("dz", "dwp", "dbp", "dslope", "dtrans", "dwc", "dbc")
ALL_GRADS, DZ_ONLY = (True,) * 7, (True,) + (False,) * 6
WEIGHTS_ONLY = (False,) + (True,) * 6
SEED_NEEDS = {"every gradient": ALL_GRADS, "dz alone": DZ_ONLY, "weights alone": WEIGHTS_ONLY}

# LIS's backward: the kernel and the plain version compute pre exactly, round
# h and dh_pre to z's dtype before the products that take them, and sum in
# fp32, in other orders. fp32: each gradient within LIS_BWD_TOL of its max.
# bf16: another order of the fp32 sum behind dh can round an element of
# dh_pre to the neighbouring bf16 value, and dz, dw1 and dw2 are rounded to
# bf16 themselves, so single elements move by a step of 2^-8 of their size:
# the max is held at 2e-2 of the gradient's max (as GRAD_TOL). A rounding
# left out moves every element instead: the mean |error| over the mean
# |gradient| of dz, dw1 and dw2 is held at LIS_BWD_MEAN_TOL, which a kernel
# that left the roundings of h and dh_pre out must exceed
# (`lis_left_out_rounding`).
LIS_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LIS_BWD_MEAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.5e-4}
LIS_MEAN_CHECKED = ("dz", "dw1", "dw2")
LIS_GRADS = ("dz", "dw1", "db1", "dslope", "dtrans", "dw2", "db2")
LIS_NEEDS = {"every gradient": ALL_GRADS, "dz alone": DZ_ONLY, "weights alone": WEIGHTS_ONLY}

PLAIN = {
    "fused_tprelu": ops.fused_tprelu_plain,
    "lis_residual_mlp": ops.lis_residual_mlp_plain,
    "fused_seed": ops.fused_seed_plain,
}
KERNEL = {
    "fused_tprelu": ops.fused_tprelu,
    "lis_residual_mlp": ops.lis_residual_mlp,
    "fused_seed": ops.fused_seed,
}


def nvidia_smi() -> str:
    """The card's name and power limit."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


@pytest.fixture(scope="session")
def card() -> str:
    """Skips without CUDA. Else, before any check: TF32 off for matmuls
    and cuDNN (fp32 comparisons hold fp32 arithmetic; the train steps and
    trainers turn cuDNN's on themselves, as PyTorch's default has it),
    cuBLAS's workspace in the form deterministic algorithms require (read
    at its first use), and every CUDA kernel built. The card's name and
    power limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    from gea_torch.ops import build

    build.build_all()
    smi = nvidia_smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return smi


def randn(shape, gen, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()


# ------------------------------------------------------------- kernel cases


def cases(cfg, batch: int = BATCH, stages: int = 0):
    """(kernel name, label, launches per scored render, launches per train
    step, make(dtype) -> args) at `cfg`'s widths and `batch`. A train step
    renders S*B fakes once, runs D over B real + S*B fakes (the D step) and
    over the S*B fakes (the G step); a scored render scores B final
    images. `stages` replaces S (1: a render of the final stage alone).
    Every case draws from one generator seeded 0, in this order."""
    s0, d = generator_plan(cfg.image_size)
    stages = stages or cfg.n_stages
    n, code = stages * batch, cfg.code_size
    nf, cap = cfg.num_features, cfg.max_features
    hidden = code * cfg.lis_hidden_mult
    c0 = min(nf * 2 ** (d - 1), cap)
    c1 = min(nf * 2 ** (d - 2), cap)
    gen = torch.Generator().manual_seed(0)
    out = []

    def tprelu_case(m, c):
        def make(dt):
            return (randn((m, c), gen, 1.0, dt), torch.rand(c, generator=gen).cuda() * 0.5,
                    randn(c, gen, 0.1))
        return make

    acts = {}  # (rows, channels) -> [labels, per render, per step]

    def act(label, images, side, ch, per_render, per_step):
        row = acts.setdefault((images * side * side, ch), [[], 0, 0])
        row[0].append(label)
        row[1] += per_render
        row[2] += per_step

    for i in range(1, d):  # G: up{i}_act on the S*B stacked batch
        act(f"G up{i}_act", n, s0 * 2**i, min(nf * 2 ** (d - 1 - i), cap), 1, 1)
    for i in range(1, d):  # D: down{i}_act
        side, ci = cfg.image_size // 2 ** (i + 1), min(nf * 2**i, cap)
        act(f"D down{i}_act (score)", batch, side, ci, 1, 0)
        act(f"D down{i}_act (D step)", (1 + stages) * batch, side, ci, 0, 1)
        act(f"D down{i}_act (G step)", n, side, ci, 0, 1)
    for (m, c), (labels, per_render, per_step) in acts.items():
        out.append(("fused_tprelu", f"{', '.join(labels)} ({m}, {c})", per_render, per_step,
                    tprelu_case(m, c)))

    def lis_make(dt):
        return (randn((batch, code), gen, 1.0, dt), randn((code, hidden), gen, code**-0.5, dt),
                randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
                randn(hidden, gen, 0.1), randn((hidden, code), gen, hidden**-0.5, dt),
                randn(code, gen, 0.1))

    out.append(("lis_residual_mlp", f"LIS link ({batch}, {code}) x ({code}, {hidden})",
                cfg.r_iterations, cfg.r_iterations, lis_make))

    def seed_case(n):
        def make(dt):
            p = s0 * s0 * c0
            return (randn((n, code), gen, 1.0, dt), randn((code, p), gen, code**-0.5, dt),
                    randn(p, gen, 0.1), torch.rand(c0, generator=gen).cuda() * 0.5,
                    randn(c0, gen, 0.1), randn((4, 4, c0, c1), gen, (16 * c0) ** -0.5, dt),
                    randn(c1, gen, 0.1), s0)
        return make

    out.append(("fused_seed", f"seed ({n}, {code}) -> ({n}, {2 * s0}, {2 * s0}, {c1})",
                1, 1, seed_case(n)))
    # Shapes only the R trainers give the kernels (no G-LIS launch): R's
    # head activation, and R-iterative's single-stage render of a batch.
    out.append(("fused_tprelu", f"R head act ({batch}, {R_HIDDEN})", 0, 0,
                tprelu_case(batch, R_HIDDEN)))
    out.append(("fused_seed", f"R-iterative seed ({batch}, {code}) -> ({batch}, {2 * s0}, "
                f"{2 * s0}, {c1})", 0, 0, seed_case(batch)))
    return out


def compare(name, label, dt, got, want) -> float:
    """Hold a kernel's output against its plain version within TOL; return
    the largest |difference|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {label}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[name][dt]
    excess = (err - (atol + rtol * want.float().abs())).max().item()
    max_err = err.max().item()
    if not torch.isfinite(got).all() or excess > 0:
        raise AssertionError(
            f"{name} {label} {dt}: max |err| {max_err:.3e} beyond atol {atol} + rtol {rtol}")
    return max_err


def backward_cases(cfg, batch: int = BATCH):
    """(label, launches per train step, make(dtype) -> x, a, b, g) of
    TPReLU's backward at every TPReLU case's shape: each TPReLU of the
    step is differentiated, with da and db. g comes in x's dtype, as the
    bf16 step hands it on."""
    gen = torch.Generator().manual_seed(3)
    out = []
    for name, label, _, per_step, make in cases(cfg, batch):
        if name == "fused_tprelu":
            def make_bwd(dt, make=make):
                x, a, b = make(dt)
                return x, a, b, randn(x.shape, gen, 0.1, dt)
            out.append((label, per_step, make_bwd))
    return out


def compare_backward(label: str, dt, args) -> tuple:
    """TPReLU's backward kernel against its plain version on `args` (x, a,
    b, g, need_ab): dx equal bit for bit (the same roundings, no sum), da
    and db within BWD_SUM_TOL of their largest magnitude (sums in another
    order). (largest relative da/db error, largest |error|)."""
    got, want = ops.fused_tprelu_backward(*args), ops.fused_tprelu_backward_plain(*args)
    torch.cuda.synchronize()
    if got[0].dtype != want[0].dtype or not torch.equal(got[0], want[0]):
        bad = (got[0].float() != want[0].float()).sum().item()
        raise AssertionError(f"fused_tprelu_backward {label} {dt}: dx differs from the plain "
                             f"version at {bad} elements ({got[0].dtype} vs {want[0].dtype})")
    rel, abs_err = 0.0, 0.0
    for what, k, p in (("da", got[1], want[1]), ("db", got[2], want[2])):
        if (k is None) != (p is None):
            raise AssertionError(f"fused_tprelu_backward {label}: {what} {k} vs {p}")
        if p is None:
            continue
        if k.dtype != p.dtype or not torch.isfinite(k).all():
            raise AssertionError(f"fused_tprelu_backward {label} {dt}: {what} {k.dtype} vs "
                                 f"{p.dtype}, finite {torch.isfinite(k).all().item()}")
        err = (k.float() - p.float()).abs().max().item()
        abs_err = max(abs_err, err)
        rel = max(rel, err / max(p.float().abs().max().item(), 1e-30))
    if not rel <= BWD_SUM_TOL:
        raise AssertionError(f"fused_tprelu_backward {label} {dt}: da/db differ by {rel:.3e} "
                             f"of their max > {BWD_SUM_TOL}")
    return rel, abs_err


def left_out_roundings(x, a, b, g) -> dict:
    """What `compare_backward` would read (relative da/db error) from a
    kernel that left out one of the plain version's bf16 roundings: the
    products g*s and g*(1 - fprime) kept in fp32, or 1 - fprime kept in
    fp32 (products still rounded). Eager ops on the plain version's
    inputs; bf16 x and g."""
    _, da, db = ops.fused_tprelu_backward_plain(x, a, b, g)
    s = x - b.to(x.dtype)
    neg = s < 0
    q = 1 - torch.where(neg, a.to(x.dtype), torch.ones_like(x))  # 1 - fprime, in bf16
    q32 = 1 - torch.where(neg, a.to(x.dtype), torch.ones_like(x)).float()
    axes = tuple(range(x.dim() - 1))
    gf, zero = g.float(), torch.zeros((), device=x.device)
    variants = {
        "products in fp32": (torch.where(neg, gf * s.float(), zero).sum(axes),
                             (gf * q.float()).sum(axes)),
        "1 - fprime in fp32": (da, (gf * q32).to(torch.bfloat16).float().sum(axes)),
    }
    out = {}
    for what, (va, vb) in variants.items():
        out[what] = max(((v.float() - w.float()).abs().max() / w.float().abs().max()).item()
                        for v, w in ((va, da), (vb, db)))
    return out


def seed_backward_cases(cfg, batch: int = BATCH):
    """(label, launches per G-LIS step, make(dtype) -> (z, wp, bp, slope,
    trans, wc, bc, g, s0)) at every seed case's shape, g in z's dtype."""
    gen = torch.Generator().manual_seed(4)
    out = []
    for name, label, _, per_step, make in cases(cfg, batch):
        if name == "fused_seed":
            def make_bwd(dt, make=make):
                args = make(dt)
                z, wc, s0 = args[0], args[5], args[7]
                return (*args[:7], randn((z.shape[0], 2 * s0, 2 * s0, wc.shape[3]), gen, 0.1, dt),
                        s0)
            out.append((label, per_step, make_bwd))
    return out


def grad_errors(got, want, names=SEED_GRADS) -> dict:
    """{gradient: (max |err| / max |want|, mean |err| / mean |want|, max |err|)}."""
    out = {}
    for what, k, w in zip(names, got, want):
        if w is None:
            continue
        err = (k.float() - w.float()).abs()
        out[what] = ((err.max() / w.float().abs().max().clamp_min(1e-30)).item(),
                     (err.mean() / w.float().abs().mean().clamp_min(1e-30)).item(),
                     err.max().item())
    return out


def compare_seed_backward(label: str, dt, args, need) -> tuple:
    """The seed's backward kernels against the plain version on `args` (z,
    wp, bp, slope, trans, wc, bc, g, s0): gradients not asked for None,
    each asked for in its input's dtype, finite, within SEED_BWD_TOL of its
    max, and dwp, dbp and dwc within SEED_BWD_MEAN_TOL of their mean.
    (largest max-relative error, largest mean-relative error of those three,
    largest |error|)."""
    got = ops.fused_seed_backward(*args, need)
    want = ops.fused_seed_backward_plain(*args, need)
    torch.cuda.synchronize()
    for what, k, w, x in zip(SEED_GRADS, got, want, args):
        if (k is None) != (w is None):
            raise AssertionError(f"fused_seed_backward {label}: {what} {k} vs {w}")
        if w is not None and (k.dtype != w.dtype or k.dtype != x.dtype
                              or not torch.isfinite(k).all()):
            raise AssertionError(f"fused_seed_backward {label} {dt}: {what} {k.dtype} vs "
                                 f"{w.dtype}, finite {torch.isfinite(k).all().item()}")
    errs = grad_errors(got, want)
    for what, (rel, mean_rel, _) in errs.items():
        if not (rel <= SEED_BWD_TOL[dt] and (what not in SEED_MEAN_CHECKED
                                             or mean_rel <= SEED_BWD_MEAN_TOL[dt])):
            raise AssertionError(
                f"fused_seed_backward {label} {dt}: {what} differs by {rel:.3e} of its max "
                f"(tol {SEED_BWD_TOL[dt]}), {mean_rel:.3e} of its mean (tol "
                f"{SEED_BWD_MEAN_TOL[dt]} for {SEED_MEAN_CHECKED})")
    return (max(v[0] for v in errs.values()),
            max([v[1] for k, v in errs.items() if k in SEED_MEAN_CHECKED], default=0.0),
            max(v[2] for v in errs.values()))


def seed_left_out_rounding(args) -> float:
    """What `compare_seed_backward` would read (the larger mean-relative
    error of dwp and dbp) from a kernel that left out the plain
    version's rounding of ds to bf16: eager ops on the same inputs, dh from
    cuDNN rounded to bf16 as the plain version rounds it."""
    z, wp, bp, slope, trans, wc, bc, g, s0 = args
    n, c0 = z.shape[0], wc.shape[2]
    s = (z.double() @ wp.double()).float().add(bp.float()).view(n, s0, s0, c0) - trans.float()
    dh = torch.nn.functional.conv2d(g.float().permute(0, 3, 1, 2), wc.float().permute(2, 3, 0, 1),
                                    stride=2, padding=1).permute(0, 2, 3, 1)
    dh = dh.to(z.dtype).float()
    ds = torch.where(s < 0, slope.float() * dh, dh).reshape(n, -1)
    variant = [None, (z.float().t() @ ds).to(wp.dtype), ds.sum(0)]
    want = ops.fused_seed_backward_plain(*args, (False, True, True) + (False,) * 4)[:3]
    return max(v[1] for v in grad_errors(variant, want).values())


def lis_backward_args(batch, code, hidden, dt, gen) -> tuple:
    """(z, w1, b1, slope, trans, w2, g) of one link, g in z's dtype."""
    return (randn((batch, code), gen, 1.0, dt), randn((code, hidden), gen, code**-0.5, dt),
            randn(hidden, gen, 0.1), torch.rand(hidden, generator=gen).cuda() * 0.5,
            randn(hidden, gen, 0.1), randn((hidden, code), gen, hidden**-0.5, dt),
            randn((batch, code), gen, 0.1, dt))


def compare_lis_backward(label: str, dt, args, need) -> tuple:
    """LIS's single-link backward op (`lis_residual_mlp_backward`, the
    chain kernel on a chain of one) against its plain version on `args`
    (z, w1, b1, slope, trans, w2, g): gradients not asked for None, each
    asked for in its input's dtype (db2 fp32), finite, within LIS_BWD_TOL
    of its max, and dz, dw1 and dw2 within LIS_BWD_MEAN_TOL of their mean.
    (largest max-relative error, largest mean-relative error of those
    three, largest |error|)."""
    got = ops.lis_residual_mlp_backward(*args, need)
    want = ops.lis_residual_mlp_backward_plain(*args, need)
    torch.cuda.synchronize()
    likes = (*args[:6], torch.zeros((), device="cuda"))
    for what, k, w, x in zip(LIS_GRADS, got, want, likes):
        if (k is None) != (w is None):
            raise AssertionError(f"lis_residual_mlp_backward {label}: {what} {k} vs {w}")
        if w is not None and (k.dtype != w.dtype or k.dtype != x.dtype or k.shape != w.shape
                              or not torch.isfinite(k).all()):
            raise AssertionError(f"lis_residual_mlp_backward {label} {dt}: {what} {k.dtype} "
                                 f"{tuple(k.shape)} vs {w.dtype} {tuple(w.shape)}, finite "
                                 f"{torch.isfinite(k).all().item()}")
    errs = grad_errors(got, want, LIS_GRADS)
    for what, (rel, mean_rel, _) in errs.items():
        if not (rel <= LIS_BWD_TOL[dt] and (what not in LIS_MEAN_CHECKED
                                            or mean_rel <= LIS_BWD_MEAN_TOL[dt])):
            raise AssertionError(
                f"lis_residual_mlp_backward {label} {dt}: {what} differs by {rel:.3e} of its "
                f"max (tol {LIS_BWD_TOL[dt]}), {mean_rel:.3e} of its mean (tol "
                f"{LIS_BWD_MEAN_TOL[dt]} for {LIS_MEAN_CHECKED})")
    return (max(v[0] for v in errs.values()),
            max([v[1] for k, v in errs.items() if k in LIS_MEAN_CHECKED], default=0.0),
            max(v[2] for v in errs.values()))


def check_lis_chain_smem(label: str, dt, args, needs) -> int:
    """The chain kernel's shared bytes a block (`gea_lis_chain_smem_bytes`,
    its `Layout`) equal the plan's (`lis.chain_smem_bytes`) for the chain
    `args` and `needs` as the op plans it. The bytes."""
    (batch, code), hidden = args[0][0].shape, args[1][0].shape[1]
    bf16 = dt == torch.bfloat16
    plan = ops.lis.backward_plan(batch, code, hidden, bf16, needs, ops.lis._sm_count(0),
                                 ops.lis.resident_clusters(0, bf16))
    cluster, depth = plan.config
    smem = ops.lis._bwd_lib().gea_lis_chain_smem_bytes(plan.code, plan.hidden, plan.links,
                                                       cluster, depth, 2 if plan.bf16 else 4)
    if smem != plan.smem_bytes:
        raise AssertionError(f"lis_chain_backward {label} {dt}: the kernel's layout takes {smem} "
                             f"shared bytes, the plan {plan.smem_bytes}")
    return smem


def lis_near_zero(args) -> tuple:
    """`args` with every even row of z a copy of row 0 and b1 = trans -
    pre of that row (pre exact: fp64, rounded once to fp32), so that those
    rows' s = pre - trans lies within rounding of 0 in every hidden column.
    Also the number of elements whose branch an fp32 product z @ w1 would
    take the other way (the case bites where it is not 0)."""
    z, w1, _, slope, trans, w2, g = args
    z = z.clone()
    z[::2] = z[0]
    b1 = trans - (z[0].double() @ w1.double()).float()
    exact = (z.double() @ w1.double()).float() + b1 - trans < 0
    fp32 = z.float() @ w1.float() + b1 - trans < 0
    return (z, w1, b1, slope, trans, w2, g), int((exact != fp32).sum().item())


def lis_chain_needs(links: int) -> dict:
    """Each path's need sets of a chain of `links` links, first link first:
    G-LIS (the first link's z is drawn), batch norm (no learned slope or
    offset), R-separate's frozen G (dz alone) and every gradient, z0's
    too."""
    no_act = (True, True, True, False, False, True, True)
    return {"G-LIS": [WEIGHTS_ONLY] + [ALL_GRADS] * (links - 1),
            "batch norm": [(False,) + no_act[1:]] + [no_act] * (links - 1),
            "R-separate": [DZ_ONLY] * links, "every gradient": [ALL_GRADS] * links}


def lis_chain_args(batch, code, hidden, links, dt, gen) -> tuple:
    """(zs, w1s, b1s, slopes, transes, w2s, gs) of a chain: each link's
    weights and cotangent as `lis_backward_args`'s, z0 random, each later
    z the link before's output (the plain forward)."""
    cols = [[] for _ in range(7)]
    z = randn((batch, code), gen, 1.0, dt)
    for _ in range(links):
        _, w1, b1, slope, trans, w2, g = lis_backward_args(batch, code, hidden, dt, gen)
        for col, v in zip(cols, (z, w1, b1, slope, trans, w2, g)):
            col.append(v)
        z = ops.lis_residual_mlp_plain(z, w1, b1, slope, trans, w2, randn(code, gen, 0.1))
    return tuple(cols)


def lis_chain_near_zero(args) -> tuple:
    """`args` with each link's inputs made `lis_near_zero`'s case, and the
    fp32 flips summed over the links."""
    cols, flips = [list(c) for c in args], 0
    for j in range(len(args[0])):
        link, f = lis_near_zero(tuple(c[j] for c in cols))
        for c, v in zip(cols, link):
            c[j] = v
        flips += f
    return tuple(cols), flips


def compare_lis_chain(label: str, dt, args, needs) -> tuple:
    """LIS's chain backward kernel against its plain version on `args`
    (`lis_chain_args`) and `needs`. Per link the gradients not asked for
    None (and every dz but the first link's), each asked for in its input's
    dtype (db2 fp32) and finite; a second call equal to the first bit for
    bit. Held to LIS_BWD_TOL of its max against the plain chain; and each
    link, on the cotangent the kernel hands it (T(g + dz), dz from the
    kernel on the links above: its products run in an order that does not
    depend on the plan), against the plain link: within LIS_BWD_TOL of its
    max, dz, dw1 and dw2 within LIS_BWD_MEAN_TOL of their mean. (In bf16 a
    link's dz rounds to the neighbouring value now and then; below it the
    two chains then part by more than a rounding left out would move them,
    so the mean is held link by link.) (largest max-relative error, largest
    mean-relative error of those three, largest |error|, each link against
    the plain link; largest max-relative error against the plain chain)."""
    got = ops.lis_chain_backward(*args, needs)
    again = ops.lis_chain_backward(*args, needs)
    want = ops.lis_chain_backward_plain(*args, needs)
    torch.cuda.synchronize()
    top, worst = len(needs) - 1, [0.0, 0.0, 0.0, 0.0]
    for j, (k_link, a_link, w_link) in enumerate(zip(got, again, want)):
        likes = (*(col[j] for col in args[:6]), torch.zeros((), device="cuda"))
        for what, k, a, w, x in zip(LIS_GRADS, k_link, a_link, w_link, likes):
            if (k is None) != (w is None):
                raise AssertionError(f"lis_chain_backward {label}: link {j} {what} {k} vs {w}")
            if w is None:
                continue
            if (k.dtype != w.dtype or k.dtype != x.dtype or k.shape != w.shape
                    or not torch.isfinite(k).all()):
                raise AssertionError(f"lis_chain_backward {label} {dt}: link {j} {what} "
                                     f"{k.dtype} {tuple(k.shape)} vs {w.dtype} "
                                     f"{tuple(w.shape)}, finite {torch.isfinite(k).all().item()}")
            if not torch.equal(k, a):
                raise AssertionError(f"lis_chain_backward {label} {dt}: link {j} {what}: two "
                                     f"calls differ at {(k != a).sum().item()} elements")
        for what, (rel, _, _) in grad_errors(k_link, w_link, LIS_GRADS).items():
            worst[3] = max(worst[3], rel)
            if not rel <= LIS_BWD_TOL[dt]:
                raise AssertionError(f"lis_chain_backward {label} {dt}: link {j} {what} differs "
                                     f"from the plain chain by {rel:.3e} of its max (tol "
                                     f"{LIS_BWD_TOL[dt]})")
        if not any(needs[j]):
            continue
        cot = args[6][j].to(dt)
        if j < top:  # the kernel's dz of link j + 1, from the chain above
            above = ops.lis_chain_backward(*(col[j + 1:] for col in args),
                                           [DZ_ONLY] * (top - j))
            cot = cot + above[0][0]
        link = ops.lis_residual_mlp_backward_plain(*(col[j] for col in args[:6]), cot, needs[j])
        if j:
            link = (None, *link[1:])
        for what, (rel, mean_rel, abs_err) in grad_errors(k_link, link, LIS_GRADS).items():
            if not (rel <= LIS_BWD_TOL[dt] and (what not in LIS_MEAN_CHECKED
                                                or mean_rel <= LIS_BWD_MEAN_TOL[dt])):
                raise AssertionError(
                    f"lis_chain_backward {label} {dt}: link {j} {what} differs from the plain "
                    f"link by {rel:.3e} of its max (tol {LIS_BWD_TOL[dt]}), {mean_rel:.3e} of "
                    f"its mean (tol {LIS_BWD_MEAN_TOL[dt]} for {LIS_MEAN_CHECKED})")
            worst[0] = max(worst[0], rel)
            worst[1] = max(worst[1], mean_rel if what in LIS_MEAN_CHECKED else 0.0)
            worst[2] = max(worst[2], abs_err)
    return tuple(worst)


def lis_left_out_rounding(args) -> float:
    """What a link's comparison would read (the largest mean-relative
    error of dz, dw1 and dw2) from a kernel that left out the plain
    version's roundings of h and dh_pre to bf16: eager ops on the same
    inputs, pre exact."""
    z, w1, b1, slope, trans, w2, g = args
    s = (z.double() @ w1.double()).float() + b1 - trans
    neg = s < 0
    gf = g.float()
    h = torch.where(neg, slope * s, s) + trans
    dh_pre = (gf @ w2.float().t()) * torch.where(neg, slope, 1.0)
    variant = [(gf + dh_pre @ w1.float().t()).to(z.dtype), (z.float().t() @ dh_pre).to(w1.dtype),
               None, None, None, (h.t() @ gf).to(w2.dtype), None]
    want = ops.lis_residual_mlp_backward_plain(*args, (True, True, False, False, False, True,
                                                       False))
    return max(v[1] for v in grad_errors(variant, want, LIS_GRADS).values())


def check_lis_forward(label: str, dt, args) -> float:
    """The LIS forward at one shape: within TOL of its plain version, two
    calls equal bit for bit, the first min(17, batch) rows in a batch of
    their own equal to the same rows of the full batch bit for bit, and the
    kernel's shared bytes (`gea_lis_smem_bytes`) the plan's."""
    (batch, code), hidden = args[0].shape, args[1].shape[1]
    plan = ops.lis.forward_plan(batch, code, hidden, dt == torch.bfloat16, ops.lis._sm_count(0))
    lib = ops.lis._lib()
    smem = lib.gea_lis_smem_bytes(code, hidden, int(plan.bf16), *plan.config)
    if smem != plan.smem_bytes:
        raise AssertionError(f"lis_residual_mlp {label} {dt}: the kernel's layout takes {smem} "
                             f"shared bytes, the plan {plan.smem_bytes}")
    first = ops.lis_residual_mlp(*args)
    err = compare("lis_residual_mlp", label, dt, first, ops.lis_residual_mlp_plain(*args))
    if not torch.equal(first, ops.lis_residual_mlp(*args)):
        raise AssertionError(f"lis_residual_mlp {label} {dt}: two calls differ")
    n = min(17, batch)
    part = ops.lis_residual_mlp(args[0][:n].contiguous(), *args[1:])
    torch.cuda.synchronize()
    if digest(part) != digest(first[:n]):
        raise AssertionError(f"lis_residual_mlp {label} {dt}: the first {n} rows differ in a "
                             f"batch of {n} from the same rows in the batch of {batch}")
    return err
