"""The LIS chain's backward in the port: the custom op
`gea_torch::lis_chain_backward` (one CUDA kernel call for a chain of links on
the card; its plain version, `lis_chain_backward_plain`, on the CPU, which
is what runs here), `LISChain` and the host plan of the kernel
(`gea_torch.ops.lis.backward_plan`), against `gea`'s `custom_vjp` of the
Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerances. fp32: the plain backward against `jax.vjp` through the chain of
`gea`'s links, rtol 1e-4 / atol 1e-5, as `tests/test_torch_port_grads.py`
holds the Function (the two sum in other orders). bf16 (z, the weights and
g in bf16, as the generator passes them): each link against `gea`'s `_bwd`
in fp32 on the same rounded inputs, the links composed in fp32 from the
last down with each cotangent rounded as the chain rounds it (T(g + T(dz)),
T() to bf16): dz, dw1 and dw2 within 2^-6 of their max, as
`tests/test_torch_port_lis_backward.py` holds a link; the sums (db1,
dslope, dtrans, db2) within 1e-5 of their max at the last link, whose
cotangent is g on both sides, and within 2^-6 below it, where a
cotangent's elements may sit one bf16 step apart (the T(dz) rounded from
the port's dz against the one rounded from `gea`'s). The CPU op runs the
plain version and `LISChain` autograd's own composition, so those are
equal bit for bit. The kernel itself runs only on the card
(`tests/test_torch_port_kernels_card.py`).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gea.ops.pallas.lis import _bwd as jax_link_bwd
from gea.ops.pallas.lis import lis_residual_mlp as jax_lis
from gea_torch import ops
from gea_torch.ops import build, lis
from gea_torch.ops.lis import (
    CHAIN_ROWS,
    backward_plan,
    chain_smem_bytes,
    check_chain_needs,
)

NAMES = ("dz", "dw1", "db1", "dslope", "dtrans", "dw2", "db2")
ALL, DZ = (True,) * 7, (True,) + (False,) * 6
WEIGHTS = (False,) + (True,) * 6
NO_ACT = (True, True, True, False, False, True, True)  # batch norm: no learned slope or offset


def chain_needs(links: int) -> dict:
    """Each path's per-link need sets, first link first (as
    `torch_port_card_cases.lis_chain_needs`)."""
    return {"g-lis": [WEIGHTS] + [ALL] * (links - 1),
            "batch-norm": [(False,) + NO_ACT[1:]] + [NO_ACT] * (links - 1),
            "r-separate": [DZ] * links, "every": [ALL] * links}


SHAPES = [(5, 16, 32), (13, 24, 40)]  # batch, code, hidden; the second ragged
CASES = [(shape, links, need) for shape in SHAPES for links in (1, 2, 3)
         for need in chain_needs(links)]


def case_id(case):
    (b, c, h), links, need = case
    return f"{b}-{c}-{h}-x{links}-{need}"


def chain_inputs(shape, links, seed=0):
    """z0, each link's (w1, b1, slope, trans, w2, b2) and a cotangent for
    every output, float32 numpy from a seed."""
    batch, code, hidden = shape
    rng = np.random.default_rng(seed + 7 * links + sum(shape))
    z0 = rng.standard_normal((batch, code)).astype(np.float32)
    params, gs = [], []
    for _ in range(links):
        params.append([rng.standard_normal((code, hidden)) * code**-0.5,
                       rng.standard_normal(hidden) * 0.1, rng.random(hidden) * 0.5,
                       rng.standard_normal(hidden) * 0.1,
                       rng.standard_normal((hidden, code)) * hidden**-0.5,
                       rng.standard_normal(code) * 0.1])
        params[-1] = [a.astype(np.float32) for a in params[-1]]
        gs.append(rng.standard_normal((batch, code)).astype(np.float32))
    return z0, params, gs


def jax_forward(z0, params):
    """Each link's input, from `gea`'s kernel in interpret mode."""
    zs = [z0]
    for p in params[:-1]:
        zs.append(np.array(jax_lis(jnp.asarray(zs[-1]), *map(jnp.asarray, p), True)))
    return zs


def port_args(zs, params, gs, dtype=None):
    """The op's list arguments (zs, w1s, b1s, slopes, transes, w2s, gs) as
    tensors; z, the weights and g in `dtype` where given."""
    t = torch.from_numpy
    cast = (lambda x: t(x).to(dtype)) if dtype is not None else t
    return ([cast(z) for z in zs], [cast(p[0]) for p in params],
            [t(p[1]) for p in params], [t(p[2]) for p in params], [t(p[3]) for p in params],
            [cast(p[4]) for p in params], [cast(g) for g in gs])


def gea_chain_vjp(z0, params, gs):
    """`jax.vjp` through the chain of `gea`'s links (interpret mode), a
    cotangent on every output: per link [dz, dw1, db1, dslope, dtrans, dw2,
    db2] (dz of the link's input)."""
    def chain(z, *flat):
        outs = []
        for j in range(len(params)):
            z = jax_lis(z, *flat[6 * j:6 * j + 6], True)
            outs.append(z)
        return tuple(outs)

    flat = [jnp.asarray(a) for p in params for a in p]
    _, vjp = jax.vjp(chain, jnp.asarray(z0), *flat)
    grads = [np.asarray(g) for g in vjp(tuple(jnp.asarray(g) for g in gs))]
    return [[grads[0] if j == 0 else None] + grads[1 + 6 * j:7 + 6 * j]
            for j in range(len(params))]


def round_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def gea_links_bf16(zs, params, gs):
    """`gea`'s `_bwd` link by link in fp32 on the inputs rounded to bf16,
    from the last link down, each cotangent T(g + T(dz of the link above))
    with T() to bf16: per link its seven gradients."""
    out, dz = [None] * len(zs), None
    for j in range(len(zs) - 1, -1, -1):
        p = params[j]
        res = [jnp.asarray(round_bf16(zs[j])), jnp.asarray(round_bf16(p[0])), jnp.asarray(p[1]),
               jnp.asarray(p[2]), jnp.asarray(p[3]), jnp.asarray(round_bf16(p[4]))]
        g = round_bf16(gs[j]) if dz is None else round_bf16(round_bf16(gs[j]) + round_bf16(dz))
        grads = [np.asarray(x) for x in jax_link_bwd(True, res, jnp.asarray(g))]
        out[j], dz = grads, grads[0]
    return out


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_matches_gea_chain_vjp(case):
    shape, links, need = case
    needs = chain_needs(links)[need]
    z0, params, gs = chain_inputs(shape, links)
    zs = jax_forward(z0, params)
    got = ops.lis_chain_backward_plain(*port_args(zs, params, gs), needs)
    want = gea_chain_vjp(z0, params, gs)
    for j, (g_link, w_link, n_link) in enumerate(zip(got, want, needs)):
        for i, (name, g, w, n) in enumerate(zip(NAMES, g_link, w_link, n_link)):
            if not n or (i == 0 and j > 0):
                assert g is None, (j, name)
                continue
            assert g.shape == w.shape and g.dtype == torch.float32, (j, name)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=f"{j} {name}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bf16_plain_against_gea_links(case):
    shape, links, need = case
    needs = chain_needs(links)[need]
    z0, params, gs = chain_inputs(shape, links)
    zs = [round_bf16(z) for z in jax_forward(z0, params)]
    got = ops.lis_chain_backward_plain(*port_args(zs, params, gs, torch.bfloat16), needs)
    want = gea_links_bf16(zs, params, gs)
    for j, (g_link, w_link, n_link) in enumerate(zip(got, want, needs)):
        for i, (name, g, w) in enumerate(zip(NAMES, g_link, w_link)):
            if not n_link[i] or (i == 0 and j > 0):
                assert g is None, (j, name)
                continue
            assert g.dtype == (torch.bfloat16 if i in (0, 1, 5) else torch.float32), (j, name)
            err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
            tol = 2**-6 if i in (0, 1, 5) or j < links - 1 else 1e-5
            assert err <= tol, (j, name, err, tol)


def leaves_of(zs, params, needs, dtype=torch.float32):
    """z0 and each link's (w1, b1, slope, trans, w2, b2) as leaves that
    require grad where `needs` asks for their gradient."""
    z0 = torch.from_numpy(zs[0]).to(dtype).requires_grad_(needs[0][0])
    links = []
    for p, need in zip(params, needs):
        t = [torch.from_numpy(a) for a in p]
        t[0], t[4] = t[0].to(dtype), t[4].to(dtype)
        links.append([x.requires_grad_(n) for x, n in zip(t, need[1:])])
    return z0, links


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", ["g-lis", "batch-norm", "r-separate", "every"])
def test_chain_function_matches_autograd_through_links(need, dtype):
    """`LISChain` against autograd through the per-link `LISResidualMLP`,
    cotangents on every output: the same plain backwards, composed by the
    chain and by the engine, equal bit for bit."""
    links = 3
    needs = chain_needs(links)[need]
    z0n, params, gs = chain_inputs(SHAPES[1], links)
    zs = jax_forward(z0n, params)
    cots = [torch.from_numpy(g).to(dtype) for g in gs]
    grads = []
    for chained in (True, False):
        z0, leaves = leaves_of(zs, params, needs, dtype)
        if chained:
            outs = lis.lis_chain(z0, leaves)
            assert type(outs[0].grad_fn).__name__ == "LISChainBackward"
        else:
            outs, z = [], z0
            for link in leaves:
                z = ops.lis_residual_mlp(z, *link)
                outs.append(z)
        wrt = [x for x in (z0, *(t for link in leaves for t in link)) if x.requires_grad]
        grads.append(torch.autograd.grad(outs, wrt, cots))
    assert len(grads[0]) == sum(map(sum, needs)) - sum(n[0] for n in needs[1:])
    for a, b in zip(*grads):
        assert a.dtype == b.dtype and torch.equal(a, b)


def op_args(links=2, dtype=None):
    z0, params, gs = chain_inputs(SHAPES[1], links)
    return port_args(jax_forward(z0, params), params, gs, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need", ["g-lis", "batch-norm", "r-separate", "every"])
def test_cpu_op_is_the_plain_version(need, dtype):
    """The op on the CPU equals the plain version bit for bit and returns
    empty tensors for every gradient not asked for and every dz below the
    first link's."""
    args = op_args(2, dtype)
    needs = chain_needs(2)[need]
    raw = torch.ops.gea_torch.lis_chain_backward(*args, [n for need in needs for n in need])
    want = ops.lis_chain_backward_plain(*args, needs)
    flat = [d for link in want for d in link]
    assert len(raw) == len(flat) == 14
    for r, w in zip(raw, flat):
        if w is None:
            assert r.numel() == 0
        else:
            assert r.dtype == w.dtype and torch.equal(r, w)
    wrapped = ops.lis_chain_backward(*args, needs)
    assert [[d is None for d in link] for link in wrapped] == [[d is None for d in link]
                                                                for link in want]


@pytest.mark.parametrize("need", ["g-lis", "r-separate", "every"])
def test_fake_gives_shapes_and_dtypes(need):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = op_args(3, torch.bfloat16)
    needs = chain_needs(3)[need]
    with FakeTensorMode() as mode:
        fake = [[mode.from_tensor(v) for v in col] for col in args]
        out = torch.ops.gea_torch.lis_chain_backward(*fake, [n for need in needs for n in need])
    batch, code = args[0][0].shape
    for j, need_j in enumerate(needs):
        likes = [(t.dtype, t.shape) for t in (args[0][j], args[1][j], args[2][j], args[3][j],
                                            args[4][j], args[5][j])] + [(torch.float32, (code,))]
        for i, (n, (dtype, shape)) in enumerate(zip(need_j, likes)):
            o = out[7 * j + i]
            asked = n and (i or not j)
            assert o.dtype == dtype and o.shape == (shape if asked else (0,)), (j, i)


@pytest.mark.parametrize("need", ["g-lis", "every"])
def test_opcheck(need):
    args = op_args(2)
    torch.library.opcheck(torch.ops.gea_torch.lis_chain_backward.default,
                          (*args, [n for need in chain_needs(2)[need] for n in need]))


def test_batch_zero():
    """No rows: zero gradients of the weights and vectors, an empty dz."""
    z0, params, gs = chain_inputs((0, 16, 32), 2)
    args = port_args([z0, z0], params, gs)
    got = ops.lis_chain_backward(*args, chain_needs(2)["every"])
    assert got[0][0].shape == (0, 16) and got[1][0] is None
    for link in got:
        for g in link[1:]:
            assert g is not None and not g.any()


def test_second_derivative_raises():
    z0, params, _ = chain_inputs(SHAPES[0], 2)
    z, leaves = leaves_of([z0], params, chain_needs(2)["every"])
    outs = lis.lis_chain(z, leaves)
    (dz,) = torch.autograd.grad(sum((o**2).sum() for o in outs), [z], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dz.sum().backward()


def test_inconsistent_needs_raise():
    """A link's dz flag is whether anything below it asks for a gradient."""
    check_chain_needs([WEIGHTS, ALL])
    with pytest.raises(ValueError, match="link 1"):
        check_chain_needs([WEIGHTS, WEIGHTS])
    with pytest.raises(ValueError, match="link 1"):
        check_chain_needs([(False,) * 7, DZ])


def test_generator_runs_the_chain_only_when_recording():
    """G's LIS links run as one chain where gradients are recorded, and one
    node a link (as exported) under no_grad; the same outputs."""
    from gea_torch.config import TrainGLISConfig
    from gea_torch.interop import generator_from_jax_params, init_generator_params

    cfg = TrainGLISConfig(image_size=16, code_size=16, num_features=4, max_features=16,
                          dtype="float32", r_iterations=3)
    g = generator_from_jax_params(init_generator_params(cfg, 0), cfg, device="cpu")
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32))
    _, zs = g(z)
    assert type(zs.grad_fn).__name__ == "StackBackward0"
    nodes = {type(n).__name__ for n in _walk(zs.grad_fn)}
    assert "LISChainBackward" in nodes and "LISResidualMLPBackward" not in nodes
    with torch.no_grad():
        _, zs_ng = g(z)
    assert torch.equal(zs.detach(), zs_ng)


def _walk(fn, seen=None):
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return seen
    seen.add(fn)
    for nxt, _ in fn.next_functions:
        _walk(nxt, seen)
    return seen


# ------------------------------------------------------------------ the plan

# The shapes the card modules run (the kernels' cases, the train steps at
# batch 64 and their TP ranks at 32):
# (batch, code, hidden).
PLAN_SHAPES = [(64, 256, 256), (32, 256, 256), (1, 256, 256), (17, 256, 256), (30, 256, 256),
               (33, 256, 256), (128, 256, 256), (64, 256, 512), (1, 256, 512), (30, 40, 48),
               (5, 16, 32)]
SMS = (1, 7, 132)
RESIDENT = {"none": (), "h100": ((8, 16), (16, 7)), "few": ((8, 2), (16, 1)),
            "wide": ((8, 4), (16, 8))}
PLAN_CASES = [(shape, bf16, links, need)
              for shape in PLAN_SHAPES for bf16 in (True, False) for links in (1, 2, 3)
              for need in ("g-lis", "r-separate", "every")]


def plan_id(case):
    shape, bf16, links, need = case
    return f"{'x'.join(map(str, shape))}-{'bf16' if bf16 else 'fp32'}-x{links}-{need}"


def _partition(width, parts, size):
    """Each of `parts` blocks' [q size, (q + 1) size) cut to [0, width)."""
    return [(q * size, min(width, (q + 1) * size)) for q in range(parts)
            if q * size < width]


@pytest.mark.parametrize("case", PLAN_CASES, ids=plan_id)
def test_each_row_group_and_slot_is_taken_once(case):
    """At each SM count and each count of resident clusters."""
    for sms, res in itertools.product(SMS, RESIDENT):
        check_plan(*case, sms, res)


def check_plan(shape, bf16, links, need, sms, res):
    batch, code, hidden = shape
    needs = chain_needs(links)[need]
    plan = backward_plan(batch, code, hidden, bf16, needs, sms, RESIDENT[res])
    cluster, depth = plan.config
    assert cluster in (8, 16) and 1 <= depth <= 4
    assert plan.smem_bytes <= lis.SMEM_LIMIT < build.SMEM_LIMIT
    assert plan.smem_bytes == chain_smem_bytes(code, hidden, links, cluster, depth,
                                               2 if bf16 else 4)
    held = dict(RESIDENT[res])
    if any(plan.groups <= n for n in held.values()):  # a cluster size holds every row group
        assert plan.groups <= held.get(cluster, 0)

    # Every row once, in groups of at most CHAIN_ROWS, one cluster each.
    rows = [r for r0, n in plan.row_groups() for r in range(r0, r0 + n)]
    assert rows == list(range(batch)) and len(plan.row_groups()) == plan.groups
    assert all(0 < n <= CHAIN_ROWS for _, n in plan.row_groups())

    # Each block's columns: hidden slices and output slices cover each
    # width once.
    wh = -(-(-(-hidden // cluster)) // 16) * 16
    wo = -(-(-(-code // cluster)) // 16) * 16
    for width, size in ((hidden, wh), (code, wo)):
        cols = [c for lo, hi in _partition(width, cluster, size) for c in range(lo, hi)]
        assert cols == list(range(width))

    # Every gradient asked for has its slots, one a row group, back to back
    # and apart from every other; none for what is not asked.
    slots, sizes = plan.slots(), plan.sizes()
    spans = []
    for j, need_j in enumerate(needs):
        for k in range(6):
            assert ((j, k) in slots) == need_j[1 + k]
            if need_j[1 + k]:
                spans += [(slots[(j, k)] + r * sizes[k], slots[(j, k)] + (r + 1) * sizes[k])
                          for r in range(plan.groups)]
    spans.sort()
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert (spans[0][0] if spans else 0) == 0 and (spans[-1][1] if spans else 0) == plan.part_floats
    assert all(s % 4 == 0 for span in spans for s in span)  # the reduce reads 4 floats at once

    # The launches: the chain kernel, and the reduce where anything is summed.
    assert plan.launches()[0].startswith("lis_chain_kernel")
    assert (plan.launches()[1:] == ["lis_chain_reduce"]) == bool(slots)
    assert (plan.reduce_blocks >= 1) == bool(slots)
    dims = plan.dims([(False, False)] * links)
    assert dims[:10] == [links, plan.first, batch, code, hidden, int(bf16), cluster, depth,
                         plan.groups, plan.reduce_blocks]
    assert len(dims) == 10 + 9 * links
    for j in range(links):
        assert dims[10 + 9 * j + 3:10 + 9 * (j + 1)] == [slots.get((j, k), -1) for k in range(6)]


def test_first_is_the_lowest_link_asked():
    plan = backward_plan(64, 256, 256, True, [(False,) * 7, (False,) * 7, WEIGHTS], 132)
    assert plan.first == 2 and plan.dims([(False, False)] * 3)[1] == 2
    assert backward_plan(64, 256, 256, True, [WEIGHTS, ALL], 132).first == 0


def test_too_wide_has_no_config():
    assert backward_plan(64, 4096, 4096, True, [ALL], 132).config is None


@pytest.mark.parametrize("links,bf16", itertools.product((1, 3), (True, False)))
def test_flagship_plan_is_resident_on_an_h100(links, bf16):
    """At the flagship (batch 64, code = hidden = 256) every row group's
    cluster is resident at once on an H100's occupancy (16 clusters of 8,
    7 of 16), with a ring of 2 slots or more (a link's operands land while
    the one above is walked)."""
    plan = backward_plan(64, 256, 256, bf16, chain_needs(links)["g-lis"], 132,
                         RESIDENT["h100"])
    cluster, depth = plan.config
    assert plan.groups == 4 and depth >= 2 and plan.groups <= dict(RESIDENT["h100"])[cluster]
