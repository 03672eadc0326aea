"""The yardstick on the CPU: the model FLOPs of a train step and of a
render against `torch.utils.flop_counter.FlopCounterMode` over the plain
reference, and each kernel's bound at the flagship against the bounds that
PERF.md's kernel table gives a G-LIS step.

Where the counts differ, the difference is the yardstick's by design and is
added back here before comparing:

* the 4x4 stride-2 convs and transposed convs: the counter counts every
  tap, the yardstick only the (output pixel, tap) pairs that read inside
  the map (the others add the padding's zeros);
* the projection's data gradient for the stage whose code is z itself:
  autograd computes it for the stacked codes of every stage, but nothing
  upstream needs the gradient of the noise.
"""

import itertools

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import benchcopy  # noqa: F401  (the checkout's root on the path)
from portbench import reference
from portbench.cost import kernels, model

SMALL = dict(image_size=32, code_size=16, r_iterations=3, num_features=8, max_features=32,
             lis_hidden_mult=1, spatial_code=0, include_initial_image=True)


def brute_pairs(side_in: int, transposed: bool) -> int:
    """(output pixel, tap) pairs of a 4x4 stride-2 padding-1 layer whose
    input index lies inside the map, counted one by one along one axis and
    squared."""
    n = 0
    if transposed:  # output o = 2 i - 1 + k
        for i, k in itertools.product(range(side_in), range(4)):
            n += 0 <= 2 * i - 1 + k < 2 * side_in
    else:  # input i = 2 o - 1 + k
        for o, k in itertools.product(range(side_in // 2), range(4)):
            n += 0 <= 2 * o - 1 + k < side_in
    return n * n


@pytest.mark.parametrize("side", [4, 5, 8, 10, 20, 40, 80])
def test_inside_taps(side):
    assert model.convt_flops(side, 1, 1) == 2 * brute_pairs(side, True)
    assert kernels.conv_pairs(side) == brute_pairs(side, True)
    if side % 2 == 0:
        assert model.conv_flops(side, 1, 1) == 2 * brute_pairs(side, False)


def full_taps(monkeypatch):
    """The yardstick with every tap counted, as the counter counts them."""
    monkeypatch.setattr(model, "convt_flops", lambda s, ci, co: 2 * 16 * s * s * ci * co)
    monkeypatch.setattr(model, "conv_flops", lambda s, ci, co: 2 * 16 * (s // 2) ** 2 * ci * co)


def weights(m, seed=0):
    from portbench.weights import make_weights

    shapes = reference_shapes(m)
    return make_weights(shapes, seed, torch.device("cpu"))


def reference_shapes(m):
    """(name, shape) of G's and D's parameters, with "g." and "d." before
    the names, from the sizes alone."""
    s0, d = model.generator_plan(m["image_size"])
    nf, cap, code = m["num_features"], m["max_features"], m["code_size"]
    hidden = code * m["lis_hidden_mult"]
    out = []

    def wn(prefix, shape, out_dim):
        g = [1] * len(shape)
        g[out_dim] = shape[out_dim]
        out.extend([(prefix + ".weight_v", shape), (prefix + ".weight_g", tuple(g)),
                    (prefix + ".bias", (shape[out_dim],))])

    def act(prefix, ch):
        out.extend([(prefix + ".a", (ch,)), (prefix + ".b", (ch,))])

    c0 = min(nf * 2 ** (d - 1), cap)
    wn("g.project", (s0 * s0 * c0, code), 0)
    act("g.project_act", c0)
    ch = c0
    for i in range(1, d):
        ci = min(nf * 2 ** (d - 1 - i), cap)
        wn(f"g.ups.{i - 1}.conv", (ch + (m["spatial_code"] if i == 2 else 0), ci, 4, 4), 1)
        act(f"g.ups.{i - 1}.act", ci)
        ch = ci
    wn("g.to_rgb", (ch, 3, 4, 4), 1)
    for j in range(m["r_iterations"]):
        wn(f"g.lis.{j}.fc1", (hidden, code), 0)
        act(f"g.lis.{j}.act", hidden)
        wn(f"g.lis.{j}.fc2", (code, hidden), 0)
    ch = 3
    for i in range(d):
        ci = min(nf * 2 ** i, cap)
        wn(f"d.trunk.downs.{i}.conv", (ci, ch, 4, 4), 0)
        if i:
            act(f"d.trunk.downs.{i}.act", ci)
        ch = ci
    wn("d.head", (1, ch * s0 * s0), 0)
    return out


def split(w):
    return ({k[2:]: v for k, v in w.items() if k.startswith("g.")},
            {k[2:]: v for k, v in w.items() if k.startswith("d.")})


def test_train_step_flops(monkeypatch):
    m, batch = SMALL, 4
    g, d = split(weights(m))
    gen = torch.Generator().manual_seed(0)
    real = torch.rand((batch, m["image_size"], m["image_size"], 3), generator=gen) * 2 - 1
    z = torch.randn((batch, m["code_size"]), generator=gen)
    hp = dict(lr=2e-4, beta1=0.5, beta2=0.999)
    with FlopCounterMode(display=False) as counter:
        reference.train_steps(g, d, [real], [z], [None], m, hp)
    full_taps(monkeypatch)
    s0, dd = model.generator_plan(m["image_size"])
    c0 = min(m["num_features"] * 2 ** (dd - 1), m["max_features"])
    stage0_proj_dx = 2 * batch * m["code_size"] * s0 * s0 * c0
    assert counter.get_total_flops() == model.train_step_flops(m, batch) + stage0_proj_dx


@pytest.mark.parametrize("spatial_code", [0, 2])
def test_render_flops(monkeypatch, spatial_code):
    m, n = dict(SMALL, spatial_code=spatial_code), 6
    g, d = split(weights(m))
    gen = torch.Generator().manual_seed(1)
    z = torch.randn((n, m["code_size"]), generator=gen)
    s0, _ = model.generator_plan(m["image_size"])
    sn = torch.randn((n, 2 * s0, 2 * s0, spatial_code), generator=gen) if spatial_code else None
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        reference.score(d, reference.render_final(g, z, sn, m), m)
    full_taps(monkeypatch)
    assert counter.get_total_flops() == model.render_flops(m, n)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def flagship_calls():
    """The calls one flagship G-LIS step makes into the three ops (batch 64,
    4 stages, bf16): TPReLU after G's up1..up3 on the 256 stacked fakes and
    after D's down1..down3 on the D step's 320 images and the G step's 256,
    each differentiated; three LIS links and their chain's backward; the
    seed on the 256 codes and its backward."""
    s, b, f32 = 4, 64, torch.float32
    acts = [(s * b * side * side, ch) for side, ch in ((10, 256), (20, 128), (40, 64))]
    for side, ch in ((20, 128), (10, 256), (5, 512)):
        acts += [((1 + s) * b * side * side, ch), (s * b * side * side, ch)]
    calls = {"tprelu": [], "tprelu_backward": []}
    for rows, ch in acts:
        x, a = meta(rows, ch), meta(ch, dtype=f32)
        calls["tprelu"].append((x, a, a))
        calls["tprelu_backward"].append((x, a, a, x, True))
    link = (meta(b, 256), meta(256, 256), meta(256), meta(256), meta(256), meta(256, 256),
            meta(256))
    calls["lis"] = [link] * 3
    needs = [(False,) + (True,) * 6, (True,) * 7, (True,) * 7]
    calls["lis_chain_backward"] = [([link[0]] * 3, [link[1]] * 3, None, None, None,
                                    [link[5]] * 3, [link[0]] * 3, needs)]
    seed = (meta(s * b, 256), meta(256, 12800), meta(12800), meta(512), meta(512),
            meta(4, 4, 512, 256), meta(256))
    calls["seed"] = [(*seed, 5)]
    calls["seed_backward"] = [(*seed, meta(s * b, 10, 10, 256), 5, (True,) * 7)]
    return calls


# PERF.md's kernel table: bound ms a flagship G-LIS step, and what bounds it.
PERF_BOUNDS = {"tprelu": (0.1164, "bytes"), "tprelu_backward": (0.1746, "bytes"),
               "lis": (0.0003, "bytes"), "lis_chain_backward": (0.0005, "bytes"),
               "seed": (0.0237, "operations"), "seed_backward": (0.0491, "operations")}


@pytest.mark.parametrize("op", sorted(PERF_BOUNDS))
def test_flagship_bounds(op):
    total, bys = 0.0, set()
    for args in flagship_calls()[op]:
        ms, by = kernels.call_bound_ms(op, args)
        total += ms
        bys.add(by)
    want, by = PERF_BOUNDS[op]
    assert round(total, 4) == want
    assert bys == {by}
