"""Model FLOPs of the G-LIS train step and of a scored render, from the
configuration's sizes alone.

Counted: the products of the dense layers and of the convolutions (2
FLOPs a multiply-add), forward and the backward that the losses need, with
nothing recomputed. A 4x4 stride-2 conv or transposed conv counts only the
(output pixel, tap) pairs that read inside the map; the taps that fall on
the padding add zeros. Elementwise work (activations, weight norm, tanh,
the losses, Adam) is not counted.

The layers are those of arXiv:1707.00768's G-LIS as `gea` builds them: a
chain of LIS links (code -> hidden -> code) whose every stage is rendered
by one core (a dense projection to s0 x s0 x c0, then transposed convs
doubling the side, the spatial noise joined before the second), and a
discriminator of stride-2 convs with a dense head.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Layer = Tuple[str, int, int, int, int]  # (kind, rows or input side, cin, cout, fwd FLOPs/image)


def generator_plan(image_size: int) -> Tuple[int, int]:
    """(base side s0, number of doublings d): 80 -> (5, 4), 160 -> (5, 5)."""
    s, d = image_size, 0
    while s % 2 == 0 and s // 2 >= 4:
        s //= 2
        d += 1
    if s * (2 ** d) != image_size or d == 0:
        raise ValueError(f"unsupported image_size {image_size}")
    return s, d


def convt_flops(side_in: int, cin: int, cout: int) -> int:
    """One image through a 4x4 stride-2 transposed conv, side -> 2 side."""
    return 2 * (4 * side_in - 2) ** 2 * cin * cout


def conv_flops(side_in: int, cin: int, cout: int) -> int:
    """One image through a 4x4 stride-2 conv, side -> side / 2."""
    return 2 * (2 * side_in - 2) ** 2 * cin * cout


def core_layers(m: Dict) -> List[int]:
    """Forward FLOPs of one image through each layer of G's core, in
    order: the projection, then each transposed conv."""
    s0, d = generator_plan(m["image_size"])
    nf, cap, sc = m["num_features"], m["max_features"], m.get("spatial_code", 0)
    c0 = min(nf * 2 ** (d - 1), cap)
    out = [2 * m["code_size"] * s0 * s0 * c0]
    ch, side = c0, s0
    for i in range(1, d):
        ci = min(nf * 2 ** (d - 1 - i), cap)
        out.append(convt_flops(side, ch + (sc if i == 2 else 0), ci))
        ch, side = ci, side * 2
    out.append(convt_flops(side, ch + (sc if d == 2 else 0), 3))
    return out


def disc_layers(m: Dict) -> List[int]:
    """Forward FLOPs of one image through each layer of D, in order: the
    convs, then the dense head."""
    s0, d = generator_plan(m["image_size"])
    nf, cap = m["num_features"], m["max_features"]
    out, ch, side = [], 3, m["image_size"]
    for i in range(d):
        ci = min(nf * 2 ** i, cap)
        out.append(conv_flops(side, ch, ci))
        ch, side = ci, side // 2
    out.append(2 * s0 * s0 * ch)
    return out


def lis_link_flops(m: Dict, rows: int) -> int:
    """One LIS link forward over `rows` codes: two products."""
    code = m["code_size"]
    return 2 * 2 * rows * code * code * m.get("lis_hidden_mult", 1)


def n_stages(m: Dict) -> int:
    r = m["r_iterations"]
    return 1 if r == 0 else r + (1 if m.get("include_initial_image", True) else 0)


def train_step_flops(m: Dict, batch: int) -> int:
    """One alternating step (`gea`'s G-LIS step): G renders every stage of
    the batch once; D's step runs D over the reals and all fakes and takes
    D's weight gradients (and the data gradients below its first layer); G's
    step runs the updated D over the fakes, takes the image gradients
    through every layer of D, then G's weight gradients and the data
    gradients of the core (of the projection only for the stages whose code
    a LIS link made) and of the LIS links above the first."""
    s = n_stages(m)
    fakes = s * batch
    core, disc = core_layers(m), disc_layers(m)
    link = lis_link_flops(m, batch)
    r = m["r_iterations"]
    g_fwd = r * link + fakes * sum(core)
    d_rows = (1 + s) * batch
    d_step = d_rows * sum(disc) * 2 + d_rows * sum(disc[1:])  # fwd, dW, dx below the first
    g_step_d = fakes * sum(disc) * 2  # fwd, dx through every layer
    proj_dx_rows = (s - (1 if s > r else 0)) * batch  # z0's stage has no code gradient
    g_bwd = fakes * sum(core) + fakes * sum(core[1:]) + proj_dx_rows * core[0]
    # Each link: dW2, dh, dW1, and dz for every link but the first.
    g_bwd += r * 3 * (link // 2) + max(r - 1, 0) * (link // 2)
    return g_fwd + d_step + g_step_d + g_bwd


def render_flops(m: Dict, candidates: int) -> int:
    """Useful FLOPs of scoring `candidates` codes: the LIS chain, the
    final stage's render and D's score of it, a candidate."""
    return (m["r_iterations"] * lis_link_flops(m, candidates)
            + candidates * (sum(core_layers(m)) + sum(disc_layers(m))))


def render_executed_flops(m: Dict, candidates: int, stages: int) -> int:
    """FLOPs of a render that draws `stages` stages a candidate and scores
    the final one (for the share of work thrown away)."""
    return (m["r_iterations"] * lis_link_flops(m, candidates)
            + candidates * (stages * sum(core_layers(m)) + sum(disc_layers(m))))
