"""Model FLOPs of the R-iterative train step, from the configuration's sizes
alone, by `cost.model`'s layer formulas (products only, 2 FLOPs a
multiply-add, forward and the backward that the losses need, nothing
recomputed).

G is G-LIS's core (one stage, no LIS link), D as in G-LIS, and R is D's
conv trunk followed by a dense head code_in -> r_hidden -> code. With T =
r_chain_length links and batch B, a step:

* D's half: the chain unrolled without gradients (T + 1 renders, T R
  passes); D over the reals and every render ((T + 2) B rows: forward, the
  weight gradients and the data gradients below the first layer);
* G's and R's half: the chain unrolled again (T + 1 renders, T R passes);
  the updated D over every render, forward and the data gradients through
  every layer (no weight gradient of D); G's weight gradients and the data
  gradients of every conv for each render and of the projection for the T
  renders whose code R made; R's weight and data gradients, through every
  layer, for each of its T passes.
"""

from __future__ import annotations

from typing import Dict

from portbench.cost.model import core_layers, disc_layers, generator_plan


def reverter_layers(m: Dict) -> int:
    """Forward FLOPs of one image through R: D's convs, then fc1 and fc2."""
    s0, _ = generator_plan(m["image_size"])
    trunk = disc_layers(m)[:-1]
    out = s0 * s0 * min(m["num_features"] * 2 ** (len(trunk) - 1), m["max_features"])
    hidden = m.get("r_hidden", 512)
    return sum(trunk) + 2 * out * hidden + 2 * hidden * m["code_size"]


def r_iterative_step_flops(m: Dict, batch: int) -> int:
    t = int(m["r_chain_length"])
    core, disc, rev = core_layers(m), disc_layers(m), reverter_layers(m)
    unroll = (t + 1) * batch * sum(core) + t * batch * rev
    d_rows = (t + 2) * batch
    d_half = unroll + d_rows * sum(disc) * 2 + d_rows * sum(disc[1:])
    renders = (t + 1) * batch
    g_bwd = renders * sum(core) + renders * sum(core[1:]) + t * batch * core[0]
    gr_half = unroll + renders * sum(disc) * 2 + g_bwd + t * batch * rev * 2
    return d_half + gr_half
