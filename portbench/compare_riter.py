"""The numbers that decide `correct` for R-iterative training: the first
replay of the K-step graph that the window then replays, from the seed's
weights, against K steps of `reference.riter` on the same batches and
draws, over the three players G, D and R.

The numbers are `compare.train_numbers`'s, with R's leaves beside G's and
D's and the similarity term beside the two losses:

* `loss_gap`: the largest |program - reference| / |reference| of each
  step's `loss_d`, `loss_g` and `loss_r_sim`;
* `moment_median_diff`, `moment_kernel_diff`: Adam's first moment after the
  chunk, leaf by leaf (`compare.leaf_diffs`), the median leaf and the worst
  of the leaves that the hand-written ops take (`compare.kernel_leaf`: the
  seed's projection, activation and first transposed conv, every TPReLU,
  R's head activation among them);
* `change_gap`: the worst leaf's change over the chunk (`compare.leaf_gaps`).

Leaves whose reference gradient at step one is under `compare.LEAF_FLOOR`
of the median leaf's are left out, as in `compare`.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import compare

PLAYERS = ("g", "d", "r")
LOSSES = ("loss_d", "loss_g", "loss_r_sim")


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """{"moment_diff", "moment_gap", "change"}: {"<player>.<leaf>": number}."""
    out: Dict[str, Dict[str, float]] = {"moment_diff": {}, "moment_gap": {}, "change": {}}
    for who in PLAYERS:
        keep = compare.kept_leaves(ref["grads1"][who])
        pm, rm = prog["moments"][who], ref["moments"][who]
        for k, v in compare.leaf_diffs(pm, rm, keep).items():
            out["moment_diff"][f"{who}.{k}"] = v
        for k, v in compare.leaf_gaps(pm, rm, keep).items():
            out["moment_gap"][f"{who}.{k}"] = v
        p0 = ref["params0"][who]
        dp = {k: prog["params"][who][k].float() - p0[k].float() for k in keep}
        dr = {k: ref["params"][who][k].float() - p0[k].float() for k in keep}
        for k, v in compare.leaf_gaps(dp, dr, keep).items():
            out["change"][f"{who}.{k}"] = v
    return out


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog: {"metrics": [{loss_d, loss_g, loss_r_sim}] a step, "moments"
    and "params": {"g", "d", "r"}}; ref: the same from
    `reference.riter.train_steps`, with "grads1" and "params0"."""
    loss = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
               for p, r in zip(prog["metrics"], ref["metrics"]) for k in LOSSES)
    if len(prog["metrics"]) != len(ref["metrics"]):
        loss = float("inf")
    gaps = train_gaps(prog, ref)
    diffs = gaps["moment_diff"]
    return {"loss_gap": loss,
            "moment_median_diff": float(torch.tensor(list(diffs.values())).median()),
            "moment_kernel_diff": max(v for k, v in diffs.items() if compare.kernel_leaf(k)),
            "change_gap": max(gaps["change"].values())}
