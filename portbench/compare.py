"""The numbers that decide `correct`: what the timed path produced against
what the plain reference works out from the same inputs.

Training (`train_numbers`), over the state's first chunk: the first
replay of the K-step graph that the window then replays, from the seed's
weights, against K reference steps on the same batches and draws:

* `loss_gap`: the largest |program - reference| / |reference| of each
  step's D and G loss;
* `moment_median_diff`: the median leaf's ||program - reference|| of
  Adam's first moment after the chunk (the gradients as the optimizer
  holds them), over the larger of the reference's norm of that leaf and
  of the median leaf;
* `moment_kernel_diff`: the same, by the worst of the leaves that the
  three hand-written ops take (the LIS links, the seed's projection, its
  activation and first transposed conv, every TPReLU), so that a fault in
  one op's gradient cannot hide behind the median;
* `change_gap`: the worst leaf's |program norm - reference norm| of its
  change over the chunk, over the larger of the reference's norm of that
  change and of the median leaf's.

The state after one step exists only inside the graph, so the gradient is
compared as the moment the chunk leaves. Leaves whose reference gradient
at step one is under a thousandth of the median leaf's are left out of
the leaf numbers (Adam moves them by round-off alone).

Filtered sampling (`filter_numbers`), of one request's answer: each
returned image is matched to the reference's candidate nearest to it, and

* `image_mae`: the worst returned image's mean |difference| in uint8
  levels from its match;
* `score_gap`: the largest |returned score - the match's reference score|;
* `regret`: by how much the best reference score left out exceeds the
  worst one returned (0 when the returned set is the reference's top-k);
* `structure`: count of broken facts (a count other than asked, an
  image matched twice, scores not in descending order, a score not
  finite), limit 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set

import torch

LEAF_FLOOR = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in d.items()}


def kept_leaves(ref_grads: Dict[str, torch.Tensor]) -> Set[str]:
    n = _norms(ref_grads)
    med = float(torch.tensor(list(n.values())).median())
    return {k for k, v in n.items() if v >= LEAF_FLOOR * med}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's |program norm - reference norm| over the larger of
    the reference's norm of the leaf and of the median leaf."""
    keep = list(keep)
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    med = float(torch.tensor([rn[k] for k in keep]).median())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's ||program - reference|| over the larger of the
    reference's norm of the leaf and of the median leaf."""
    keep = list(keep)
    rn = _norms({k: ref[k] for k in keep})
    med = float(torch.tensor(list(rn.values())).median())
    return {k: float((prog[k].float() - ref[k].float()).norm()) / max(rn[k], med, 1e-30)
            for k in keep}


KERNEL_PARTS = ("lis", "project", "project_act")


def kernel_leaf(name: str) -> bool:
    """Whether the hand-written ops take the leaf ("g.<name>", "d.<name>"):
    G's LIS links, the seed's projection, activation and first transposed
    conv, and every TPReLU's slope and translation."""
    who, leaf = name.split(".", 1)
    parts = leaf.split(".")
    return (parts[-1] in ("a", "b") and parts[-2].endswith("act")) or (
        who == "g" and (parts[0] in KERNEL_PARTS or leaf.startswith("ups.0.conv.")))


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """{"moment_diff": {leaf: difference}, "moment_gap": {leaf: gap},
    "change": {leaf: gap}}, leaves named "g.<name>" and "d.<name>"."""
    out: Dict[str, Dict[str, float]] = {"moment_diff": {}, "moment_gap": {}, "change": {}}
    for who in ("g", "d"):
        keep = kept_leaves(ref["grads1"][who])
        pm, rm = prog["moments"][who], ref["moments"][who]
        for k, v in leaf_diffs(pm, rm, keep).items():
            out["moment_diff"][f"{who}.{k}"] = v
        for k, v in leaf_gaps(pm, rm, keep).items():
            out["moment_gap"][f"{who}.{k}"] = v
        p0 = ref["params0"][who]
        dp = {k: prog["params"][who][k].float() - p0[k].float() for k in keep}
        dr = {k: ref["params"][who][k].float() - p0[k].float() for k in keep}
        for k, v in leaf_gaps(dp, dr, keep).items():
            out["change"][f"{who}.{k}"] = v
    return out


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog: {"metrics": [{loss_d, loss_g}] a step, "moments": {"g", "d"},
    "params": {"g", "d"}}; ref: the same from `reference.train_steps`, with
    "grads1" and "params0", the start both took."""
    loss = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
               for p, r in zip(prog["metrics"], ref["metrics"]) for k in ("loss_d", "loss_g"))
    if len(prog["metrics"]) != len(ref["metrics"]):
        loss = float("inf")
    gaps = train_gaps(prog, ref)
    diffs = gaps["moment_diff"]
    return {"loss_gap": loss,
            "moment_median_diff": float(torch.tensor(list(diffs.values())).median()),
            "moment_kernel_diff": max(v for k, v in diffs.items() if kernel_leaf(k)),
            "change_gap": max(gaps["change"].values())}


def nearest(images: torch.Tensor, candidates: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Index of the candidate nearest (L2) to each image; uint8 (N, ...)."""
    a = images.reshape(images.shape[0], -1).float()
    best = torch.full((a.shape[0],), float("inf"), device=a.device)
    idx = torch.zeros(a.shape[0], dtype=torch.long, device=a.device)
    a2 = a.square().sum(1)
    for s in range(0, candidates.shape[0], block):
        b = candidates[s:s + block].reshape(min(block, candidates.shape[0] - s), -1).float()
        d = a2[:, None] + b.square().sum(1)[None, :] - 2 * a @ b.t()
        v, i = d.min(1)
        better = v < best
        best = torch.where(better, v, best)
        idx = torch.where(better, i + s, idx)
    return idx


def filter_numbers(images: torch.Tensor, scores: torch.Tensor, ref_images: torch.Tensor,
                   ref_scores: torch.Tensor, count: int) -> Dict[str, float]:
    """images (n, H, W, 3) uint8 and scores (n,) as returned; ref_images
    (N, H, W, 3) uint8 and ref_scores (N,) of every candidate."""
    broken = int(images.shape[0] != count) + int(scores.shape[0] != count)
    scores = scores.float()
    broken += int(not bool(torch.isfinite(scores).all()))
    broken += int(bool((scores[1:] > scores[:-1]).any())) if scores.numel() > 1 else 0
    match = nearest(images, ref_images)
    broken += int(match.unique().numel() != match.numel())
    mae = (images.float() - ref_images[match].float()).abs().flatten(1).mean(1)
    gap = (scores - ref_scores[match].float()).abs()
    chosen = torch.zeros(ref_scores.shape[0], dtype=torch.bool, device=ref_scores.device)
    chosen[match] = True
    left = ref_scores[~chosen]
    regret = max(0.0, float(left.max() - ref_scores[chosen].min())) if left.numel() else 0.0
    return {"image_mae": float(mae.max()), "score_gap": float(gap.max()), "regret": regret,
            "structure": float(broken)}
