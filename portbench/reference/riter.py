"""R-iterative (arXiv:1707.00768, as `gea` builds it) in plain PyTorch, over
dicts of fp32 parameters named as the port's modules name them: G, D and
the reverser R trained jointly through the unrolled correction chain.

* G is G-LIS's core alone (r_iterations 0): one stage, `glis.core`.
* D is `glis.discriminator`.
* R is D's conv trunk (`trunk.downs.<i>`, its own weights), the features
  flattened in (h, w, c) order, then a dense head `fc1` -> TPReLU (`act`)
  -> `fc2` onto the code: a residual dz.
* The chain from z_0: z_{t+1} = z_t + R(G(z_t)), T = r_chain_length links,
  one render a code (T + 1).
* A step: D's BCE on the reals (target 1) and on every code's render,
  detached (target 0, link i weighted 0.5 + 0.5 i / T, normalised), and
  D's Adam update; then the chain unrolled again with gradients, G's and
  R's weighted BCE (target 1) against the updated D, plus lambda_r times
  the mean square of the T residuals, and G's and R's Adam updates.

Departures from the published description, which leaves the exact set of
D's inputs and the penalty's form open: D sees every link's render, not the
chain's end alone; the penalty is the mean of (z_{t+1} - z_t)^2 over links,
rows and code dimensions, not a sum; the layers are `gea`'s (weight norm on
every dense and conv weight, TPReLU activations, R's trunk shaped as D's).
Each of these is what `gea` and the port do.

Imports neither `gea` nor `gea_torch`; fp32 with TF32 off is the caller's
(`portbench.loops.exact_matmuls`), as for `glis.train_steps`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.glis import (
    Adam,
    Numerics,
    Params,
    _grads,
    _leaves,
    act,
    bce,
    conv,
    core,
    dense,
    discriminator,
    exact_fp32,
    plan,
)


def reverter(p: Params, x: torch.Tensor, m: Dict, nx: Numerics = exact_fp32) -> torch.Tensor:
    """images (N, H, W, 3) -> residuals (N, code)."""
    _, d = plan(m["image_size"])
    for i in range(d):
        x = conv(x, p, f"trunk.downs.{i}.conv", nx)
        x = F.leaky_relu(x, 0.2) if i == 0 else act(x, p, f"trunk.downs.{i}.act")
    h = act(dense(x.reshape(x.shape[0], -1), p, "fc1", nx), p, "act")
    return dense(h, p, "fc2", nx)


def link_weights(chain_length: int) -> List[float]:
    """The weight of each code's render, the chain's end highest, summing
    to 1."""
    n = chain_length + 1
    raw = [0.5 + 0.5 * i / max(1, n - 1) for i in range(n)]
    return [w / sum(raw) for w in raw]


def unroll(gp: Params, rp: Params, z0: torch.Tensor, sn: Optional[torch.Tensor], m: Dict,
           links: int, nx: Numerics = exact_fp32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (T+1, B, H, W, 3), codes (T+1, B, code)) of the chain."""
    zs, imgs = [z0], [core(gp, z0, sn, m, nx)]
    for _ in range(links):
        zs.append(zs[-1] + reverter(rp, imgs[-1], m, nx))
        imgs.append(core(gp, zs[-1], sn, m, nx))
    return torch.stack(imgs), torch.stack(zs)


def train_steps(g0: Params, d0: Params, r0: Params, reals: Sequence[torch.Tensor],
                zs: Sequence[torch.Tensor], sns: Sequence[Optional[torch.Tensor]], m: Dict,
                hp: Dict, nx: Numerics = exact_fp32) -> Dict:
    """len(reals) R-iterative steps from (g0, d0, r0); `m` and `hp` give
    the sizes and r_chain_length, lambda_r, lr, beta1 and beta2.

    Returns {"metrics": [{loss_d, loss_g, loss_r_sim, d_real}] a step,
    "grads1": the gradients each optimizer got at the first step,
    "params": each player's parameters after the last step, "moments":
    each Adam's first moment after the last step}, players "g", "d", "r"."""
    links = int(hp["r_chain_length"])
    w = link_weights(links)
    params = {"g": dict(g0), "d": dict(d0), "r": dict(r0)}
    opts = {k: Adam(v, hp["lr"], hp["beta1"], hp["beta2"]) for k, v in params.items()}
    metrics, grads1 = [], None
    for real, z, sn in zip(reals, zs, sns):
        with torch.no_grad():
            fakes, _ = unroll(params["g"], params["r"], z, sn, m, links, nx)
        dp = _leaves(params["d"])
        logits_real = discriminator(dp, real, m, nx)
        logits_fake = discriminator(dp, fakes.reshape(-1, *fakes.shape[2:]), m, nx)
        logits_fake = logits_fake.reshape(links + 1, -1)
        loss_d = bce(logits_real, 1.0) + sum(wi * bce(logits_fake[i], 0.0)
                                             for i, wi in enumerate(w))
        grad_d = _grads(loss_d, dp)
        params["d"] = opts["d"].step(params["d"], grad_d)

        gp, rp = _leaves(params["g"]), _leaves(params["r"])
        images, codes = unroll(gp, rp, z, sn, m, links, nx)
        dn = {k: v.detach() for k, v in params["d"].items()}
        logits = discriminator(dn, images.reshape(-1, *images.shape[2:]), m, nx)
        logits = logits.reshape(links + 1, -1)
        adv = sum(wi * bce(logits[i], 1.0) for i, wi in enumerate(w))
        sim = (codes[1:] - codes[:-1]).square().mean()
        loss = adv + hp["lambda_r"] * sim
        both = _grads(loss, {**{"g." + k: v for k, v in gp.items()},
                             **{"r." + k: v for k, v in rp.items()}})
        grad_g = {k[2:]: v for k, v in both.items() if k.startswith("g.")}
        grad_r = {k[2:]: v for k, v in both.items() if k.startswith("r.")}
        params["g"] = opts["g"].step(params["g"], grad_g)
        params["r"] = opts["r"].step(params["r"], grad_r)
        if grads1 is None:
            grads1 = {"g": grad_g, "d": grad_d, "r": grad_r}
        metrics.append({"loss_d": float(loss_d.detach()), "loss_g": float(adv.detach()),
                        "loss_r_sim": float(sim.detach()),
                        "d_real": float(torch.sigmoid(logits_real.detach()).mean())})
    return {"metrics": metrics, "grads1": grads1,
            "params": {k: {n: v.detach() for n, v in p.items()} for k, p in params.items()},
            "moments": {k: dict(o.m) for k, o in opts.items()}}
