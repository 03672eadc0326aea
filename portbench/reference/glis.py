"""G-LIS (arXiv:1707.00768, as `gea` builds it) in plain PyTorch, over a
dict of fp32 parameters named as the port's modules name them.

Layers, all NHWC:

* weight norm on every dense and conv weight: w = g v / sqrt(sum v^2 +
  1e-12), the sum over every axis but the output one;
* TPReLU(x; a, b) = where(x - b < 0, a (x - b), x - b) + b, per channel;
* a LIS link: z + W2 TPReLU(W1 z + b1) + b2;
* G: the chain of links from z, every stage's code (z0 too) rendered by
  one core: dense projection to s0 x s0 x c0, TPReLU, then 4x4 stride-2
  transposed convs each with a TPReLU, the spatial noise joined on the
  channels before the second, a last transposed conv to RGB and tanh;
* D: 4x4 stride-2 convs, LeakyReLU(0.2) after the first and a TPReLU
  after every later one, then a dense head over the (h, w, c) flattened
  features: one logit an image.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale that maps its largest
    magnitude to e4m3's largest, and back to fp32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = amax / FP8_MAX
    return ((x.float() / s).to(FP8).float() * s).to(x.dtype)


class _FP8Operand(torch.autograd.Function):
    """An operand of a product in fp8: rounded on the way in, and its
    gradient rounded on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _fake_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g)


@dataclass(frozen=True)
class Numerics:
    """The arithmetic of the products: `fp8` rounds every operand of every
    dense and conv product, forward and backward, to e4m3 with a per-tensor
    scale; the rest stays fp32."""

    fp8: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _FP8Operand.apply(x) if self.fp8 else x


exact_fp32 = Numerics()


def wn(p: Params, name: str, out_dim: int) -> torch.Tensor:
    v, g = p[name + ".weight_v"].float(), p[name + ".weight_g"].float()
    axes = [i for i in range(v.dim()) if i != out_dim]
    return v / torch.sqrt(v.square().sum(dim=axes, keepdim=True) + 1e-12) * g


def dense(x: torch.Tensor, p: Params, name: str, nx: Numerics) -> torch.Tensor:
    w = wn(p, name, 0)  # (out, in)
    return nx.q(x) @ nx.q(w).t() + p[name + ".bias"]


def conv(x: torch.Tensor, p: Params, name: str, nx: Numerics) -> torch.Tensor:
    y = F.conv2d(nx.q(x).permute(0, 3, 1, 2), nx.q(wn(p, name, 0)), p[name + ".bias"],
                 stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def conv_t(x: torch.Tensor, p: Params, name: str, nx: Numerics) -> torch.Tensor:
    y = F.conv_transpose2d(nx.q(x).permute(0, 3, 1, 2), nx.q(wn(p, name, 1)),
                           p[name + ".bias"], stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def tprelu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = x - b
    return torch.where(s < 0, a * s, s) + b


def act(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return tprelu(x, p[name + ".a"], p[name + ".b"])


def plan(image_size: int) -> Tuple[int, int]:
    s, d = image_size, 0
    while s % 2 == 0 and s // 2 >= 4:
        s //= 2
        d += 1
    return s, d


def lis_chain(p: Params, z: torch.Tensor, links: int, nx: Numerics) -> List[torch.Tensor]:
    zs = [z]
    for j in range(links):
        h = act(dense(zs[-1], p, f"lis.{j}.fc1", nx), p, f"lis.{j}.act")
        zs.append(zs[-1] + dense(h, p, f"lis.{j}.fc2", nx))
    return zs


def core(p: Params, codes: torch.Tensor, sn: Optional[torch.Tensor], m: Dict,
         nx: Numerics) -> torch.Tensor:
    """codes (N, code) -> images (N, H, W, 3) in [-1, 1]."""
    s0, d = plan(m["image_size"])
    x = dense(codes, p, "project", nx)
    x = act(x.view(codes.shape[0], s0, s0, -1), p, "project_act")
    for i in range(d - 1):
        if i == 1 and m.get("spatial_code", 0) > 0:
            x = torch.cat([x, sn], dim=-1)
        x = act(conv_t(x, p, f"ups.{i}.conv", nx), p, f"ups.{i}.act")
    if d == 2 and m.get("spatial_code", 0) > 0:
        x = torch.cat([x, sn], dim=-1)
    return torch.tanh(conv_t(x, p, "to_rgb", nx))


def n_stages(m: Dict) -> int:
    r = m["r_iterations"]
    return 1 if r == 0 else r + (1 if m.get("include_initial_image", True) else 0)


def generator(p: Params, z: torch.Tensor, sn: Optional[torch.Tensor], m: Dict,
              nx: Numerics = exact_fp32) -> torch.Tensor:
    """Every stage the loss weighs: (S, B, H, W, 3)."""
    zs = lis_chain(p, z, m["r_iterations"], nx)
    if m["r_iterations"] and not m.get("include_initial_image", True):
        zs = zs[1:]
    elif not m["r_iterations"]:
        zs = zs[:1]
    codes = torch.cat(zs, dim=0)
    sns = None if sn is None else sn.repeat(len(zs), 1, 1, 1)
    images = core(p, codes, sns, m, nx)
    return images.reshape(len(zs), z.shape[0], *images.shape[1:])


def render_final(p: Params, z: torch.Tensor, sn: Optional[torch.Tensor], m: Dict,
                 nx: Numerics = exact_fp32) -> torch.Tensor:
    """The final stage alone: (B, H, W, 3) in [-1, 1]."""
    zs = lis_chain(p, z, m["r_iterations"], nx)
    return core(p, zs[-1], sn, m, nx)


def discriminator(p: Params, x: torch.Tensor, m: Dict, nx: Numerics = exact_fp32) -> torch.Tensor:
    _, d = plan(m["image_size"])
    for i in range(d):
        x = conv(x, p, f"trunk.downs.{i}.conv", nx)
        x = F.leaky_relu(x, 0.2) if i == 0 else act(x, p, f"trunk.downs.{i}.act")
    return dense(x.reshape(x.shape[0], -1), p, "head", nx).squeeze(-1)


def score(p: Params, images: torch.Tensor, m: Dict, nx: Numerics = exact_fp32) -> torch.Tensor:
    """sigmoid of D's logit, an image."""
    return torch.sigmoid(discriminator(p, images, m, nx))


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255], clipped, truncated."""
    return ((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k highest scores, highest first."""
    return torch.argsort(scores, descending=True)[:k]


def stage_weights(n: int, initial: float = 0.2) -> List[float]:
    """Per-stage adversarial weights, the final stage highest, summing to 1."""
    if n == 1:
        return [1.0]
    raw = [initial + (1.0 - initial) * i / (n - 1) for i in range(n)]
    return [w / sum(raw) for w in raw]


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


class Adam:
    """Adam with bias correction (lr, beta1, beta2, eps) over a dict of
    parameters, updated out of place."""

    def __init__(self, params: Params, lr: float, beta1: float, beta2: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Params, grads: Params) -> Params:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = (self.v[k].sqrt() / math.sqrt(bc2)) + self.eps
            out[k] = p - (self.lr / bc1) * self.m[k] / denom
        return out


def _grads(loss: torch.Tensor, params: Params) -> Params:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys])
    return {k: g.detach() for k, g in zip(keys, gs)}


def _leaves(p: Params) -> Params:
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


def train_steps(g0: Params, d0: Params, reals: Sequence[torch.Tensor], zs: Sequence[torch.Tensor],
                sns: Sequence[Optional[torch.Tensor]], m: Dict, hp: Dict,
                nx: Numerics = exact_fp32) -> Dict:
    """len(reals) alternating steps from (g0, d0), each: G renders every
    stage; D's BCE on the reals (target 1) and on each stage's fakes
    (target 0, weighted by stage) and D's Adam update; then G's weighted
    BCE (target 1) against the updated D and G's Adam update.

    Returns {"metrics": [{loss_d, loss_g, d_real, d_fake_final}] a step,
    "grads1": the gradients each optimizer got at the first step,
    "params": G's and D's parameters after the last step, "moments": each
    Adam's first moment after the last step}."""
    w = stage_weights(n_stages(m), hp.get("stage_weight_initial", 0.2))
    opt_g = Adam(g0, hp["lr"], hp["beta1"], hp["beta2"])
    opt_d = Adam(d0, hp["lr"], hp["beta1"], hp["beta2"])
    g, d = dict(g0), dict(d0)
    metrics, grads1 = [], None
    for real, z, sn in zip(reals, zs, sns):
        gp, dp = _leaves(g), _leaves(d)
        fakes = generator(gp, z, sn, m, nx)  # (S, B, H, W, 3)
        s, b = fakes.shape[:2]
        flat = fakes.reshape(s * b, *fakes.shape[2:])
        logits = discriminator(dp, torch.cat([real, flat.detach()]), m, nx)
        lr_, lf = logits[:b], logits[b:].reshape(s, b)
        loss_d = bce(lr_, 1.0) + sum(wi * bce(lf[i], 0.0) for i, wi in enumerate(w))
        grad_d = _grads(loss_d, dp)
        d = opt_d.step(d, grad_d)
        dn = {k: v.detach() for k, v in d.items()}
        lg = discriminator(dn, flat, m, nx).reshape(s, b)
        loss_g = sum(wi * bce(lg[i], 1.0) for i, wi in enumerate(w))
        grad_g = _grads(loss_g, gp)
        g = opt_g.step(g, grad_g)
        if grads1 is None:
            grads1 = {"g": grad_g, "d": grad_d}
        metrics.append({"loss_d": float(loss_d.detach()), "loss_g": float(loss_g.detach()),
                        "d_real": float(torch.sigmoid(lr_.detach()).mean()),
                        "d_fake_final": float(torch.sigmoid(lf[-1].detach()).mean())})
    return {"metrics": metrics, "grads1": grads1,
            "params": {"g": {k: v.detach() for k, v in g.items()},
                       "d": {k: v.detach() for k, v in d.items()}},
            "moments": {"g": dict(opt_g.m), "d": dict(opt_d.m)}}
