"""The weights of a run, made on the device from the seed in one draw, in
fp32 (the configurations keep fp32 parameters), and handed to the program
and to the reference alike.

Each parameter is named and shaped as the port's modules name and shape
it; its values come from one standard-normal draw over every parameter at
once (a `torch.Generator` on the device seeded with the run's seed), in
the order of the names, mapped by the name's last part: a weight-norm
direction `weight_v` as drawn, its scale `weight_g` 1 + 0.1 n, a bias 0.05
n, a TPReLU slope `a` 0.25 + 0.05 n and translation `b` 0.05 n.

The scale of each of G's 4x4 stride-2 transposed convs (a `weight_g` of
`g.` whose `weight_v` is 4-D) is `CONV_T_GAIN` times that. Only 2x2 of a
transposed conv's 4x4 taps reach each output, and the TPReLU after it
keeps about 0.73 of the scale, so at gain 1 each of them shrinks its input
about 2.7-fold: at 160x160 the candidates' images then differ by under
one uint8 level, D scores every candidate alike to within its bf16
rounding, and the top-k choice is not tested. At 2.5 the images spread
over most of [-1, 1] (a trained G's do), and so do D's scores.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

AFFINE = {"weight_v": (1.0, 0.0), "weight_g": (0.1, 1.0), "bias": (0.05, 0.0),
          "a": (0.05, 0.25), "b": (0.05, 0.0)}
CONV_T_GAIN = 2.5


def gain(name: str, shapes: Dict[str, Tuple[int, ...]]) -> float:
    """CONV_T_GAIN for the scale of a transposed conv of G, else 1."""
    if not (name.startswith("g.") and name.endswith(".weight_g")):
        return 1.0
    return CONV_T_GAIN if len(shapes.get(name[:-1] + "v", ())) == 4 else 1.0


def make_weights(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on device} for (name, shape) pairs."""
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    by_name = dict(shapes)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        scale, shift = AFFINE[name.rsplit(".", 1)[-1]]
        out[name] = ((flat[at:at + n] * scale + shift) * gain(name, by_name)).view(shape)
        at += n
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str = "") -> None:
    """Copy each of the module's parameters from `weights[prefix + name]`."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(weights[prefix + name])
