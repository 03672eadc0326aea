"""One general loop per kind of work a mix can ask for. A mix file names
its loop (`"loop": "train"`) and gives the loop's parameters; the loop's
module holds a class `Loop(run)` with:

* `setup()`: build the program from the cell's configuration and the
  seed's weights, drive it through what the check compares, and warm every
  shape the window uses;
* `window()`: the measured window, `run.seconds` long, ending with a
  device synchronise; fills `run.end_to_end`, `run.counts`, `run.spans`,
  `run.attempted` and `run.failed`;
* `traced_segment()`: the same work for `mix["trace_seconds"]` under
  torch.profiler (traced runs only), into `run.trace_summary`;
* `time_kernel_calls()`: one unit of the work under the op spy, each call
  timed at its entry, into `run.kernel_calls` (traced runs only);
* `release()`: free the program's state;
* `check()`: {number: {"value", "limit"}} from the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.weights import load_into, make_weights


def build_models(model_cfg, seed: int, device: torch.device) -> Tuple:
    """(G, D, {"g": weights, "d": weights}): the port's generator and
    discriminator, built on the device, holding the seed's weights; the
    weights dicts are copies for the reference."""
    from gea_torch.models import Discriminator, GeneratorLIS

    with torch.device(device):
        g = GeneratorLIS(model_cfg, device=device)
        d = Discriminator(model_cfg, device=device)
    shapes = ([("g." + n, tuple(p.shape)) for n, p in g.named_parameters()]
              + [("d." + n, tuple(p.shape)) for n, p in d.named_parameters()])
    flat = make_weights(shapes, seed, device)
    weights: Dict[str, Dict[str, torch.Tensor]] = {"g": {}, "d": {}}
    for name, t in flat.items():
        who, leaf = name.split(".", 1)
        weights[who][leaf] = t
    load_into(g, weights["g"])
    load_into(d, weights["d"])
    return g, d, weights


def phase(run, name: str) -> None:
    """Mark the end of a set-up phase (printed on stderr by the harness)."""
    from portbench.harness import process_age_s

    sync(run.device)
    run.phases.append((name, process_age_s()))


def with_limits(run, numbers: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit (None where the cell has none)."""
    lim = run.cell.limits.get("numbers", {})
    return {k: {"value": v, "limit": lim.get(k)} for k, v in numbers.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class exact_matmuls:
    """TF32 off for the block (the reference's fp32 is fp32), then put back."""

    def __enter__(self):
        self.kept = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.kept
