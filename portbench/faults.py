"""Faults planted under the timed path, and one reading of a cell's check
numbers on one seed, for setting and testing the limits.

Training (`train` loop):

* `unchanged`: every update leaves the state as it was (the step's
  optimizer update is a no-op);
* `half`: the step sees half of its batch, and its means are taken over
  that half;
* `altered`: the D loss the step reports is 5 % off where it is made;
* `lis_dw`: the LIS chain's backward hands back each link's first weight
  gradient 20 % short (a wrong kernel gradient in a few leaves).

Filtered sampling (`filter` loop):

* `half`: half of a request's candidates are left out, and the top is
  taken over the rest;
* `altered`: each render hands its images back one candidate out of
  step with their scores.

The exchange between chips does not exist on one card, so no cell here
can leave it out.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Optional

import torch

from portbench import compare, reference

FAULTS = {"train": ("unchanged", "half", "altered", "lis_dw"), "filter": ("half", "altered")}


def _halve(t):
    return None if t is None else t[: t.shape[0] // 2]


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    kept = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, kept)


@contextlib.contextmanager
def planted(name: Optional[str], loop: str):
    """The fault `name` planted in the program for the block (None: none)."""
    if name is None:
        yield
        return
    if name not in FAULTS[loop]:
        raise ValueError(f"fault {name!r} does not apply to the {loop} loop")
    if loop == "train":
        steps = importlib.import_module("gea_torch.train.steps")
        if name == "unchanged":
            with _patched(steps, "_update", lambda *a, **k: None):
                yield
            return
        if name == "lis_dw":
            lis = importlib.import_module("gea_torch.ops.lis")
            chain = lis._chain_backward

            def short(*args):
                out = chain(*args)
                return [[g * 0.8 if i == 1 and g is not None else g for i, g in enumerate(link)]
                        for link in out]

            with _patched(lis, "_chain_backward", short):
                yield
            return
        build = steps.build_glis_train_step

        def faulty(cfg, *a, **k):
            step = build(cfg, *a, **k)

            def run(state, real, z=None, spatial_noise=None, gp_eps=None):
                if name == "half":
                    return step(state, _halve(real), _halve(z), _halve(spatial_noise),
                                _halve(gp_eps))
                m = step(state, real, z, spatial_noise, gp_eps)
                return {**m, "loss_d": m["loss_d"] * 1.05}

            run.noise = step.noise
            return run

        with _patched(steps, "build_glis_train_step", faulty):
            yield
        return
    serve = importlib.import_module("gea_torch.serve")
    if name == "half":
        sample = serve.ServingModel.sample

        def half(self, count, seed=0, batch_size=64):
            return sample(self, count // 2, seed=seed, batch_size=batch_size)

        with _patched(serve.ServingModel, "sample", half):
            yield
        return
    forward = serve.ServeFunction.forward

    def shifted(self, *args):
        out = forward(self, *args)
        return {**out, "images": out["images"].roll(1, 0)}

    with _patched(serve.ServeFunction, "forward", shifted):
        yield


def reading(run, control: bool = False, detail: Optional[Dict] = None) -> Dict[str, float]:
    """The check's numbers of one seed: the program's (with whatever fault
    is planted), or with `control` the reference in fp8 in its place. A
    `detail` dict receives, for training, the worst leaf of each leaf
    number, of G's and of D's, its 90th percentile and median, and the
    leaves that the floor leaves out (PERF.md section 6 gives them)."""
    loop = importlib.import_module(f"portbench.loops.{run.loop_name}").Loop(run)
    loop.setup(warm=False)
    try:
        if run.loop_name == "train":
            prog = loop.reference_run(reference.Numerics(fp8=True)) if control else loop.prog
            ref = loop.reference_run()
            if detail is not None:
                for k, gaps in compare.train_gaps(prog, ref).items():
                    for part, pick in (("", gaps), ("_g", {n: v for n, v in gaps.items()
                                                          if n.startswith("g.")}),
                                       ("_d", {n: v for n, v in gaps.items()
                                               if n.startswith("d.")})):
                        worst = max(pick, key=pick.get)
                        detail[f"{k}{part}_worst"] = [worst, pick[worst]]
                    vals = torch.tensor(list(gaps.values()))
                    detail[f"{k}_p90"] = float(vals.quantile(0.9))
                    detail[f"{k}_median"] = float(vals.median())
                detail["left_out"] = sorted(
                    f"{who}.{n}" for who in ("g", "d") for n in ref["grads1"][who]
                    if n not in compare.kept_leaves(ref["grads1"][who]))
            return compare.train_numbers(prog, ref)
        if control:
            return loop.control(run.seed)
        out = loop.request(run.seed)
        return loop.numbers_of(out["images"], out["scores"], run.seed)
    finally:
        loop.release()
