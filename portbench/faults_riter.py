"""Faults planted under the R-iterative loop's timed path, and one reading of
its check numbers on one seed, for setting and testing the limits of a
`riter` cell (`tools/readings_riter.py`). The same contract as `faults`,
whose table knows the `train` and `filter` loops only:

* `unchanged`: every update leaves the state as it was (the step's
  optimizer updates are no-ops);
* `half`: the step sees half of its batch (reals, z_0 and spatial noise),
  and its means are taken over that half;
* `altered`: the D loss the step reports is 5 % off where it is made;
* `chain_cut`: R's output is detached wherever it is differentiated, so
  that the G/R loss's gradient stops at each link's residual: R learns
  nothing and G nothing through the chain.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, Optional

from portbench import compare, compare_riter, reference
from portbench.faults import _halve, _patched

FAULTS = {"riter": ("unchanged", "half", "altered", "chain_cut")}


@contextlib.contextmanager
def planted(name: Optional[str], loop: str = "riter"):
    """The fault `name` planted in the program for the block (None: none)."""
    if name is None:
        yield
        return
    if name not in FAULTS.get(loop, ()):
        raise ValueError(f"fault {name!r} does not apply to the {loop} loop")
    steps_r = importlib.import_module("gea_torch.train.steps_r")
    if name == "unchanged":
        with _patched(steps_r, "_update", lambda *a, **k: None):
            yield
        return
    if name == "chain_cut":
        reverter = importlib.import_module("gea_torch.models.reverter")
        forward = reverter.Reverter.forward

        def cut(self, x):
            return forward(self, x).detach()

        with _patched(reverter.Reverter, "forward", cut):
            yield
        return
    build = steps_r.build_r_iterative_step

    def faulty(cfg, *a, **k):
        step = build(cfg, *a, **k)

        def run(state, real, z=None, spatial_noise=None):
            if name == "half":
                return step(state, _halve(real), _halve(z), _halve(spatial_noise))
            m = step(state, real, z, spatial_noise)
            return {**m, "loss_d": m["loss_d"] * 1.05}

        run.noise = step.noise
        return run

    with _patched(steps_r, "build_r_iterative_step", faulty):
        yield


def reading(run, control: bool = False, detail: Optional[Dict] = None) -> Dict[str, float]:
    """The check's numbers of one seed: the program's (with whatever fault
    is planted), or with `control` the reference in fp8 in its place. A
    `detail` dict receives the worst leaf of each leaf number, of each
    player, and the median leaf's; the worst loss (its name, step, gap and
    reference value); and the leaves that the floor leaves out."""
    loop = importlib.import_module(f"portbench.loops.{run.loop_name}").Loop(run)
    loop.setup(warm=False)
    try:
        prog = loop.reference_run(reference.Numerics(fp8=True)) if control else loop.prog
        ref = loop.reference_run()
        if detail is not None:
            for k, gaps in compare_riter.train_gaps(prog, ref).items():
                worst = max(gaps, key=gaps.get)
                detail[f"{k}_worst"] = [worst, gaps[worst]]
                for who in compare_riter.PLAYERS:
                    pick = {n: v for n, v in gaps.items() if n.startswith(who + ".")}
                    worst = max(pick, key=pick.get)
                    detail[f"{k}_{who}_worst"] = [worst, pick[worst]]
                vals = sorted(gaps.values())
                detail[f"{k}_median"] = vals[len(vals) // 2]
            gap, i, key = max((abs(p[k] - r[k]) / max(abs(r[k]), 1e-12), i, k)
                              for i, (p, r) in enumerate(zip(prog["metrics"], ref["metrics"]))
                              for k in compare_riter.LOSSES)
            detail["loss_worst"] = [key, i + 1, gap, ref["metrics"][i][key]]
            detail["left_out"] = sorted(
                f"{who}.{n}" for who in compare_riter.PLAYERS for n in ref["grads1"][who]
                if n not in compare.kept_leaves(ref["grads1"][who]))
        return compare_riter.train_numbers(prog, ref)
    finally:
        loop.release()
