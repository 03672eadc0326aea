"""Share of the card's peak in the window: the R-iterative step's model
FLOPs (`portbench.cost.riter`) times the steps completed, over the
window's seconds times the peak of the compute dtype."""

from portbench.cost.riter import r_iterative_step_flops
from portbench.readers import peak_flops


def read(run):
    steps = run.counts.get("steps")
    if run.loop_name != "riter" or not steps or run.window_s <= 0:
        return None
    flops = r_iterative_step_flops(run.cell.model, int(run.counts["batch"])) * steps
    return 100.0 * flops / (run.window_s * peak_flops(run))
