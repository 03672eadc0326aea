"""Share of the card's peak in the window: the step's model FLOPs
(`portbench.cost.train_step_flops`) times the steps completed, over the
window's seconds times the peak of the compute dtype."""

from portbench import cost
from portbench.readers import peak_flops


def read(run):
    steps = run.counts.get("steps")
    if run.loop_name != "train" or not steps or run.window_s <= 0:
        return None
    flops = cost.train_step_flops(run.cell.model, int(run.counts["batch"])) * steps
    return 100.0 * flops / (run.window_s * peak_flops(run))
