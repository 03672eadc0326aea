"""Share of the card's peak in the window counting useful work only: a
candidate's LIS chain, its final stage's render and D's score
(`portbench.cost.render_flops`), times the candidates rendered, over the
window's seconds times the peak. The stages rendered and thrown away do
not count."""

from portbench import cost
from portbench.readers import peak_flops


def read(run):
    n = run.counts.get("candidates")
    if run.loop_name != "filter" or not n or run.window_s <= 0:
        return None
    return 100.0 * cost.render_flops(run.cell.model, int(n)) / (run.window_s * peak_flops(run))
