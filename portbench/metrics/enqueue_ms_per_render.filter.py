"""Host ms of each `ServingModel.dispatch` (check, pinned copies in, the
render's enqueue, copies out), over the window."""

from portbench.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "filter", "enqueue", "renders")
