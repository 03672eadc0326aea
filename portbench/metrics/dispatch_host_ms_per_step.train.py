"""Host ms a step inside the dispatcher's call (noise draws, lr fill, the
buffers' copies and the graph's replay enqueue), over the window."""

from portbench.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "train", "dispatch", "steps")
