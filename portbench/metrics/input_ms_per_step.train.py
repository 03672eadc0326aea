"""Host ms a step spent in the input layer (`input_iterator`,
`make_input_fn`'s on-device synthetic draw), over the window."""

from portbench.readers import per_unit_ms


def read(run):
    return per_unit_ms(run, "train", "input", "steps")
