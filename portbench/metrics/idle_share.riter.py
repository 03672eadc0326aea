"""Share of the traced segment in which no kernel or copy ran on the
device (torch.profiler)."""

from portbench.readers import idle_pct


def read(run):
    return idle_pct(run, "riter")
