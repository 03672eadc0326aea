"""The port's three ops' share of their roofline in an R-iterative step:
the sum of the bounds (`portbench.cost`) over the sum of the times of one
eager step's calls, each timed at its entry with CUDA events."""

from portbench.readers import kernels_roofline_pct


def read(run):
    return kernels_roofline_pct(run, "riter")
