"""The frozen yardstick: the card's peaks, the model FLOPs of a G-LIS train
step and of a scored render, and the bytes and operations of each call
into the port's three kernels. Copied from `chip_smoke.py` (`bound`,
`conv_pairs`, the forward cases, `function_backward_cost`,
`seed_backward_cost`, `lis_chain_cost`), not imported, so that a change to
the program cannot move it. Imports neither `gea` nor `gea_torch`."""

from portbench.cost.kernels import bound, call_cost  # noqa: F401
from portbench.cost.model import render_flops, train_step_flops  # noqa: F401
from portbench.cost.peaks import HBM_BYTES_PER_S, PEAK_FLOPS  # noqa: F401
