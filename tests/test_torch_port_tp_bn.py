"""The port's tensor-parallel steps against `gea`'s single-device step and
its GSPMD step with G's seed projection replicated, for G-LIS and
R-iterative under `--norm batch` (`tests/test_torch_port_tp.py` says how
the runs are fed and compared, and why that leaf is replicated here)."""

import pytest
from test_torch_port_tp import (  # noqa: F401
    STEPS,
    WORLDS,
    assert_close,
    one_thread,
    port_world,
    references,
    refs,
)

HERE = ("glis_batch_norm", "r_iterative_batch_norm")


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case,ref", refs(HERE))
def test_tp_step_matches_geas(case, ref, world, after):
    got = port_world(HERE, world)[case]["steps"][after - 1]
    assert_close(got, references(HERE)[case][ref]["steps"][after - 1])


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("case", HERE)
def test_ranks_hold_the_same_state(case, world):
    """Every rank's full parameters and statistics, bit for bit."""
    assert port_world(HERE, world)[case]["spread"] == 0.0
