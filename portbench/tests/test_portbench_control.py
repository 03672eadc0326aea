"""The check's control and its planted faults.

On the CPU, at a size a test run holds (the tiny twins of the two cells,
held to the cells' own limits): a sound run comes out correct; each fault
the cell can have (`portbench.faults`), planted under the timed path of a
whole run that skips only the look for a card, makes it incorrect; the
control (the reference in fp8 in the program's place) fails at least one
limit.

On the card, at each cell's own size: the program on three seeds within
every limit, and the control beyond one on three seeds."""

import json
import os
import subprocess
import sys

import pytest
import torch

import benchcopy
from portbench import faults, harness


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return benchcopy.make_copy(str(tmp_path_factory.mktemp("bench")))


CASES = [("tiny-train", None), ("tinysn-train", None), ("tiny-filter", None)] \
    + [("tiny-train", f) for f in faults.FAULTS["train"]] \
    + [("tiny-filter", f) for f in faults.FAULTS["filter"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_makes_run_incorrect(copy, workload, fault):
    done = benchcopy.dry_run(copy, workload, fault=fault)
    assert done.returncode == 0, done.stderr[-3000:]
    line = benchcopy.last_json(done.stdout)
    assert all(n["limit"] is not None for n in line["check"].values())
    assert line["correct"] is (fault is None), line["check"]


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-filter"])
def test_control_fails_a_limit(copy, workload):
    code = f"""
import json, sys
sys.path[:0] = [{copy!r}, {benchcopy.ROOT!r}]
import torch
from portbench import faults, harness
cell = harness.find_cell({workload!r})
run = harness.Run(cell=cell, seed=77, seconds=0.0, trace=False, device=torch.device("cpu"))
run.loop_name = cell.mix["loop"]
got = faults.reading(run, control=True)
print(json.dumps({{"numbers": got, "limits": cell.limits["numbers"]}}))
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    got = benchcopy.last_json(done.stdout)
    assert any(got["numbers"][k] > v for k, v in got["limits"].items()), got


@pytest.mark.card
@pytest.mark.parametrize("workload", ["glis80-train", "glis160-filter"])
def test_cells_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tool = os.path.join(benchcopy.ROOT, "portbench", "tools", "readings.py")
    done = subprocess.run([sys.executable, tool, "--workload", workload, "--seeds", "101,102,103",
                           "--control-seeds", "201,202,203"],
                          capture_output=True, text=True, timeout=1500)
    assert done.returncode == 0, done.stderr[-3000:]
    limits = harness.find_cell(workload).limits["numbers"]
    rows = [json.loads(x) for x in done.stdout.splitlines() if x.startswith("{")]
    assert len(rows) == 6
    for r in rows:
        within = all(r["numbers"][k] <= limits[k] for k in limits)
        assert within == (r["kind"] == "program"), r
