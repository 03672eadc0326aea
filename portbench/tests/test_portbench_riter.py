"""The `riter` loop and its cell on the CPU, at a tiny size held to
`riter80-train`'s limits: a dry run's line at --trace 0 and 1 with every
new metric that a CPU run can read (the device's are read from a trace:
the attribution of kernels to the program's spans is tested on events made
here), the chain's spans and counters seen, each planted fault and the
control failing a limit, and the step's FLOP count. On the card, at the
cell's own size: the program within every limit on three seeds, the
control beyond one."""

import json
import os
import subprocess
import sys

import pytest
import torch

import benchcopy
import riter_copy
from portbench import faults_riter, harness
from portbench.cost.model import core_layers, disc_layers
from portbench.cost.riter import r_iterative_step_flops, reverter_layers
from portbench.loops.riter import RANGE_PREFIX, span_kernel_ms

HOST_METRICS = {"step_mfu.riter"}  # the rest are the device's, read from a trace


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return riter_copy.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run(copy, trace):
    done = riter_copy.dry_run(copy, trace=trace)
    assert done.returncode == 0, done.stderr[-3000:]
    line = benchcopy.last_json(done.stdout)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0 and line["failed"] == 0
    assert set(line["check"]) == {"loss_gap", "moment_median_diff", "moment_kernel_diff",
                                  "change_gap"}
    got = set(line["metrics"])
    if not trace:
        assert got == {"train_images_per_s", "setup_s"}
        return
    assert HOST_METRICS <= got <= set(riter_copy.RITER_METRICS)
    assert "idle_share.riter" in got  # the profiler's segment, device-idle on the CPU
    # The program's spans and counters of the eager step, 2T links and
    # 2(T + 1) renders at T = 2.
    assert ("chain step: spans {'riter.link': 4, 'riter.unroll': 2, 'riter.d': 1, "
            "'riter.gr_backward': 1}, counters {'riter.links': 4, 'riter.renders': 6}"
            ) in done.stderr


@pytest.mark.parametrize("fault", [None, *faults_riter.FAULTS["riter"]])
def test_fault_makes_run_incorrect(copy, fault):
    done = riter_copy.dry_run(copy, fault=fault)
    assert done.returncode == 0, done.stderr[-3000:]
    line = benchcopy.last_json(done.stdout)
    assert all(n["limit"] is not None for n in line["check"].values())
    assert line["correct"] is (fault is None), line["check"]


def test_control_fails_a_limit(copy):
    code = f"""
import json, sys
sys.path[:0] = [{copy!r}, {benchcopy.ROOT!r}]
import torch
from portbench import faults_riter, harness
cell = harness.find_cell("tiny-riter")
run = harness.Run(cell=cell, seed=77, seconds=0.0, trace=False, device=torch.device("cpu"))
run.loop_name = cell.mix["loop"]
got = faults_riter.reading(run, control=True)
print(json.dumps({{"numbers": got, "limits": cell.limits["numbers"]}}))
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    got = benchcopy.last_json(done.stdout)
    assert any(got["numbers"][k] > v for k, v in got["limits"].items()), got


def test_kernels_count_for_the_span_their_launch_lies_in():
    """A kernel counts where its launch (a host `cu*` call of the same
    correlation id) lies inside one of the span's ranges, whatever the
    thread; a kernel launched outside, or with no launch seen, does not."""
    link = RANGE_PREFIX + "riter.link"
    events = [
        (link, False, 100, 200, 1), (link, False, 300, 400, 2),
        ("cudaLaunchKernel", False, 150, 151, 10),  # inside the first range
        ("cuLaunchKernel", False, 350, 351, 11),  # inside the second, another thread
        ("cudaLaunchKernel", False, 250, 251, 12),  # between them
        ("aten::mm", False, 160, 170, 13),  # a CPU op sharing a kernel's id: not a launch
        ("k_a", True, 500, 2_500_500, 10), ("k_b", True, 600, 1_000_600, 11),
        ("k_c", True, 700, 5_000_700, 12), ("k_d", True, 800, 9_000_800, 13),
    ]
    assert span_kernel_ms(events, "riter.link") == pytest.approx((3.5, 2))
    assert span_kernel_ms(events, "riter.gr_backward") is None
    assert span_kernel_ms([e for e in events if not e[0].startswith("k_")],
                          "riter.link") is None


def test_step_flops_by_the_layer_formulas():
    m = json.load(open(os.path.join(benchcopy.ROOT, "portbench", "configs",
                                    "riter80.json")))["flags"]
    core, disc = sum(core_layers(m)), sum(disc_layers(m))
    assert reverter_layers(m) == sum(disc_layers(m)[:-1]) + 2 * 5 * 5 * 512 * 512 + 2 * 512 * 256
    # A chain of no link is one render: D's step over reals and fakes, and
    # G's backward through every layer of its one render.
    flat = dict(m, r_chain_length=0)
    d0 = disc_layers(m)
    assert r_iterative_step_flops(flat, 1) == (
        2 * core + 2 * (2 * disc + sum(d0[1:])) + 2 * disc + core + sum(core_layers(m)[1:]))
    assert r_iterative_step_flops(m, 64) == 711_481_163_776


@pytest.mark.card
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tool = os.path.join(benchcopy.ROOT, "portbench", "tools", "readings_riter.py")
    done = subprocess.run([sys.executable, tool, "--workload", "riter80-train",
                           "--seeds", "101,102,103", "--control-seeds", "201,202,203",
                           "--faults", "chain_cut", "--fault-seeds", "301"],
                          capture_output=True, text=True, timeout=1500)
    assert done.returncode == 0, done.stderr[-3000:]
    limits = harness.find_cell("riter80-train").limits["numbers"]
    rows = [json.loads(x) for x in done.stdout.splitlines() if x.startswith("{")]
    assert len(rows) == 7
    for r in rows:
        within = all(r["numbers"][k] <= limits[k] for k in limits)
        assert within == (r["kind"] == "program"), r
