"""`tools/program_spans.py`, which reads the program's own spans in a cell:
its second pass over the traced segment's idle gaps on a synthetic event
list, its readings where there is nothing to read, and a dry run of each
tiny cell on the CPU."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import benchcopy
from portbench import harness, tracing

TOOL = os.path.join(benchcopy.ROOT, "portbench", "tools", "program_spans.py")
ps = harness.load_file_module(TOOL, "portbench_tool_program_spans")

# (name, on the device, a user range, start s, end s), as `tracing._events` yields them.
EVENTS = [
    ("portbench::segment", False, True, 0.0, 10.0),
    ("portbench::request", False, True, 0.4, 9.9),
    ("gea_torch.span::outer", False, True, 0.55, 9.8),
    ("gea_torch.span::serve.draw", False, True, 0.6, 0.9),
    ("gea_torch.span::serve.join", False, True, 6.2, 7.9),
    ("aten::copy_", False, False, 6.3, 6.4),
    ("gea_torch.span::serve.render", True, True, 1.0, 1.1),  # a range's device echo
    ("kernel_a", True, False, 1.0, 2.0),
    ("kernel_b", True, False, 2.0, 3.0),
    ("kernel_c", True, False, 5.0, 6.0),
    ("kernel_d", True, False, 8.0, 9.5),
    ("kernel_e", True, False, 10.5, 11.0),  # after the segment
]


class FakeEvent:
    def __init__(self, name, dev, user, s, e):
        from torch.autograd import DeviceType

        self._n, self._u, self._s, self._e = name, user, s, e
        self._d = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._u

    def start_ns(self):
        return int(round(self._s * 1e9))

    def duration_ns(self):
        return int(round((self._e - self._s) * 1e9))


def fake_prof(events):
    results = SimpleNamespace(events=lambda: [FakeEvent(*e) for e in events])
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_program_gaps_split_the_same_gaps_by_the_innermost_program_range():
    """Gaps [0, 1), [3, 5), [6, 8), [9.5, 10), cut at the ranges' edges:
    [0, 0.55) and [9.8, 10) outside every range, the draw's [0.6, 0.9), the
    join's [6.2, 7.9), the rest in the outer range."""
    gaps = {n: (pytest.approx(s), k) for n, s, k in ps.program_gaps(EVENTS)}
    assert gaps == {ps.NO_SPAN: (pytest.approx(0.75), 2),
                    "outer": (pytest.approx(2.75), 4),
                    "serve.draw": (pytest.approx(0.3), 1),
                    "serve.join": (pytest.approx(1.7), 1)}
    # The harness's own pass over the same events: the same gaps, named by
    # its spans, and its breakdown's keys as they were.
    t = tracing.summarize(fake_prof(EVENTS), units=1)
    assert sum(s for _, s, _ in t.idle_gaps) == pytest.approx(5.5)
    assert sum(k for _, _, k in t.idle_gaps) == 4
    assert set(t.breakdown()) == {"device_ops", "idle_gaps"}
    # Read through `tracing._events` from the profiler's own event objects.
    via = {n: (pytest.approx(s, abs=1e-6), k)
           for n, s, k in ps.program_gaps(tracing._events(fake_prof(EVENTS)))}
    assert via == gaps


def test_program_gaps_need_the_segment():
    with pytest.raises(RuntimeError, match="segment"):
        ps.program_gaps([e for e in EVENTS if e[0] != "portbench::segment"])


def run_of(loop, **counts):
    return SimpleNamespace(loop_name=loop, counts=counts,
                           trace_summary=SimpleNamespace(window_s=2.0))


def test_readings_are_none_where_there_is_nothing_to_read():
    for loop, units in (("filter", {"requests": 4}), ("train", {"steps": 8})):
        r = ps.readings(run_of(loop, **units), {}, None)
        assert r and all(v is None for v in r.values())
        assert all(v is None for v in ps.consistent(r, {}).values())
    assert ps.readings(run_of("other"), {}, None) == {}


def test_readings_of_totals_and_gaps():
    Total = SimpleNamespace
    totals = {"serve.draw": Total(count=8, seconds=0.04),
              "serve.join": Total(count=4, seconds=0.16),
              "serve.stage_in": Total(count=8, seconds=0.008),
              "serve.stage_out": Total(count=8, seconds=0.008),
              "serve.render": Total(count=8, seconds=0.08)}
    gaps = [("serve.join", 0.6, 3), ("serve.draw", 0.1, 2), (ps.NO_SPAN, 0.3, 9)]
    r = ps.readings(run_of("filter", requests=4), totals, gaps)
    assert r == pytest.approx({"draw_ms_per_request.filter": 10.0,
                               "join_ms_per_request.filter": 40.0,
                               "stage_ms_per_render.filter": 2.0,
                               "idle_in_join_share.filter": 30.0,
                               "idle_in_draw_share.filter": 5.0})
    metrics = {"enqueue_ms_per_render.filter": {"value": 10.0},
               "idle_share.filter": {"value": 34.0}}
    assert ps.consistent(r, metrics) == {"stage <= enqueue": True,
                                         "idle in join + draw <= idle": False}


def test_no_tracer_in_the_program(monkeypatch):
    monkeypatch.setitem(sys.modules, "gea_torch.utils.trace", None)
    assert ps.program_tracer() is None


SCRIPT = """
import sys
sys.path[:0] = [{copy!r}, {root!r}]
from portbench import harness
tool = harness.load_file_module({tool!r}, "program_spans")
sys.exit(tool.main({argv!r}))
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return benchcopy.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-filter"])
def test_dry_run(copy, workload):
    argv = ["--workload", workload, "--seed", "2147483713", "--seconds", "0.5",
            "--device", "cpu"]
    code = SCRIPT.format(copy=copy, root=benchcopy.ROOT,
                         tool=os.path.join(copy, "portbench", "tools", "program_spans.py"),
                         argv=argv)
    done = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["readings"] and all(v is not None for v in line["readings"].values())
    assert all(line["consistent"].values())
    prefix = "serve." if workload.endswith("filter") else "dispatch."
    assert line["program_spans"] and all(k.startswith(prefix) for k in line["program_spans"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps", "program_idle_gaps"}
    if prefix == "dispatch.":
        assert set(line["drained"]) == {"dispatch.noise", "dispatch.fill", "dispatch.replay"}
    else:
        assert line["drained"] == {}
