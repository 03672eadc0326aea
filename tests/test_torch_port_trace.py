"""The program's span tracer (`gea_torch.utils.trace`) and its spans in the
serving front (`gea_torch.serve`) and the step dispatcher
(`gea_torch.train.dispatch`), on the CPU.

Off, a span is one shared object and never reaches torch; on, the totals,
counts, self times and nesting are exact against a fake clock; with
ranges, each span is a `record_function` range named
`gea_torch.span::<name>`, entered and left in the spans' order. A filtered
request and a chunk of steps open each of their spans as often as they do
the work.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_port_runner import one_thread, tiny_cfg  # noqa: F401 (an autouse fixture)

from gea_torch import ModelConfig
from gea_torch.models import Discriminator, GeneratorLIS
from gea_torch.serve import ServingModel
from gea_torch.train import build_glis_train_step, create_glis_state
from gea_torch.train.dispatch import build_step_fn
from gea_torch.utils import trace

SERVE_CFG = ModelConfig(image_size=32, code_size=8, r_iterations=1, num_features=4,
                        max_features=16, spatial_code=2, dtype="float32")


@pytest.fixture(autouse=True)
def tracer():
    """Every test starts with the tracer off and empty, and leaves it so."""
    trace.enable(False)
    trace.reset()
    yield trace
    trace.enable(False)
    trace.reset()


class FakeRange:
    """Stands for `record_function`: records the names in the order of
    entries and exits."""

    log = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        FakeRange.log.append(("enter", self.name))
        return self

    def __exit__(self, *exc):
        FakeRange.log.append(("exit", self.name))
        return False


@pytest.fixture
def ranges(monkeypatch):
    """The tracer on with ranges, each range a `FakeRange`."""
    FakeRange.log = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", FakeRange)
    trace.enable(True, ranges=True)
    return FakeRange.log


def fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(trace, "time", SimpleNamespace(perf_counter_ns=lambda: next(it)))


def test_off_is_one_shared_object_that_never_reaches_torch(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function entered while the tracer is off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "time", None)  # any clock read would raise
    a, b = trace.span("a"), trace.span("b")
    assert a is b
    with a, trace.span("c"):
        pass
    assert trace.totals() == {}
    # On without ranges: clocks read, still no range.
    monkeypatch.undo()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    trace.enable(True)
    with trace.span("a"):
        pass
    assert trace.totals()["a"].count == 1


def test_totals_counts_self_time_and_nesting(monkeypatch):
    trace.enable(True)
    # outer [0, 100) holds inner [10, 40) and inner [50, 60), which holds leaf [52, 55).
    fake_clock(monkeypatch, [0, 10, 40, 50, 52, 55, 60, 100])
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        with trace.span("inner"):
            with trace.span("leaf"):
                pass
    t = trace.totals()
    assert t["outer"] == trace.Total(1, 100e-9, 60e-9)
    assert t["inner"] == trace.Total(2, 40e-9, 37e-9)
    assert t["leaf"] == trace.Total(1, 3e-9, 3e-9)
    trace.reset()
    assert trace.totals() == {}


def test_ranges_carry_the_name_and_nest(ranges):
    with trace.span("request"):
        with trace.span("draw"):
            pass
        with trace.span("other"):
            with trace.span("leaf"):
                pass
    with trace.span("free"):
        pass
    p = trace.RANGE_PREFIX
    assert ranges == [
        ("enter", p + "request"), ("enter", p + "draw"), ("exit", p + "draw"),
        ("enter", p + "other"), ("enter", p + "leaf"), ("exit", p + "leaf"),
        ("exit", p + "other"), ("exit", p + "request"),
        ("enter", p + "free"), ("exit", p + "free")]
    assert p == "gea_torch.span::"


def test_enable_returns_what_it_replaces(monkeypatch):
    assert trace.enable(True) == (False, False)
    assert trace.enable(True, ranges=True) == (True, False)
    assert trace.enable(False, ranges=True) == (True, True)
    assert trace.span("x") is trace.span("y")  # ranges need the tracer on
    assert trace.enable(True, ranges=True) == (False, False)


def test_ranges_reach_torch_profiler():
    """The real `record_function`: the spans are user ranges of the trace."""
    trace.enable(True, ranges=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"gea_torch.span::outer", "gea_torch.span::inner"} <= names


def test_threads_keep_their_own_nesting_and_lose_no_count():
    """More threads than cores, a short switch interval: each thread's spans
    nest within its own, and the totals count every span."""
    import sys

    trace.enable(True)
    threads, spans = 16, 500
    errors = []

    def work():
        try:
            for _ in range(spans):
                with trace.span("outer") as outer:
                    with trace.span("inner") as inner:
                        assert trace._local.stack == [outer, inner]
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    t = trace.totals()
    assert t["outer"].count == t["inner"].count == threads * spans
    assert t["outer"].self_seconds == pytest.approx(t["outer"].seconds - t["inner"].seconds)


@pytest.fixture(scope="module")
def serving():
    torch.manual_seed(0)
    g = GeneratorLIS(SERVE_CFG, device="cpu")
    d = Discriminator(SERVE_CFG, device="cpu")
    return ServingModel.from_modules(g, d, all_stages=False)


SERVE_SPANS = ("serve.draw", "serve.stage_in", "serve.render", "serve.stage_out",
               "serve.join", "serve.topk")


@pytest.mark.parametrize("sharded", [False, True])
def test_filtered_request_opens_each_serving_span(serving, ranges, sharded):
    """256 of 4 x 256 candidates in renders of 512: two draws, stagings and
    renders, one join and one top-k, each a range of its own, and none
    nested in another."""
    model = serving.sharded() if sharded else serving
    out = model.sample_filtered(256, seed=11, batch_size=512, oversample=4)
    assert out["images"].shape[0] == 256
    t = trace.totals()
    assert set(t) == set(SERVE_SPANS)
    counts = {k: v.count for k, v in t.items()}
    assert counts == {"serve.draw": 2, "serve.stage_in": 2, "serve.render": 2,
                      "serve.stage_out": 2, "serve.join": 1, "serve.topk": 1}
    assert all(v.self_seconds == v.seconds for v in t.values())
    p = trace.RANGE_PREFIX
    spans = [n for _, n in ranges if n.startswith(p)]
    assert spans[::2] == spans[1::2]  # each range left before the next opens
    assert {n[len(p):] for n in spans} == set(SERVE_SPANS)


def test_rounds_open_a_draw_and_a_topk_each(serving):
    trace.enable(True)
    serving.sample_filtered(4, seed=3, batch_size=8, oversample=2, threshold=1.1,
                            max_rounds=3)
    counts = {k: v.count for k, v in trace.totals().items()}
    assert counts["serve.topk"] == counts["serve.join"] == counts["serve.draw"] == 3


def test_serving_off_records_nothing(serving):
    serving.sample_filtered(4, seed=3, batch_size=8, oversample=2)
    assert trace.totals() == {}


def test_dispatcher_opens_its_spans_once_a_chunk(tmp_path, ranges):
    """Two chunks of 3 steps: noise, fill and replay once each a chunk, in
    that order."""
    cfg = tiny_cfg(tmp_path, steps_per_dispatch=3)
    state = create_glis_state(cfg, device="cpu")
    fn = build_step_fn(cfg, build_glis_train_step(cfg))
    real = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 16, 16, 3))
                            .astype(np.float32))
    for _ in range(2):
        fn(state, [real] * 3)
    assert state.step == 6
    names = ("dispatch.noise", "dispatch.fill", "dispatch.replay")
    assert {k: v.count for k, v in trace.totals().items()} == {n: 2 for n in names}
    p = trace.RANGE_PREFIX
    # Adam's step opens ranges of its own.
    assert [n for what, n in ranges if what == "enter" and n.startswith(p)] == [
        p + n for _ in range(2) for n in names]
