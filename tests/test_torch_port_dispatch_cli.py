"""The trainers of the port under `--steps_per_dispatch`, `--debug_checks`,
`--profile_dir` and `--tensorboard`, on the CPU at a tiny config
(`--device cpu`; the kernels run their plain versions).

The contracts are `gea`'s (`tests/test_runner.py`, `tests/test_cli_smoke.py`,
`tests/test_grad_accum.py`): the loop advances K steps a dispatch and fires
its side effects at chunk ends, the ragged tail runs what is left, a resume
at a step that is not a multiple of K equals a run never interrupted bit for
bit, the NaN guard reads every step of a chunk, the sanitizer names the op
and the step within the chunk and covers the R trainers, the profiler
leaves a trace, and the scalars land in <run>/tb (or the writer says why
not).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_port_runner import (  # noqa: F401 (one_thread: an autouse fixture)
    TINY,
    assert_states_equal,
    one_thread,
    steps_on_disk,
    tiny_cfg,
)

from gea_torch.cli import train_glis, train_r_iterative, train_r_separate
from gea_torch.config import TrainGLISConfig
from gea_torch.train import build_glis_train_step, create_glis_state
from gea_torch.train.dispatch import build_step_fn
from gea_torch.train.runner import TrainLoop, prepare_run
from gea_torch.utils import checkpoint as ckpt


def cli(tmp_path, name, *args, module=train_glis):
    return module.main(TINY + ["--save_path", str(tmp_path / name), *args])


def test_chunked_run_cadence(tmp_path):
    """`gea`'s `test_chunked_dispatch_full_run`: niter 11 with K 4 runs
    chunks of 4, 4 and 3, saves at 8 (crossed inside the second chunk) and
    at 11, and renders its grid at 8."""
    state, _ = cli(tmp_path, "run", "--niter", "11", "--steps_per_dispatch", "4",
                   "--log_interval", "4", "--vis_interval", "8", "--save_interval", "8")
    run = str(tmp_path / "run")
    assert state.step == 11
    assert steps_on_disk(run) == [8, 11]
    assert sorted(os.listdir(os.path.join(run, "samples"))) == [
        "samples_00000008_stage0.png", "samples_00000008_stage1.png"]


def test_misaligned_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """5 steps (a chunk of 4 and the tail of 1), a relaunch at 5 to 11
    (chunks of 4 and 2), against 11 straight (4, 4, 3): the same state bit
    for bit, data stream, generator and Adam included."""
    args = ["--steps_per_dispatch", "4", "--vis_interval", "0", "--save_interval", "0"]
    straight, _ = cli(tmp_path, "a", "--niter", "11", *args)
    cli(tmp_path, "b", "--niter", "5", *args)
    assert steps_on_disk(str(tmp_path / "b")) == [5]
    resumed, _ = cli(tmp_path, "b", "--niter", "11", *args)
    assert "at step 5" in capsys.readouterr().out
    assert resumed.step == straight.step == 11
    assert_states_equal(resumed, straight)


def test_grad_accum_under_chunks_trains_and_resumes(tmp_path):
    """`gea`'s `test_accum_composes_with_chunked_dispatch`: --grad_accum 2
    under --steps_per_dispatch 2 through the CLI, and its resume."""
    args = ["--grad_accum", "2", "--steps_per_dispatch", "2", "--vis_interval", "10",
            "--save_interval", "4"]
    state, _ = cli(tmp_path, "run", "--niter", "4", *args)
    assert state.step == 4
    state, stats = cli(tmp_path, "run", "--niter", "8", *args)
    assert state.step == 8 and np.isfinite(stats["metrics"]["loss_d"])


def stub_loop(tmp_path, cfg, step_fn):
    run_dir = prepare_run(cfg)
    state = create_glis_state(cfg, device="cpu")
    return TrainLoop(cfg, run_dir, state, step_fn, iter(lambda: None, 1),
                     lambda batch, step: None), run_dir


def test_nan_anywhere_in_a_chunk_writes_a_postmortem(tmp_path):
    """The guard reads every step of a chunk, not only its last: a NaN in
    the second of three aborts at the chunk's end with a post-mortem."""
    cfg = tiny_cfg(tmp_path, niter=9, log_interval=3, save_interval=0, vis_interval=0,
                   steps_per_dispatch=3)
    plotted = []

    def step_fn(state, reals):
        state.step += len(reals)
        loss = torch.ones(len(reals))
        if state.step == 6:
            loss[1] = float("nan")
        return {"loss_d": loss, "loss_g": loss}

    loop, run_dir = stub_loop(tmp_path, cfg, step_fn)
    loop.plotter.add = lambda step, **kw: plotted.append(step)
    with pytest.raises(FloatingPointError, match=r"non-finite metrics \['loss_d', 'loss_g'\] "
                                                 "at iter 6"):
        loop.run(0)
    assert ckpt.latest_step(run_dir) == 6
    assert plotted == [1, 2, 3]  # every inner step of the logged chunk


def glis_dispatch(tmp_path, k):
    cfg = tiny_cfg(tmp_path, steps_per_dispatch=k, debug_checks=True)
    state = create_glis_state(cfg, device="cpu")
    real = np.random.default_rng(0).uniform(-1, 1, (k, 4, 16, 16, 3)).astype(np.float32)
    return state, build_step_fn(cfg, build_glis_train_step(cfg)), torch.from_numpy(real)


@pytest.mark.parametrize("bad", [0, 1, 2])
def test_debug_checks_name_the_step_within_the_chunk(tmp_path, capsys, bad):
    """`gea`'s `test_checked_chunked_dispatch_covers_scan`: a NaN born in
    any step of a chunk raises at its producing op, naming the step; clean
    chunks, the ragged tail included, stack their metrics (k,)."""
    state, dispatch, real = glis_dispatch(tmp_path, 3)
    assert "--debug_checks" in capsys.readouterr().out  # the cost warning
    metrics = dispatch(state, list(real))
    assert {v.shape for v in metrics.values()} == {(3,)} and state.step == 3
    assert {v.shape for v in dispatch(state, list(real[:1])).values()} == {(1,)}
    real[bad, 0, 5, 5, 1] = float("nan")
    with pytest.raises(FloatingPointError) as info:
        dispatch(state, list(real))
    msg = str(info.value)
    assert f"step {bad + 1} of 3 of the chunk at iters 5..7 (iter {5 + bad})" in msg
    assert "aten.cat.default" in msg  # the real batch meets the fakes in D's input
    assert state.step == 4 + bad + 1  # the steps before it ran


def test_debug_checks_name_the_module(tmp_path):
    """A NaN in one of D's weights surfaces in D's forward, named by its
    module path."""
    state, dispatch, real = glis_dispatch(tmp_path, 1)
    name, p = next((n, p) for n, p in state.discriminator.named_parameters()
                   if "head" not in n and p.dim() > 1)
    with torch.no_grad():
        p.view(-1)[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"in discriminator\.[\w.]+ at iter 1 "):
        dispatch(state, list(real))


def test_r_trainers_honor_debug_checks(tmp_path, capsys):
    """`gea`'s `test_r_trainers_honor_debug_checks`: both R trainers build
    their step through the shared `build_step_fn`, and a clean run under
    the checks, chunked, completes."""
    cli(tmp_path, "g", "--niter", "2", "--vis_interval", "0", "--save_interval", "2")
    r_sep = ["--device", "cpu", "--g_path", str(tmp_path / "g"), "--batch_size", "4",
             "--niter", "4", "--log_interval", "1", "--vis_interval", "0", "--save_interval",
             "4", "--vis_rows", "2", "--debug_checks", "--steps_per_dispatch", "2"]
    state, _ = train_r_separate.main(r_sep + ["--save_path", str(tmp_path / "rsep")])
    assert state.step == 4
    state, stats = cli(tmp_path, "riter", "--niter", "3", "--r_hidden", "8", "--r_chain_length",
                       "1", "--vis_interval", "0", "--save_interval", "3", "--debug_checks",
                       "--steps_per_dispatch", "2", module=train_r_iterative)
    assert state.step == 3 and np.isfinite(stats["metrics"]["loss_r_sim"])
    assert capsys.readouterr().out.count("--debug_checks: every floating output") == 2


def test_nan_in_the_input_stops_the_cli(tmp_path, monkeypatch):
    """Through the G-LIS CLI: the batch of iter 6 carries a NaN; the
    checked chunk (5..8) raises at iter 6 and no later step runs."""
    make = train_glis.make_input_fn

    def poisoned(*args):
        fn = make(*args)

        def real(batch, step):
            out = fn(batch, step)
            if step == 5:
                out = out.clone()
                out[0, 0, 0, 0] = float("nan")
            return out

        return real

    monkeypatch.setattr(train_glis, "make_input_fn", poisoned)
    with pytest.raises(FloatingPointError, match=r"step 2 of 4 .*\(iter 6\)"):
        cli(tmp_path, "run", "--niter", "8", "--steps_per_dispatch", "4", "--debug_checks",
            "--vis_interval", "0", "--save_interval", "0")
    assert not os.path.exists(tmp_path / "run" / "checkpoints")


@pytest.mark.parametrize("k,iters", [(1, "11-15"), (4, "9-16")])
def test_profile_dir_leaves_a_trace(tmp_path, k, iters):
    """Steps start+10..start+15, rounded out to chunk ends: iters 11..15
    one step at a time, 9..16 in chunks of 4."""
    prof = tmp_path / "prof"
    cli(tmp_path, "run", "--niter", "16", "--steps_per_dispatch", str(k), "--vis_interval",
        "0", "--save_interval", "0", "--log_interval", "8", "--profile_dir", str(prof))
    assert os.listdir(prof) == [f"trace_{iters}.json"]
    events = json.loads((prof / f"trace_{iters}.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_profile_dir_trace_names_the_dispatch_spans(tmp_path):
    """While the profiler runs the program's spans are ranges: the trace
    names each chunk's `gea_torch.span::dispatch.*` beside its ops; the
    tracer is off again after."""
    from gea_torch.utils import trace

    prof = tmp_path / "prof"
    cli(tmp_path, "run", "--niter", "16", "--steps_per_dispatch", "4", "--vis_interval",
        "0", "--save_interval", "0", "--log_interval", "8", "--profile_dir", str(prof))
    events = json.loads((prof / "trace_9-16.json").read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    for span in ("dispatch.noise", "dispatch.fill", "dispatch.replay"):
        assert names.count("gea_torch.span::" + span) == 2, span
    assert trace.span("x") is trace.span("y")


def test_tensorboard_writes_the_scalars(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cli(tmp_path, "run", "--niter", "6", "--steps_per_dispatch", "3", "--log_interval", "3",
        "--vis_interval", "0", "--save_interval", "0", "--tensorboard")
    acc = EventAccumulator(str(tmp_path / "run" / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train/loss_d", "train/loss_g", "train/d_real", "perf/images_per_sec",
            "perf/steps_per_sec"} <= tags
    assert [e.step for e in acc.Scalars("train/loss_d")] == [3, 6]


def test_tensorboard_disabled_when_the_writer_cannot_load(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    state, _ = cli(tmp_path, "run", "--niter", "2", "--vis_interval", "0", "--save_interval",
                   "0", "--tensorboard")
    assert state.step == 2
    assert "[gea_torch] tensorboard disabled (" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "run" / "tb")


def test_flags_are_accepted_by_all_three_configs():
    from gea_torch.config import TrainRIterativeConfig, TrainRSeparateConfig, refuse_unported

    for cls in (TrainGLISConfig, TrainRSeparateConfig, TrainRIterativeConfig):
        refuse_unported(cls(steps_per_dispatch=4, debug_checks=True, tensorboard=True,
                            profile_dir="prof"))
