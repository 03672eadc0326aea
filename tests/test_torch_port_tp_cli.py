"""The three trainer CLIs with `--model_shards` on gloo ranks on the CPU:
`gea`'s checks and messages, and runs held to single-process runs of the
same flags (a tensor-parallel run is the single program on the global
batch: the same stream, the same draws, the same updates).

Each compared pair writes its last checkpoint; every tensor of the two
`state.pt` files agrees (parameters and the EMA to atol 1e-5, Adam's
moments to atol 1e-6 + rtol 1e-5; steps, the generator's state and the
schedules exactly), so a tensor-parallel run saves the gathered state in
the single-process form. G-LIS at data 1 x model 2 with `--g_ema` and a
cosine schedule, with `--steps_per_dispatch 2`, with `--debug_checks`,
and at data 2 x model 2 with `--grad_accum 4` (a microbatch of 2 rows
over 4 ranks); the
checkpoints also round-trip: a tensor-parallel run resumes single-process
and the reverse, each then equal to an uninterrupted single-process run;
R-separate and R-iterative at 1 x 2; `info` reads a tensor-parallel run.
"""

import os

import numpy as np
import pytest
import torch

from gea_torch.cli import info, train_glis, train_r_iterative, train_r_separate
from gea_torch.utils.checkpoint import latest_step

TINY = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size", "32",
        "--code_size", "16", "--num_features", "4", "--max_features", "16",
        "--dtype", "float32", "--log_interval", "1", "--vis_rows", "2", "--vis_interval", "0"]
GLIS = TINY + ["--r_iterations", "1", "--batch_size", "8"]
TP = ["--num_devices", "2", "--model_shards", "2", "--tp_min_width", "4"]
CLIS = {"glis": train_glis, "r_separate": train_r_separate, "r_iterative": train_r_iterative}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def saved(run) -> dict:
    return torch.load(os.path.join(run, "checkpoints", str(latest_step(run)), "state.pt"),
                      weights_only=True)


def assert_same_state(got, want, path="") -> None:
    if torch.is_tensor(want):
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if not want.is_floating_point():
            assert torch.equal(got, want), path
        elif "exp_avg" in path:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0,
                                       err_msg=path)
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_state(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_state(a, b, f"{path}/{i}")
    else:
        assert got == want, path


@pytest.mark.parametrize("extra,world", [
    (["--g_ema", "0.9", "--lr_schedule", "cosine", "--vis_interval", "3"], "1x2"),
    (["--steps_per_dispatch", "2"], "1x2"),
    (["--grad_accum", "4"], "2x2"),
    (["--debug_checks"], "1x2"),
], ids=["ema_cosine", "dispatch_2", "microbatch", "debug_checks"])
def test_glis_tp_run_is_the_single_process_run(tmp_path, capfd, extra, world):
    args = GLIS + ["--niter", "3", "--save_interval", "3", *extra]
    tp = TP if world == "1x2" else ["--num_devices", "4", "--model_shards", "2",
                                    "--tp_min_width", "4"]
    train_glis.main(args + ["--save_path", str(tmp_path / "one")])
    train_glis.main(args + tp + ["--save_path", str(tmp_path / "tp")])
    out = capfd.readouterr().out
    assert f"tensor parallel: {tp[1]} ranks on cpu (data {int(tp[1]) // 2} x model 2)" in out
    assert "tp: " in out and "of state leaves sharded over 2 model shards" in out
    assert_same_state(saved(str(tmp_path / "tp")), saved(str(tmp_path / "one")))


def test_checkpoints_round_trip_between_tp_and_single_process(tmp_path, capfd):
    # A constant lr: a schedule's length is --niter, which the relaunch changes.
    args = GLIS + ["--g_ema", "0.9", "--save_interval", "2"]
    straight = str(tmp_path / "straight")
    train_glis.main(args + ["--niter", "4", "--save_path", straight])
    for first, then in ((TP, []), ([], TP)):
        run = str(tmp_path / f"run_{len(first)}")
        train_glis.main(args + first + ["--niter", "2", "--save_path", run])
        train_glis.main(args + then + ["--niter", "4", "--save_path", run])
        assert f"resumed from {run} at step 2" in capfd.readouterr().out
        assert_same_state(saved(run), saved(straight))
    info.main(["--load_path", str(tmp_path / "run_6")])
    assert "step" in capfd.readouterr().out


@pytest.fixture(scope="module")
def g_run(tmp_path_factory):
    run = str(tmp_path_factory.mktemp("g") / "run")
    train_glis.main(GLIS + ["--niter", "2", "--save_interval", "2", "--save_path", run])
    return run


@pytest.mark.parametrize("trainer", ["r_separate", "r_iterative"])
def test_r_tp_run_is_the_single_process_run(tmp_path, g_run, trainer):
    if trainer == "r_separate":
        args = ["--device", "cpu", "--g_path", g_run, "--batch_size", "8", "--vis_rows", "2",
                "--vis_interval", "0", "--log_interval", "1", "--r_mine_weight", "0.5"]
    else:
        args = TINY + ["--r_hidden", "32", "--batch_size", "8"]
    args += ["--niter", "3", "--save_interval", "3"]
    CLIS[trainer].main(args + ["--save_path", str(tmp_path / "one")])
    CLIS[trainer].main(args + TP + ["--save_path", str(tmp_path / "tp")])
    assert_same_state(saved(str(tmp_path / "tp")), saved(str(tmp_path / "one")))


@pytest.mark.parametrize("extra,error,match", [
    (["--model_shards", "2"], SystemExit, r"--model_shards 2 needs multiple devices \(1 visible\)"),
    (["--model_shards", "2", "--num_devices", "2", "--multihost"], SystemExit,
     r"--model_shards is single-host only \(DP covers pods\)"),
    (["--model_shards", "3", "--num_devices", "4"], ValueError,
     "model_shards 3 must divide the device count 4"),
    (["--model_shards", "2", "--num_devices", "4", "--grad_accum", "8"], ValueError,
     "per-data-shard batch 4 must divide by --grad_accum 8"),
], ids=["one_device", "multihost", "divide", "grad_accum"])
@pytest.mark.parametrize("trainer", list(CLIS))
def test_clis_check_the_tp_world_with_geas_messages(tmp_path, g_run, trainer, extra, error,
                                                    match):
    """Before any rank starts or a step runs."""
    if trainer == "r_separate":
        args = ["--device", "cpu", "--g_path", g_run, "--batch_size", "8"]
    else:
        args = GLIS if trainer == "glis" else TINY + ["--batch_size", "8"]
    with pytest.raises(error, match=match):
        CLIS[trainer].main(args + ["--niter", "1", "--save_path", str(tmp_path / "run"),
                                   *extra])
    assert not os.path.exists(tmp_path / "run" / "checkpoints")
