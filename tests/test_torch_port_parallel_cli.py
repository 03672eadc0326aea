"""Data parallelism through the port's entry points on the CPU: the three
trainers with `--num_devices 2 --device cpu` (two gloo processes), the
collective guards, `--multihost`, the device count, and data-parallel
serving (`ServingModel.sharded`, `serve_http --data_parallel`).

Every spawn has a timeout that fails the test on a hang.
"""

import os
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_port_dp_workers as workers

from gea_torch import serve, serve_http
from gea_torch.cli import export_model, train_glis, train_r_iterative, train_r_separate
from gea_torch.config import TrainGLISConfig
from gea_torch.interop import (
    discriminator_from_jax_params,
    generator_from_jax_params,
    init_discriminator_params,
    init_generator_params,
)
from gea_torch.parallel import launcher_env, resolve_num_devices, spawn
from gea_torch.parallel.mesh import Launch, free_port
from gea_torch.train.runner import input_iterator
from gea_torch.utils import checkpoint as ckpt
from gea_torch.utils.hostmem import EXIT_HOST_RSS

SPAWN_TIMEOUT_S = 240
TINY = ["--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size", "32",
        "--code_size", "16", "--num_features", "4", "--max_features", "16", "--batch_size", "4",
        "--dtype", "float32", "--log_interval", "1", "--vis_rows", "2"]
TRAINERS = {
    "glis": (train_glis, "TrainGLISConfig", TINY + ["--r_iterations", "1"]),
    "r_separate": (train_r_separate, "TrainRSeparateConfig",
                   ["--device", "cpu", "--batch_size", "4", "--log_interval", "1",
                    "--vis_rows", "2", "--r_hidden", "32"]),
    "r_iterative": (train_r_iterative, "TrainRIterativeConfig", TINY + ["--r_hidden", "32"]),
}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in the spawned ranks, so that runs
    compared bit for bit take the same path through torch's CPU kernels."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g_run(tmp_path_factory):
    """A tiny G-LIS run of one process: R-separate's frozen G and D."""
    run = str(tmp_path_factory.mktemp("glis") / "run")
    train_glis.main(TRAINERS["glis"][2] + ["--save_path", run, "--niter", "2",
                                          "--save_interval", "2", "--vis_interval", "0"])
    return run


def argv(trainer, g_run, run, niter):
    base = TRAINERS[trainer][2] + (["--g_path", g_run] if trainer == "r_separate" else [])
    return base + ["--save_path", run, "--niter", str(niter), "--vis_interval", "2",
                   "--save_interval", "2"]


def files(run):
    return sorted(os.path.relpath(os.path.join(d, f), run)
                  for d, _, fs in os.walk(run) for f in fs)


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_world2_cli_writes_on_the_lead_and_resumes(trainer, g_run, tmp_path):
    """`--num_devices 2`: the run directory holds what one writer writes
    (config.json, the checkpoints at 2 and 4, a grid per stage and
    interval), `run()` returns the lead's state (its last checkpoint), and
    a run of 2 steps resumed to 4 in one group of two ranks, in which the
    second rank may write nothing under the run directory, reaches that
    state bit for bit."""
    module, cls, _ = TRAINERS[trainer]
    whole = str(tmp_path / "whole")
    state, stats = module.main(argv(trainer, g_run, whole, 4) + ["--num_devices", "2"])
    assert state.step == 4 and np.isfinite(list(stats["metrics"].values())).all()
    assert stats["images_per_sec"] > 0
    written = files(whole)
    assert "config.json" in written
    assert [f for f in written if f.startswith("checkpoints")] == [
        "checkpoints/2/state.pt", "checkpoints/4/state.pt"]
    assert any(f.startswith("samples/samples_00000004_stage") for f in written)
    want = ckpt.load_checkpoint(whole, 4)
    assert not workers_diff(ckpt.state_dict(state), want)

    split = str(tmp_path / "split")
    runs = [argv(trainer, g_run, split, 2), argv(trainer, g_run, split, 4)]
    name = module.__name__.split(".")[-1]
    spawn(workers.resume, 2, torch.device("cpu"), args=(name, cls, runs), timeout=SPAWN_TIMEOUT_S)
    got = ckpt.load_checkpoint(split, 4)
    assert not workers_diff(got, want)


def workers_diff(a, b, path=""):
    """The paths at which two nests of tensors and values differ."""
    if torch.is_tensor(a):
        return [] if torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b) else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [p for k in a for p in workers_diff(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in workers_diff(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def test_rss_trip_on_one_rank_stops_every_rank(tmp_path, capfd):
    """Rank 1 alone exceeds the host-RSS budget: both ranks save once (the
    lead writes the checkpoint of the step they stopped at) and exit 19,
    with `gea`'s message."""
    run, marks = str(tmp_path / "run"), str(tmp_path / "marks")
    os.makedirs(marks)
    args = TRAINERS["glis"][2] + ["--save_path", run, "--niter", "6", "--save_interval", "0",
                                  "--vis_interval", "0", "--max_host_rss_gb", "1000"]
    with pytest.raises(SystemExit) as e:
        spawn(workers.rss_trip, 2, torch.device("cpu"),
              args=("train_glis", "TrainGLISConfig", args, marks), timeout=SPAWN_TIMEOUT_S)
    assert e.value.code == EXIT_HOST_RSS
    assert sorted(os.listdir(marks)) == ["rank0", "rank1"]
    for r in (0, 1):
        with open(os.path.join(marks, f"rank{r}")) as f:
            assert f.read() == str(EXIT_HOST_RSS)
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["1"]
    out = capfd.readouterr().out
    assert out.count(f"Checkpoint saved at step 1; exiting {EXIT_HOST_RSS}") == 2


def test_debug_checks_take_the_spawn_down(tmp_path):
    """`--debug_checks` runs under `--num_devices 2`; a NaN in rank 1's
    input raises there (the averaged gradients carry it to rank 0 too), and
    the spawn ends with the error instead of leaving a rank waiting."""
    args = TRAINERS["glis"][2] + ["--save_path", str(tmp_path / "run"), "--niter", "4",
                                  "--debug_checks", "--vis_interval", "0"]
    with pytest.raises(Exception, match="FloatingPointError"):
        spawn(workers.nan_on_rank1, 2, torch.device("cpu"), args=(args,),
              timeout=SPAWN_TIMEOUT_S)
    assert not os.path.exists(tmp_path / "run" / "checkpoints")


def test_num_devices_beyond_the_visible_count_raises(tmp_path, monkeypatch):
    """`gea`'s message, naming the counts; nothing runs on fewer devices.
    On a one-card host, `--num_devices 2` raises."""
    too_many = (os.cpu_count() or 1) + 1
    with pytest.raises(ValueError, match=f"requested {too_many} devices but only "
                                         f"{os.cpu_count()} visible"):
        train_glis.main(TRAINERS["glis"][2] + ["--save_path", str(tmp_path / "run"),
                                              "--niter", "1", "--num_devices", str(too_many)])
    assert not os.path.exists(tmp_path / "run")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1 visible"):
        resolve_num_devices(2, torch.device("cuda"))
    assert resolve_num_devices(0, torch.device("cuda")) == 1
    assert resolve_num_devices(0, torch.device("cpu")) == 1


def test_launcher_env_reads_torchrun_and_geas_variables():
    torchrun = {"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
                "MASTER_PORT": "29500"}
    assert launcher_env(torchrun) == Launch(3, 8, 1, "env://")
    gea = {"GEA_COORDINATOR": "h:1234", "GEA_NUM_PROCESSES": "2", "GEA_PROCESS_ID": "1",
           "LOCAL_RANK": "0"}
    assert launcher_env(gea) == Launch(1, 2, 0, "tcp://h:1234")
    with pytest.raises(SystemExit, match="GEA_COORDINATOR"):
        launcher_env({})


def test_multihost_runs_one_rank_of_the_launchers_group(tmp_path, monkeypatch, capsys):
    """`--multihost` under torchrun's environment of world size 1: the run
    joins the group (gloo on the CPU), trains through the data-parallel
    step and writes as the lead; `--fid_interval` with more than one
    process is refused, as in `gea`."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    run = str(tmp_path / "run")
    try:
        state, _ = train_glis.main(TRAINERS["glis"][2] + [
            "--save_path", run, "--niter", "2", "--save_interval", "2", "--vis_interval", "0",
            "--multihost"])
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert state.step == 2 and ckpt.latest_step(run) == 2
    assert "multihost: process 0/1" in capsys.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--fid_interval is not supported with --multihost"):
        train_glis.main(TRAINERS["glis"][2] + ["--save_path", run, "--multihost",
                                              "--fid_interval", "2"])


def test_device_data_cache_is_single_host(tmp_path):
    cfg = TrainGLISConfig.from_args(TRAINERS["glis"][2] + ["--device_data_cache"])
    world2 = types.SimpleNamespace(size=2, rank=0)
    with pytest.raises(ValueError, match="--device_data_cache is single-host"):
        input_iterator(cfg, torch.device("cpu"), cfg.seed, dp=world2)


# ------------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def served():
    """The tiny G-LIS G and D with every stage and the scores: the live
    function and its `torch.export` program, on the CPU."""
    cfg = TrainGLISConfig.from_args(TRAINERS["glis"][2] + ["--spatial_code", "2"])
    g = generator_from_jax_params(init_generator_params(cfg, 0), cfg, device="cpu")
    d = discriminator_from_jax_params(init_discriminator_params(cfg, 1), cfg, device="cpu")
    live = serve.ServingModel.from_modules(g, d)
    program = serve.ServingModel(export_model.export_program(live, 0), live.manifest,
                                 device="cpu")
    return {"live": live, "program": program}


@pytest.mark.parametrize("kind", ["live", "program"])
def test_sharded_equals_the_single_device_call(served, kind):
    """`gea`'s tests/test_export.py:324 on two CPU replicas: bit for bit at
    batches 1, 3 and 5 (padded to an even split and trimmed), through
    `__call__`, `sample` and `sample_filtered`."""
    model = served[kind]
    sharded = model.sharded(["cpu", "cpu"])
    assert len(sharded.replicas) == 2
    rng = np.random.default_rng(11)
    for n in (1, 3, 5):
        z = rng.standard_normal((n, model.code_size)).astype(np.float32)
        sn = rng.standard_normal((n, *model.spatial_noise_shape)).astype(np.float32)
        want, got = model(z, sn), sharded(z, sn)
        assert got["images"].shape[0] == n and got["stages"].shape[1] == n
        for k in want:
            assert np.array_equal(got[k], want[k]), (n, k)
    for k, v in model.sample(6, seed=1, batch_size=4).items():
        assert np.array_equal(sharded.sample(6, seed=1, batch_size=4)[k], v), k
    best = sharded.sample_filtered(3, seed=2, batch_size=4, oversample=2)
    assert np.array_equal(best["scores"], model.sample_filtered(
        3, seed=2, batch_size=4, oversample=2)["scores"])


def test_sharded_pinned_batch_must_split(served):
    model = served["live"]
    pinned = serve.ServingModel(model.exported, {**model.manifest, "batch": 3}, device="cpu")
    with pytest.raises(ValueError, match="pinned batch 3 is not divisible by 2 devices"):
        pinned.sharded(["cpu", "cpu"])
    assert len(pinned.sharded().replicas) == 1  # the model's own device on the CPU


def test_serve_http_data_parallel_answers(served):
    """`serve_http --data_parallel 1 --device cpu`: the server renders
    through `ServingModel.sharded()` and answers."""
    import json
    import urllib.request

    server, batcher = serve_http.make_server("", port=0, model=served["live"],
                                             data_parallel=True, device="cpu")
    assert isinstance(batcher.model, serve.DataParallelServingModel)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/render"
        req = urllib.request.Request(url, data=json.dumps({"count": 3, "seed": 1}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
            assert r.status == 200
        assert len(body["images"]) == 3 and len(body["scores"]) == 3
    finally:
        server.shutdown()
        batcher.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
