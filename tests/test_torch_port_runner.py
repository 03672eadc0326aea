"""The port's G-LIS trainer (`python -m gea_torch.cli.train_glis`), its loop
and its checkpoints, on the CPU at a tiny config (`--device cpu`; the
kernels run their plain versions).

The contracts are `gea`'s (`tests/test_runner.py`,
`tests/test_checkpoint_and_r.py`, `tests/test_resume_determinism.py`):
artifacts and resume; 6 steps straight equal 3 steps, a resume and 3 more,
bit for bit in fp32; save_path wins over load_path; interval 0 disables;
a NaN writes a post-mortem checkpoint; retention; the EMA schema evolution;
the RSS guard. Flags the port does not implement raise.
"""

import os

import pytest
import torch

from gea_torch.cli import train_glis
from gea_torch.config import UNPORTED, TrainGLISConfig
from gea_torch.train import create_glis_state, runner
from gea_torch.train.runner import TrainLoop, maybe_resume, prepare_run
from gea_torch.utils import checkpoint as ckpt
from gea_torch.utils.hostmem import EXIT_HOST_RSS

TINY = [
    "--device", "cpu", "--dataset", "synthetic", "--image_size", "16", "--crop_size", "32",
    "--code_size", "16", "--num_features", "4", "--max_features", "16", "--batch_size", "4",
    "--dtype", "float32", "--log_interval", "1", "--vis_rows", "2", "--r_iterations", "1",
]


@pytest.fixture(autouse=True)
def one_thread():
    """Results compared bit for bit are computed with one intra-op thread,
    so that every run takes the same path through torch's CPU kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cli(tmp_path, name, *args):
    return train_glis.main(TINY + ["--save_path", str(tmp_path / name), *args])


def flat(state) -> dict:
    """The whole train state as {path: tensor or value}."""
    out = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}.{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = obj

    walk(ckpt.state_dict(state), "")
    return out


def assert_states_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def steps_on_disk(run):
    return sorted(int(d) for d in os.listdir(os.path.join(run, "checkpoints")) if d.isdigit())


def test_cli_writes_artifacts_and_resumes(tmp_path, capsys):
    state, stats = cli(tmp_path, "run", "--niter", "4", "--vis_interval", "2",
                       "--save_interval", "2")
    run = str(tmp_path / "run")
    assert state.step == 4 and stats["images_per_sec"] > 0
    assert TrainGLISConfig.load(os.path.join(run, "config.json")) == \
        TrainGLISConfig.from_args(TINY + ["--save_path", run, "--niter", "4",
                                          "--vis_interval", "2", "--save_interval", "2"])
    assert steps_on_disk(run) == [2, 4]
    for s in (2, 4):
        for stage in (0, 1):
            assert os.path.isfile(os.path.join(run, "samples",
                                               f"samples_{s:08d}_stage{stage}.png"))
    assert os.path.isfile(os.path.join(run, "plots", "loss.png"))
    capsys.readouterr()
    state, _ = cli(tmp_path, "run", "--niter", "6", "--vis_interval", "0", "--save_interval", "0")
    assert f"resumed from {run} at step 4" in capsys.readouterr().out
    assert state.step == 6 and steps_on_disk(run) == [2, 4, 6]


@pytest.mark.parametrize("extra", [
    [],
    ["--gan_loss", "wgan-gp", "--g_ema", "0.9", "--spatial_code", "2"],
    ["--on_device_pipeline", "false"],
    ["--synthetic_on_device", "true"],
], ids=["bce", "wgan_ema_spatial", "host_preprocess", "synthetic_on_device"])
def test_resume_is_bit_identical(tmp_path, extra):
    """6 steps straight against 3, a resume, and 3 more: the whole state
    (parameters, Adam, generator, EMA) bit for bit."""
    args = extra + ["--vis_interval", "0", "--log_interval", "3"]
    straight, _ = cli(tmp_path, "straight", "--niter", "6", "--save_interval", "6", *args)
    cli(tmp_path, "resumed", "--niter", "3", "--save_interval", "3", *args)
    resumed, _ = cli(tmp_path, "resumed", "--niter", "6", "--save_interval", "6", *args)
    assert straight.step == resumed.step == 6
    assert_states_equal(straight, resumed)


def tiny_cfg(tmp_path, **kw):
    return TrainGLISConfig.from_args(TINY + ["--save_path", str(tmp_path)]).replace(**kw)


def state_at(cfg, step, seed=0):
    state = create_glis_state(cfg, seed=seed, device="cpu")
    state.step = step
    with torch.no_grad():
        for p in state.generator.parameters():
            p.add_(step)
    return state


def test_save_path_wins_over_load_path(tmp_path, capsys):
    warm, own = tmp_path / "warm", tmp_path / "own"
    cfg = tiny_cfg(own, load_path=str(warm))
    ckpt.save_checkpoint(str(warm), 5, state_at(cfg, 5))
    restored, start = maybe_resume(cfg, state_at(cfg, 0, seed=1))
    assert start == 5 and restored.step == 5
    assert_states_equal(restored, state_at(cfg, 5))
    ckpt.save_checkpoint(str(own), 9, state_at(cfg, 9))
    restored, start = maybe_resume(cfg, state_at(cfg, 0, seed=1))
    assert start == 9
    assert_states_equal(restored, state_at(cfg, 9))
    assert "ignoring --load_path" in capsys.readouterr().out
    fresh, start = maybe_resume(tiny_cfg(tmp_path / "fresh"), state_at(cfg, 0))
    assert start == 0


def test_empty_load_path_fails_fast(tmp_path):
    with pytest.raises(FileNotFoundError, match="contains no checkpoints"):
        cli(tmp_path, "run", "--niter", "2", "--load_path", str(tmp_path / "empty"))


def test_interval_zero_disables_periodic(tmp_path):
    cli(tmp_path, "run", "--niter", "4", "--vis_interval", "0", "--save_interval", "0",
        "--log_interval", "0")
    run = str(tmp_path / "run")
    assert steps_on_disk(run) == [4]  # the end-of-run save still fires
    assert not os.path.exists(os.path.join(run, "samples"))
    assert not os.path.exists(os.path.join(run, "plots"))


def stub_loop(tmp_path, cfg, step_fn, vis=None):
    run_dir = prepare_run(cfg)
    state = create_glis_state(cfg, device="cpu")
    data = iter(lambda: None, 1)
    return TrainLoop(cfg, run_dir, state, step_fn, data, lambda batch, step: None,
                     vis_fn=vis), run_dir


def test_nan_writes_postmortem_and_raises(tmp_path):
    cfg = tiny_cfg(tmp_path, niter=10, log_interval=2, save_interval=0, vis_interval=0)

    def step_fn(state, real):
        state.step += 1
        loss = float("nan") if state.step == 4 else 1.0 / state.step
        return {"loss_d": torch.tensor(loss), "loss_g": torch.tensor(0.5)}

    loop, run_dir = stub_loop(tmp_path, cfg, step_fn)
    with pytest.raises(FloatingPointError, match="non-finite metrics"):
        loop.run(0)
    assert ckpt.latest_step(run_dir) == 4


@pytest.mark.parametrize("guard", ["nan", "rss"])
def test_guard_save_keeps_the_finite_checkpoints(tmp_path, monkeypatch, guard):
    """Under --keep_checkpoints 1, the post-mortem and the RSS guard's save
    prune nothing: the finite checkpoints before them survive."""
    cfg = tiny_cfg(tmp_path, niter=10, log_interval=1, save_interval=2, vis_interval=0,
                   keep_checkpoints=1, max_host_rss_gb=1.0)

    def step_fn(state, real):
        state.step += 1
        loss = float("nan") if guard == "nan" and state.step == 5 else 1.0
        return {"loss_d": torch.tensor(loss), "loss_g": torch.tensor(0.5)}

    loop, run_dir = stub_loop(tmp_path, cfg, step_fn)
    monkeypatch.setattr(runner, "host_rss_gb",
                        lambda: 2.0 if guard == "rss" and loop.state.step >= 5 else 0.0)
    with pytest.raises((FloatingPointError, SystemExit)):
        loop.run(0)
    assert steps_on_disk(run_dir) == [2, 4, 5]
    finite = ckpt.restore_checkpoint(run_dir, create_glis_state(cfg, device="cpu"), step=4)
    assert finite.step == 4


def test_loop_cadence(tmp_path):
    """vis at multiples of vis_interval, checkpoints at save_interval and
    at the end, metrics read on the host only at log steps."""
    cfg = tiny_cfg(tmp_path, niter=10, log_interval=5, save_interval=4, vis_interval=3)
    reads = []

    class Metric(torch.Tensor):
        def __float__(self):
            reads.append(self.step)
            return super().__float__()

    def step_fn(state, real):
        state.step += 1
        m = torch.tensor(1.0).as_subclass(Metric)
        m.step = state.step
        return {"loss_d": m}

    vis = []
    loop, run_dir = stub_loop(tmp_path, cfg, step_fn, vis=lambda s, step: vis.append(step))
    assert loop.run(0).step == 10
    assert vis == [3, 6, 9]
    assert steps_on_disk(run_dir) == [4, 8, 10]
    assert reads == [1, 5, 10]


def test_rss_guard_trips_after_a_step_and_resumes(tmp_path):
    """A budget below any process: the guard never trips before this
    process's first step, saves that step and exits 19; each relaunch
    makes one step of progress, and without the budget the run ends."""
    args = ["--niter", "4", "--vis_interval", "0", "--save_interval", "0"]
    for step in (1, 2):
        with pytest.raises(SystemExit) as info:
            cli(tmp_path, "run", "--max_host_rss_gb", "1e-9", *args)
        assert info.value.code == EXIT_HOST_RSS
        assert ckpt.latest_step(str(tmp_path / "run")) == step
    state, _ = cli(tmp_path, "run", "--max_host_rss_gb", "-1", *args)
    assert state.step == 4


def test_retention_keep_and_protect(tmp_path):
    cfg = tiny_cfg(tmp_path)
    state = state_at(cfg, 3)
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path / "a"), s, state, keep=2)
    assert steps_on_disk(str(tmp_path / "a")) == [3, 4]
    (tmp_path / "b").mkdir()
    ckpt.record_best_step(str(tmp_path / "b"), 2, 12.34, "fid")
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(str(tmp_path / "b"), s, state, keep=2, protect=2)
    assert steps_on_disk(str(tmp_path / "b")) == [2, 4, 5]
    assert ckpt.best_step(str(tmp_path / "b")) == 2
    assert ckpt.best_record(str(tmp_path / "b"))["label"] == "fid"
    restored = ckpt.restore_checkpoint(str(tmp_path / "b"), state_at(cfg, 0, seed=1), step=-1)
    assert_states_equal(restored, state)
    ckpt.save_checkpoint(str(tmp_path / "b"), 6, state, keep=1, protect=(None, 4))
    assert steps_on_disk(str(tmp_path / "b")) == [4, 6]
    with pytest.raises(FileNotFoundError, match="best.json"):
        ckpt.restore_checkpoint(str(tmp_path / "a"), state, step=-1)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore_checkpoint(str(tmp_path / "none"), state)


def test_async_keep1_retains_last_committed_until_next_save(tmp_path):
    cfg = tiny_cfg(tmp_path)
    run = str(tmp_path)
    for s in (1, 2):
        ckpt.save_checkpoint(run, s, state_at(cfg, s), keep=1, async_save=True)
    assert 1 in steps_on_disk(run)  # 2 may still be in flight
    ckpt.save_checkpoint(run, 3, state_at(cfg, 3), keep=1, async_save=True)
    ckpt.wait_for_checkpoints()
    assert steps_on_disk(run) == [2, 3]
    assert not [d for d in os.listdir(os.path.join(run, "checkpoints")) if not d.isdigit()]
    assert_states_equal(ckpt.restore_checkpoint(run, state_at(cfg, 0, seed=1)), state_at(cfg, 3))


def test_async_save_error_reaches_the_caller(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path)

    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    ckpt.save_checkpoint(str(tmp_path), 1, state_at(cfg, 1), async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_checkpoints()
    ckpt.wait_for_checkpoints()  # reported once


def test_checkpoint_schema_evolution_ema(tmp_path, capsys):
    """A checkpoint without a shadow, restored under --g_ema > 0, starts
    the shadow from the restored G; a shadow restored under --g_ema 0 is
    dropped."""
    plain_cfg, ema_cfg = tiny_cfg(tmp_path), tiny_cfg(tmp_path, g_ema=0.99)
    plain = state_at(plain_cfg, 5)
    ckpt.save_checkpoint(str(tmp_path / "a"), 5, plain)
    r = ckpt.restore_checkpoint(str(tmp_path / "a"), create_glis_state(ema_cfg, device="cpu"))
    assert set(r.g_ema) == {n for n, _ in r.generator.named_parameters()}
    for n, p in plain.generator.named_parameters():
        assert torch.equal(r.g_ema[n], p.detach())
    assert "initializing it from the restored generator" in capsys.readouterr().out

    ema = create_glis_state(ema_cfg, device="cpu")
    for t in ema.g_ema.values():
        t.add_(1.0)
    ckpt.save_checkpoint(str(tmp_path / "b"), 5, ema)
    r = ckpt.restore_checkpoint(str(tmp_path / "b"), create_glis_state(plain_cfg, device="cpu"))
    assert r.g_ema == {}
    assert "discarding the checkpoint's EMA shadow" in capsys.readouterr().out
    r = ckpt.restore_checkpoint(str(tmp_path / "b"), create_glis_state(ema_cfg, device="cpu"))
    for n in ema.g_ema:
        assert torch.equal(r.g_ema[n], ema.g_ema[n])


def test_restore_refuses_another_schedule(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, state_at(tiny_cfg(tmp_path), 1))
    cosine = create_glis_state(tiny_cfg(tmp_path, lr_schedule="cosine", niter=10), device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        ckpt.restore_checkpoint(str(tmp_path), cosine)


REFUSED = [
    ["--model_shards", "2"], ["--tp_min_width", "8"],
    ["--use_pallas"], ["--data_backend", "grain"], ["--lsun_classes", "tower"],
    ["--dataset", "lsun"],
]


def test_every_unported_flag_is_in_the_refusals():
    assert {a[0][2:] for a in REFUSED} - {"dataset"} == set(UNPORTED)


@pytest.mark.parametrize("extra", REFUSED, ids=lambda a: a[0][2:] + "=" + "".join(a[1:]))
def test_unported_flag_raises(tmp_path, extra):
    with pytest.raises(SystemExit, match=extra[0]):
        cli(tmp_path, "run", "--niter", "1", *extra)
    assert not os.path.exists(tmp_path / "run")


@pytest.mark.parametrize("extra,error,match", [
    (["--multihost"], SystemExit, "needs its launcher's environment: torchrun's RANK"),
    (["--num_devices", str((os.cpu_count() or 1) + 1)], ValueError,
     f"requested {(os.cpu_count() or 1) + 1} devices but only {os.cpu_count() or 1} visible"),
], ids=["multihost", "num_devices"])
def test_data_parallel_flags_check_their_world(tmp_path, monkeypatch, extra, error, match):
    """Data parallelism is ported (`tests/test_torch_port_parallel_cli.py`):
    --multihost without a launcher's environment and --num_devices beyond
    the visible count raise before the run directory is made."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "GEA_COORDINATOR",
                "GEA_NUM_PROCESSES", "GEA_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(error, match=match):
        cli(tmp_path, "run", "--niter", "1", *extra)
    assert not os.path.exists(tmp_path / "run")


def test_accepted_values_of_partly_ported_flags(tmp_path):
    state, _ = cli(tmp_path, "run", "--niter", "1", "--num_devices", "1", "--data_backend",
                   "pil", "--norm", "none", "--vis_interval", "0")
    assert state.step == 1


def test_cli_on_the_default_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_glis.main(args + ["--niter", "1", "--save_path", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")


def test_config_round_trip(tmp_path):
    cfg = TrainGLISConfig.from_args(["--augment_flip", "false", "--g_ema", "0.5",
                                     "--remat", "--device", "cpu"])
    assert cfg.augment_flip is False and cfg.remat is True and cfg.g_ema == 0.5
    cfg.save(str(tmp_path / "config.json"))
    assert TrainGLISConfig.load(str(tmp_path / "config.json")) == cfg
    assert cfg.replace(niter=7).niter == 7
    with pytest.raises(SystemExit):
        TrainGLISConfig.from_args(["--norm", "bogus"])
