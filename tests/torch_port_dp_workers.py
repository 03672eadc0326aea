"""Rank bodies for the port's data-parallel tests
(`test_torch_port_parallel.py`, `test_torch_port_parallel_cli.py`), run by
`gea_torch.parallel.spawn` in gloo processes on the CPU. A spawned rank
imports this module by name, so it imports only torch and `gea_torch`."""

from __future__ import annotations

import builtins
import importlib
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from gea_torch.interop import discriminator_from_jax_params, generator_from_jax_params
from gea_torch.parallel import DataParallel
from gea_torch.train import (
    build_glis_train_step,
    build_r_iterative_step,
    build_r_separate_step,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
)
from gea_torch.train import runner


def port_state(trainer: str, cfg, init, dp=None, share_g_forward: bool = True, stats=None):
    """(state, step) of `trainer` on the CPU from `gea`-layout params (and,
    under `norm=batch`, `stats`: the batch_stats trees by player tag)."""
    stats = stats or {}
    if trainer == "glis":
        return (create_glis_state(cfg, *init, device="cpu", g_stats=stats.get("g"),
                                  d_stats=stats.get("d")),
                build_glis_train_step(cfg, share_g_forward, dp=dp))
    if trainer == "r_separate":
        g = generator_from_jax_params(init[0], cfg, device="cpu", batch_stats=stats.get("g"))
        d = discriminator_from_jax_params(init[1], cfg, device="cpu",
                                          batch_stats=stats.get("d"))
        return (create_r_state(cfg, g, d, init[2], device="cpu", r_stats=stats.get("r")),
                build_r_separate_step(cfg, dp))
    return (create_r_iterative_state(cfg, init["g"], init["d"], init["r"], device="cpu",
                                     **{f"{k}_stats": v for k, v in stats.items()}),
            build_r_iterative_step(cfg, dp))


def snapshot(state, metrics) -> dict:
    """Metrics, and each trained module's tensors and Adam's first moments
    by name, copied."""
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for name, tag in state.PLAYERS:
        module, opt = getattr(state, name), getattr(state, f"opt_{tag}")
        out[tag] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        out[f"mu_{tag}"] = {n: opt.state[p]["exp_avg"].clone()
                            for n, p in module.named_parameters()}
    return out


def run_steps(state, step, reals, draws, bias=None, sync=None) -> list:
    """One snapshot after each step, fed `draws` (one noise dict a step)
    and `reals`; with `bias`, D's head bias takes those values after each
    step (`test_torch_port_train.py` says why); with `sync`, the named
    parameters of each trained module (by tag) take the step's values
    (`test_torch_port_batchnorm_steps.py` says why)."""
    modules = {tag: getattr(state, name) for name, tag in state.PLAYERS}
    out = []
    for i, (real, drawn) in enumerate(zip(reals, draws)):
        noise = {k: None if v is None else torch.from_numpy(v) for k, v in drawn.items()}
        out.append(snapshot(state, step(state, real, **noise)))
        with torch.no_grad():
            if bias is not None:
                state.discriminator.head.bias.copy_(torch.from_numpy(bias[i]))
            for tag, values in (sync[i] if sync else {}).items():
                params = dict(modules[tag].named_parameters())
                for k, v in values.items():
                    params[k].copy_(torch.from_numpy(v))
    return out


def rank_max_spread(state) -> float:
    """The largest difference between the ranks' trained parameters and
    buffers (batch norm's running statistics among them)."""
    flat = torch.cat([t.detach().reshape(-1).float() for name, _ in state.PLAYERS
                      for t in [*getattr(state, name).parameters(),
                                *getattr(state, name).buffers()]])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    return max((t - every[0]).abs().max().item() for t in every)


def parity(device, cases: dict) -> dict:
    """Each case's steps on this rank: its rows of the real batches and its
    own draws (`draws[step][rank]`); per case, the snapshots and the spread
    between the ranks' parameters after the last step."""
    dp = DataParallel(device)
    out = {}
    for name, case in cases.items():
        state, step = port_state(case["trainer"], case["cfg"], case["init"], dp,
                                 stats=case.get("stats"))
        reals = [None if r is None else dp.rows(torch.from_numpy(r)) for r in case["reals"]]
        draws = [per_rank[dp.rank] for per_rank in case["draws"]]
        snaps = run_steps(state, step, reals, draws, case.get("bias"), case.get("sync"))
        out[name] = {"steps": snaps, "spread": rank_max_spread(state)}
    return out


def _guarded(run_dir: str):
    """Make every write, rename or removal under `run_dir` raise."""
    root = os.path.abspath(run_dir)

    def inside(path) -> bool:
        return isinstance(path, (str, os.PathLike)) and os.path.abspath(path).startswith(root)

    def refuse(what, path):
        raise AssertionError(f"rank {dist.get_rank()} {what} {path}")

    real_open, real_replace, real_rmtree = builtins.open, os.replace, shutil.rmtree

    def open_(file, mode="r", *args, **kw):
        if inside(file) and any(c in mode for c in "wax+"):
            refuse("wrote", file)
        return real_open(file, mode, *args, **kw)

    def replace(src, dst, *args, **kw):
        if inside(dst):
            refuse("renamed into", dst)
        return real_replace(src, dst, *args, **kw)

    def rmtree(path, *args, **kw):
        if inside(path):
            refuse("removed", path)
        return real_rmtree(path, *args, **kw)

    builtins.open, os.replace, os.rename, shutil.rmtree = open_, replace, replace, rmtree


def resume(device, module: str, config_cls: str, runs: list) -> list:
    """`module.train` on this rank for each argv of `runs` in turn, in one
    group; a rank other than the lead refuses to write anything under the
    run directories. The lead's stats, one per run."""
    cli = importlib.import_module(f"gea_torch.cli.{module}")
    cls = getattr(importlib.import_module("gea_torch.config"), config_cls)
    dp = DataParallel(device)
    if not dp.lead:
        for argv in runs:
            _guarded(cls.from_args(argv).save_path)
    return [cli.train(device, cls.from_args(argv), dp)[1] for argv in runs]


def rss_trip(device, module: str, config_cls: str, argv: list, marks: str) -> None:
    """One run in which rank 1's host RSS reads as 1e9 GB: every rank must
    leave with SystemExit; each writes its exit code into `marks` first."""
    cli = importlib.import_module(f"gea_torch.cli.{module}")
    cls = getattr(importlib.import_module("gea_torch.config"), config_cls)
    dp = DataParallel(device)
    if dp.rank == 1:
        runner.host_rss_gb = lambda: 1e9
    try:
        cli.train(device, cls.from_args(argv), dp)
    except SystemExit as e:
        with open(os.path.join(marks, f"rank{dp.rank}"), "w") as f:
            f.write(str(e.code))
        raise
    np.save(os.path.join(marks, f"rank{dp.rank}_finished.npy"), np.zeros(1))


def nan_on_rank1(device, argv: list) -> None:
    """A `--debug_checks` run in which rank 1's real batch of iter 2 holds a
    NaN: the checks raise on a rank, and `spawn` takes the others down."""
    from gea_torch.cli import train_glis

    dp = DataParallel(device)
    make = train_glis.make_input_fn

    def poisoned(*args):
        fn = make(*args)

        def real(batch, step):
            out = fn(batch, step)
            if step == 1:
                out = out.clone()
                out[0, 0, 0, 0] = float("nan")
            return out

        return real

    if dp.rank == 1:
        train_glis.make_input_fn = poisoned
    train_glis.train(device, train_glis.TrainGLISConfig.from_args(argv), dp)
