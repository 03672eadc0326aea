"""Checkpoint and resume (port of `gea/utils/checkpoint.py`) with
`torch.save`. The run directory keeps `gea`'s layout, which other tools
read (a frozen G for R-separate, the samplers):

    <save_path>/
      config.json                   # the run's full flag set
      checkpoints/<step>/state.pt   # the whole train state
      samples/                      # per-stage sample grids (PNG)
      plots/loss.png                # loss curves
      best.json                     # best-snapshot pointer, when tracked

`state.pt` holds, for each trained module of the state (its `PLAYERS`:
G and D for G-LIS, R for R-separate, G, D and R for R-iterative), its
`state_dict` under its name ("generator", "discriminator", "reverter"), its
Adam's under "opt_<tag>" (in one form, whether the Adam is capturable or
not: `optimizer_state`) and its scheduler's under "sched_<tag>" (None
without a schedule; `scheduler_state`); then the step, the state of the train state's
`torch.Generator`, and for G-LIS the EMA shadow ({} without `--g_ema`). An
R-separate checkpoint holds R only: its frozen G stays in `--g_path`.

A save copies every tensor to the host on the caller's thread; with
`async_save` the file is written on a background thread, at most one save
in flight, and `wait_for_checkpoints` blocks on it (and re-raises its
error). Each save writes into a temporary directory that is renamed into
place, so `latest_step` never sees a half-written step.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterable, Optional, Union

import torch

from gea_torch.train.state import scheduled_lrs

STATE_FILE = "state.pt"
_MODULES = ("generator", "discriminator", "reverter")

_lock = threading.Lock()
_writer: Optional[ThreadPoolExecutor] = None
_pending: Optional[Future] = None


def _ckpt_root(run_dir: str) -> str:
    return os.path.join(os.path.abspath(run_dir), "checkpoints")


def _to_host(obj: Any) -> Any:
    """A copy of a nest of dicts, lists and tuples with every tensor copied
    to the CPU, so the train loop may go on updating the originals."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def optimizer_state(opt: torch.optim.Adam, sched=None) -> dict:
    """`opt.state_dict()` in the one form every checkpoint holds, whichever
    Adam wrote it: `capturable` False (the step counts are copied to the
    host with the rest) and lr a float, the scheduler's own where a
    chunked state's Adam holds it in a tensor (`make_optimizer`)."""
    sd = opt.state_dict()
    lrs = [g["lr"] for g in sd["param_groups"]]
    if sched is not None and any(torch.is_tensor(lr) for lr in lrs):
        lrs = [per_group[0] for per_group in scheduled_lrs(sched, 1)]
    sd["param_groups"] = [{**g, "lr": lr, "capturable": False}
                          for g, lr in zip(sd["param_groups"], lrs)]
    return sd


def scheduler_state(sched) -> dict:
    """`sched.state_dict()` in one form too: its last lr as the floats it
    computed (a tensor lr makes LambdaLR keep the tensors themselves)."""
    return {**sched.state_dict(), "_last_lr": [v[0] for v in scheduled_lrs(sched, 1)]}


def load_optimizer_state(opt: torch.optim.Adam, sd: dict) -> None:
    """Load a checkpoint's `optimizer_state` into `opt`, which keeps its
    own form: an lr tensor is kept (refilled in place, so a graph that
    reads it sees the restored lr); a capturable Adam gets its step counts
    on the device, a plain one keeps them on the host."""
    kept = [(g["lr"], g["capturable"]) for g in opt.param_groups]
    opt.load_state_dict(sd)
    for group, (lr, capturable) in zip(opt.param_groups, kept):
        group["capturable"] = capturable
        if torch.is_tensor(lr):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        else:
            group["lr"] = float(group["lr"])
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(torch.float32).to(
                    p.device if capturable else "cpu")


def state_dict(state) -> dict:
    """The whole train state (G-LIS, R-separate or R-iterative) as a nest
    of host tensors and numbers."""
    out = {"step": int(state.step)}
    for name, tag in state.PLAYERS:
        sched = getattr(state, f"sched_{tag}")
        out[name] = getattr(state, name).state_dict()
        out[f"opt_{tag}"] = optimizer_state(getattr(state, f"opt_{tag}"), sched)
        out[f"sched_{tag}"] = None if sched is None else scheduler_state(sched)
    out["rng"] = state.rng.get_state()
    if hasattr(state, "g_ema"):
        out["g_ema"] = dict(state.g_ema)
    return _to_host(out)


def load_state_dict(state, ckpt: dict):
    """Load a `state_dict` into `state` in place and return it. A shadow
    missing from the checkpoint under `--g_ema > 0` starts from the restored
    G; a shadow in it under `--g_ema 0` is dropped."""
    players = [name for name, _ in state.PLAYERS]
    if any(name not in ckpt for name in players):
        raise ValueError(f"the checkpoint holds {sorted(k for k in ckpt if k in _MODULES)}, "
                         f"this run trains {players}: a checkpoint of another trainer")
    for _, tag in state.PLAYERS:
        if (getattr(state, f"sched_{tag}") is None) != (ckpt.get(f"sched_{tag}") is None):
            raise ValueError(f"sched_{tag}: the checkpoint was written with another "
                             "--lr_schedule than this run's")
    for name, tag in state.PLAYERS:
        getattr(state, name).load_state_dict(ckpt[name], strict=True)
        load_optimizer_state(getattr(state, f"opt_{tag}"), ckpt[f"opt_{tag}"])
        sched = getattr(state, f"sched_{tag}")
        if sched is not None:
            sched.load_state_dict(ckpt[f"sched_{tag}"])
    state.rng.set_state(ckpt["rng"])
    state.step = int(ckpt["step"])
    if not hasattr(state, "g_ema"):
        return state
    disk_ema = ckpt.get("g_ema") or {}
    if state.g_ema and not disk_ema:
        print("[gea_torch] checkpoint has no EMA shadow; initializing it from the "
              "restored generator params")
        state.g_ema = {n: p.detach().clone() for n, p in state.generator.named_parameters()}
    elif not state.g_ema and disk_ema:
        print("[gea_torch] discarding the checkpoint's EMA shadow (--g_ema 0)")
    elif state.g_ema:
        state.g_ema = {n: disk_ema[n].to(p.device) for n, p in
                       state.generator.named_parameters()}
    return state


def wait_for_checkpoints() -> None:
    """Block until the save in flight, if any, has been written; raise its
    error if it failed."""
    global _pending
    with _lock:
        pending, _pending = _pending, None
    if pending is not None:
        pending.result()


def _write(root: str, step: int, host: dict) -> None:
    tmp = os.path.join(root, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), "wb") as f:
        torch.save(host, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(root, str(step))
    shutil.rmtree(final, ignore_errors=True)  # an earlier save of this step
    os.replace(tmp, final)


def write_modules(run_dir: str, step: int, modules: dict) -> None:
    """Write a checkpoint of `step` that holds just module state_dicts
    ({"generator": ..., ...}; what `gea_torch.cli.convert_checkpoint
    --from_torch` imports), which the samplers and evaluators read but no
    trainer resumes from."""
    root = _ckpt_root(run_dir)
    os.makedirs(root, exist_ok=True)
    _write(root, step, _to_host({"step": int(step), **modules}))


def _steps_on_disk(root: str) -> list:
    return sorted(int(d) for d in os.listdir(root) if re.fullmatch(r"\d+", d))


def save_checkpoint(
    run_dir: str,
    step: int,
    state,
    keep: int = 0,
    async_save: bool = False,
    protect: Union[int, Iterable[int], None] = None,
) -> None:
    """Write the checkpoint of `step`, after the save in flight; with
    keep > 0, prune all but the newest `keep` steps, never a step in
    `protect` (one int or an iterable; None entries are ignored). With
    `async_save` the file is written on a background thread."""
    global _writer, _pending
    root = _ckpt_root(run_dir)
    os.makedirs(root, exist_ok=True)
    host = state_dict(state)
    wait_for_checkpoints()  # at most one save in flight
    on_disk = _steps_on_disk(root)  # every step here is committed
    if async_save:
        with _lock:
            if _writer is None:
                _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gea_torch-ckpt")
            _pending = _writer.submit(_write, root, step, host)
    else:
        _write(root, step, host)
        on_disk = _steps_on_disk(root)
    if keep <= 0:
        return
    kept = set(sorted(set(on_disk) | {step})[-keep:])
    if async_save and on_disk:
        # `step` may still be on its way to disk: keep the newest committed
        # step too, or a crash now could leave no restorable checkpoint.
        # The next save prunes it.
        kept.add(max(on_disk))
    if protect is not None:
        kept.update((protect,) if isinstance(protect, int) else
                    (p for p in protect if p is not None))
    for old in on_disk:
        if old != step and old not in kept:
            shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)


def record_best_step(run_dir: str, step: int, metric: float, label: str) -> None:
    """Persist the best-so-far snapshot pointer (<run_dir>/best.json)
    atomically, for `--step -1` selection."""
    path = os.path.join(os.path.abspath(run_dir), "best.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "metric": round(metric, 4), "label": label}, f)
    os.replace(tmp, path)


def best_record(run_dir: str) -> Optional[dict]:
    """The best-snapshot record ({"step", "metric", "label"}), or None."""
    path = os.path.join(os.path.abspath(run_dir), "best.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def best_step(run_dir: str) -> Optional[int]:
    rec = best_record(run_dir)
    return None if rec is None else int(rec["step"])


def latest_step(run_dir: str) -> Optional[int]:
    root = _ckpt_root(run_dir)
    if not os.path.isdir(root):
        return None
    steps = _steps_on_disk(root)
    return steps[-1] if steps else None


def _load(root: str, step: int) -> dict:
    return torch.load(os.path.join(root, str(step), STATE_FILE), map_location="cpu",
                      weights_only=True)


def load_checkpoint(run_dir: str, step: Optional[int] = None) -> dict:
    """The `state_dict` of a checkpoint on the host: the latest step when
    none is given, `step`, or with -1 the step that best.json points at."""
    wait_for_checkpoints()  # the save in flight may be the latest
    if step == -1:
        step = best_step(run_dir)
        if step is None:
            raise FileNotFoundError(f"step -1: no best.json under {run_dir!r}")
    auto_pick = step is None
    if auto_pick:
        step = latest_step(run_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {run_dir!r}")
    root = _ckpt_root(run_dir)
    try:
        ckpt = _load(root, step)
    except FileNotFoundError:
        # Another writer's retention may have pruned it since latest_step.
        retry = latest_step(run_dir) if auto_pick else None
        if retry is None or retry == step:
            raise
        ckpt = _load(root, retry)
    return ckpt


def restore_checkpoint(run_dir: str, target, step: Optional[int] = None):
    """Load a checkpoint into `target` (a train state of any of the three
    trainers) and return it: the latest step when none is given, `step`, or
    with -1 the step that best.json points at."""
    return load_state_dict(target, load_checkpoint(run_dir, step))
