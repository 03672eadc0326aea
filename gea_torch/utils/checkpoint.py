"""Checkpoint and resume (port of `gea/utils/checkpoint.py`) with
`torch.save`. The run directory keeps `gea`'s layout, which other tools
read (a frozen G for R-separate, the samplers):

    <save_path>/
      config.json                   # the run's full flag set
      checkpoints/<step>/state.pt   # the whole train state
      samples/                      # per-stage sample grids (PNG)
      plots/loss.png                # loss curves
      best.json                     # best-snapshot pointer, when tracked

`state.pt` holds G's and D's `state_dict`s, both Adams' `state_dict`s, both
schedulers' (None without a schedule), the step, the state of the train
state's `torch.Generator`, and the EMA shadow ({} without `--g_ema`).

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

STATE_FILE = "state.pt"

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


def state_dict(state) -> dict:
    """The whole `GLISTrainState` as a nest of host tensors and numbers."""
    return _to_host({
        "step": int(state.step),
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "opt_g": state.opt_g.state_dict(),
        "opt_d": state.opt_d.state_dict(),
        "sched_g": None if state.sched_g is None else state.sched_g.state_dict(),
        "sched_d": None if state.sched_d is None else state.sched_d.state_dict(),
        "rng": state.rng.get_state(),
        "g_ema": dict(state.g_ema),
    })


def load_state_dict(state, ckpt: dict):
    """Load a `state_dict` into `state` in place and return it. A shadow
    missing from the checkpoint under `--g_ema > 0` starts from the restored
    G; a shadow in it under `--g_ema 0` is dropped."""
    for sched, key in ((state.sched_g, "sched_g"), (state.sched_d, "sched_d")):
        if (sched is None) != (ckpt.get(key) is None):
            raise ValueError(f"{key}: the checkpoint was written with another "
                             "--lr_schedule than this run's")
    state.generator.load_state_dict(ckpt["generator"], strict=True)
    state.discriminator.load_state_dict(ckpt["discriminator"], strict=True)
    state.opt_g.load_state_dict(ckpt["opt_g"])
    state.opt_d.load_state_dict(ckpt["opt_d"])
    if state.sched_g is not None:
        state.sched_g.load_state_dict(ckpt["sched_g"])
        state.sched_d.load_state_dict(ckpt["sched_d"])
    state.rng.set_state(ckpt["rng"])
    state.step = int(ckpt["step"])
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


def restore_checkpoint(run_dir: str, target, step: Optional[int] = None):
    """Load a checkpoint into `target` (a `GLISTrainState`) and return it:
    the latest step when none is given, `step`, or with -1 the step that
    best.json points at."""
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
    return load_state_dict(target, ckpt)
