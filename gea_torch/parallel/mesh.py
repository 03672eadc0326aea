"""The data-parallel world of a run (port of `gea/parallel/mesh.py`'s
`make_mesh` and of the multihost start of `gea/train/runner.py::
prepare_run`).

`gea` lays one `data` axis over the devices of one process (or, after
`jax.distributed.initialize()`, of every host) and `shard_map`s the step
over it. The port runs one process per card instead, in a
`torch.distributed` process group: NCCL between cards, gloo on the CPU.
Each rank takes `batch_size / N` of the global batch (`gea_torch.parallel.
dp`).

* `--num_devices N` on one host: `resolve_num_devices` turns 0 into every
  visible card (one process on the CPU), and a request beyond the visible
  count raises with `gea`'s message; `spawn` then starts one worker a rank
  on a free localhost port.
* `--multihost`: the launcher has started one process a card and says
  where the group meets (`launcher_env`): torchrun's RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR and MASTER_PORT, or `gea`'s GEA_COORDINATOR,
  GEA_NUM_PROCESSES and GEA_PROCESS_ID.

`join` starts the process group once a process (a second trainer in the
same process joins the group the first one started, as `gea` initialises
`jax.distributed` once). There is no fallback: a failed NCCL start raises,
and no path runs on fewer ranks or on the CPU instead.

`--model_shards M` makes the world 2-D, as `gea`'s `make_mesh(n,
model_shards=M)` reshapes its devices to (-1, M): rank r sits at (data
r // M, model r % M) (`mesh_coords`), and each data row of M ranks has a
process group of its own (`model_groups`) for the all-gathers of
`gea_torch.parallel.tp`; its sums run over the whole world. `tp_world`
checks the flags with `gea`'s messages.
"""

from __future__ import annotations

import os
import pickle
import socket
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
GEA_ENV = ("GEA_COORDINATOR", "GEA_NUM_PROCESSES", "GEA_PROCESS_ID")


def visible_devices(device: torch.device) -> int:
    """The ranks one host can hold: its cards, or its CPU cores."""
    return torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)


def resolve_num_devices(num_devices: int, device: torch.device) -> int:
    """--num_devices -> this host's world size: 0 means every visible card
    (`gea`'s `make_mesh(0)`), and one process on the CPU."""
    if num_devices <= 0:
        return visible_devices(device) if device.type == "cuda" else 1
    visible = visible_devices(device)
    if num_devices > visible:
        raise ValueError(f"requested {num_devices} devices but only {visible} visible")
    return num_devices


def tp_world(model_shards: int, num_devices: int, multihost: bool) -> None:
    """`gea`'s checks of `--model_shards M` over `num_devices` ranks
    (`gea/train/runner.py::resolve_mesh`, `gea/parallel/mesh.py::make_mesh`)."""
    if model_shards <= 1:
        return
    if multihost:
        raise SystemExit("--model_shards is single-host only (DP covers pods)")
    if num_devices <= 1:
        raise SystemExit(f"--model_shards {model_shards} needs multiple devices "
                         f"({num_devices} visible)")
    if num_devices % model_shards:
        raise ValueError(f"model_shards {model_shards} must divide the device count "
                         f"{num_devices}")


def mesh_coords(rank: int, model_shards: int) -> tuple:
    """(data, model) coordinates of `rank` in the (-1, M) world."""
    return divmod(rank, model_shards)


def model_groups(size: int, model_shards: int) -> list:
    """One process group per data row: ranks d*M .. d*M + M - 1. Every
    rank makes every group, in the same order, as `new_group` requires."""
    return [dist.new_group(list(range(d, d + model_shards)))
            for d in range(0, size, model_shards)]


@dataclass(frozen=True)
class Launch:
    """Where this process sits in the group and where the group meets."""

    rank: int
    size: int
    local_rank: int
    init_method: str


def launcher_env(env=os.environ) -> Launch:
    """The group of a `--multihost` process, from its launcher's
    environment. Without GEA_LOCAL_RANK or LOCAL_RANK, `gea`'s variables
    put rank r on card r modulo the host's cards."""
    if all(k in env for k in TORCHRUN_ENV):
        rank = int(env["RANK"])
        return Launch(rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)), "env://")
    if all(k in env for k in GEA_ENV):
        rank = int(env["GEA_PROCESS_ID"])
        local = env.get("GEA_LOCAL_RANK", env.get("LOCAL_RANK"))
        if local is None:
            local = rank % max(1, torch.cuda.device_count())
        return Launch(rank, int(env["GEA_NUM_PROCESSES"]), int(local),
                      f"tcp://{env['GEA_COORDINATOR']}")
    raise SystemExit("--multihost needs its launcher's environment: torchrun's "
                     f"{', '.join(TORCHRUN_ENV)} (and LOCAL_RANK), or {', '.join(GEA_ENV)}")


def join(device: torch.device, launch: Launch) -> torch.device:
    """Start the process group (NCCL on the card, gloo on the CPU), or join
    the one this process started already; returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", launch.local_rank)
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (
                launch.size, launch.rank, backend):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of {dist.get_world_size()} "
                f"({dist.get_backend()}) already; asked for rank {launch.rank} of "
                f"{launch.size} ({backend})")
        return device
    dist.init_process_group(backend, init_method=launch.init_method,
                            world_size=launch.size, rank=launch.rank,
                            device_id=device if device.type == "cuda" else None)
    return device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, size: int, port: int, device: str, fn: Callable, args: tuple,
               results) -> None:
    """One spawned rank: join the group, run fn(device, *args), pass rank
    0's result back (pickled by value: a tensor shared through the queue
    would die with this process), leave the group."""
    dev = join(torch.device(device), Launch(rank, size, rank, f"tcp://127.0.0.1:{port}"))
    try:
        out = fn(dev, *args)
        if rank == 0:
            results.put(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, size: int, device: torch.device, args: tuple = (),
          timeout: Optional[float] = None):
    """Run fn(rank's device, *args) on `size` ranks of one host, one
    spawned process each, and return rank 0's result. When one rank fails,
    the others are taken down and its error is raised here; a rank that
    exits with a code (the RSS guard's 19) makes this process exit with it.
    `timeout` seconds without an end take every rank down and raise
    TimeoutError."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_main, nprocs=size, join=False, start_method="spawn",
                             args=(size, free_port(), device.type, fn, args, results))
    deadline = None if timeout is None else time.monotonic() + timeout
    got = None
    try:
        while not ctx.join(timeout=0.5):
            if got is None and not results.empty():  # rank 0 blocks until read
                got = results.get()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{size} ranks did not end within {timeout} s")
    except mp.ProcessExitedException as e:
        if e.exit_code > 0:
            raise SystemExit(e.exit_code) from e
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    return pickle.loads(results.get() if got is None else got)
