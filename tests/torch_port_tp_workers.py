"""Rank bodies for the port's tensor-parallel tests (`test_torch_port_tp*.py`),
run by `gea_torch.parallel.spawn` in gloo processes on the CPU. A spawned
rank imports this module by name, so it imports only torch, `gea_torch`
and the DP tests' worker module."""

from __future__ import annotations

import numpy as np
import torch
from torch_port_dp_workers import port_state, rank_max_spread

from gea_torch.parallel.tp import TensorParallel, resident_bytes


def full_snapshot(tp: TensorParallel, state, metrics) -> dict:
    """Metrics, each trained module's full tensors and its Adam's full
    first moments by name (`full_view`, a collective every rank joins)."""
    view = tp.full_view(state)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for name, tag in state.PLAYERS:
        module = getattr(state, name)
        moments = getattr(view, f"opt_{tag}").state_dict()["state"]
        out[tag] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        out[f"mu_{tag}"] = {n: moments[i]["exp_avg"].clone()
                            for i, (n, _) in enumerate(module.named_parameters())}
    return out


def sync_params(tp: TensorParallel, state, values: dict) -> None:
    """Each trained module's named parameters (by tag) take `values` (this
    rank's shards are views of them)."""
    for name, tag in state.PLAYERS:
        module = getattr(state, name)
        params = dict(module.named_parameters())
        with torch.no_grad():
            for k, v in values.get(tag, {}).items():
                params[k].copy_(torch.from_numpy(v))


def parity(device, cases: dict, model_shards: int, min_width: int) -> dict:
    """Each case's steps on this rank of a (data, model) world: its rows of
    the global real batches and draws (`TensorParallel.rows`); per case,
    the full snapshots after each step, the spread between the ranks'
    parameters and statistics, and this rank's resident state bytes
    beside a single process's after the same first step."""
    out = {}
    for name, case in cases.items():
        cfg = case["cfg"]
        tp = TensorParallel(device, model_shards, cfg.batch_size, max(1, cfg.grad_accum),
                            min_width)
        whole = single_resident(case)
        state, step = port_state(case["trainer"], cfg, case["init"], tp, stats=case.get("stats"))
        tp.replicate(state)
        snaps = []
        for i, (real, drawn) in enumerate(zip(case["reals"], case["draws"])):
            real = None if real is None else tp.rows(torch.from_numpy(real))
            noise = {k: None if v is None else tp.rows(torch.from_numpy(v))
                     for k, v in drawn.items()}
            snaps.append(full_snapshot(tp, state, step(state, real, **noise)))
            if case.get("sync"):
                sync_params(tp, state, case["sync"][i])
        out[name] = {"steps": snaps, "spread": rank_max_spread(state),
                     "resident": resident_bytes(state), "whole": whole}
    return out


def single_resident(case: dict) -> dict:
    """`resident_bytes` of a single process's state after the case's first
    step."""
    state, step = port_state(case["trainer"], case["cfg"], case["init"],
                             stats=case.get("stats"))
    real, drawn = case["reals"][0], case["draws"][0]
    step(state, None if real is None else torch.from_numpy(real),
         **{k: None if v is None else torch.from_numpy(v) for k, v in drawn.items()})
    return resident_bytes(state)


def draws_of_ranks(device, batch: int, accum: int, model_shards: int) -> list:
    """Every rank's rows of an arange batch, gathered on rank 0."""
    tp = TensorParallel(device, model_shards, batch, accum)
    mine = tp.rows(torch.arange(batch, dtype=torch.float32))
    every = [torch.empty_like(mine) for _ in range(tp.size)]
    torch.distributed.all_gather(every, mine)
    return [np.asarray(t, np.int64).tolist() for t in every]
