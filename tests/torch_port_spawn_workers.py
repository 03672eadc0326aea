"""Rank bodies for `test_torch_port_spawn.py`, run by
`gea_torch.parallel.spawn` in gloo processes on the CPU. A spawned rank
imports this module by name, so it imports only torch."""

from __future__ import annotations

import torch
import torch.distributed as dist


def rank_sum(device, tag: int) -> tuple:
    """(tag, world size, the sum over ranks of rank + 1): what rank 0
    passes back after one all-reduce of the group."""
    x = torch.tensor([float(dist.get_rank() + 1)], device=device)
    dist.all_reduce(x)
    return tag, dist.get_world_size(), x.item()
