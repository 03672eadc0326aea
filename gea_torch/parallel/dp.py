"""Data parallelism of the train steps (port of `gea/parallel/dp.py`).

`gea` builds its steps with `axis_name="data"` and `shard_map`s them over
the mesh: inside, `lax.pmean` averages each player's gradients, the metrics
and the extras at fixed points of the step. PyTorch has no `shard_map`;
here every rank runs the same step on its own slab of the global batch, and
`DataParallel`, which the step builders take as `dp`, averages at the
points where `gea` `pmean`s:

* one all-reduce a player a step, over one persistent flat fp32 buffer per
  player that the player's `.grad`s are views of (`zero_grads`,
  `mean_grads`): nothing is copied, and the buffer keeps one address for a
  CUDA graph that captures the all-reduce;
* one all-reduce of the step's stacked metrics (`mean_metrics`);
* under `norm=batch`, one all-reduce a player after the step of its
  running statistics (`mean_stats`), which are views of one flat fp32
  buffer too (`stats_buffer`); each rank normalises with its own batch
  statistics, as each of `gea`'s devices does.

Each is a SUM divided by the world size, as `pmean` is, so that gloo (the
CPU) and NCCL (the card) do the same arithmetic. `DistributedDataParallel`
is not used: the G-LIS step runs D three ways in one iteration (D's own
backward, G's loss pulled through D on a detached leaf, and a double
backward under WGAN-GP), which its one-forward-one-backward reducer does
not model.

Noise: every rank draws the global batch's z, spatial noise and penalty
eps from the train state's generator, which every rank holds alike, and
keeps its own rows (`rows`). The ranks' draws then differ, as `gea`'s
per-device fold does, a resume restores every rank's draws from the lead's
checkpoint, and one rank draws what the single-process step draws.

`replicate` (`gea`'s `replicate_state`) broadcasts the lead's state to
every rank at the start and after a resume; `shard_batch` and `local_copy`
have no counterpart (each rank reads its own slab; each holds its replica).
`any` and `broadcast_flag` carry the loop's collective decisions (the RSS
guard, early stopping) over a gloo group on the host, so that they never
wait for the card.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist

from gea_torch.ops.layers import batch_norms

Metrics = Dict[str, torch.Tensor]


class DataParallel:
    """This process's rank in the started process group (`mesh.join`),
    with the flat gradient buffers of the modules it trains."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        # Host-side decisions: on the card, a gloo group beside NCCL.
        self.host_group = dist.new_group(backend="gloo") if device.type == "cuda" else None
        # module -> (flat buffer, [(parameter, its view)]); a state that
        # is dropped takes its buffers with it.
        self._grads = weakref.WeakKeyDictionary()
        # module -> (flat buffer or None, [(batch norm, buffer name, view)]).
        self._stats = weakref.WeakKeyDictionary()

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor."""
        n = t.shape[0] // self.size
        return t[self.rank * n:(self.rank + 1) * n]

    def zero_grads(self, module: torch.nn.Module) -> None:
        """Zero the module's flat gradient buffer (made on the first call),
        whose views are its parameters' `.grad`s."""
        if module not in self._grads:
            params = [p for p in module.parameters() if p.requires_grad]
            flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32,
                               device=self.device)
            views, at = [], 0
            for p in params:
                views.append((p, flat[at:at + p.numel()].view_as(p)))
                at += p.numel()
            self._grads[module] = (flat, views)
        flat, views = self._grads[module]
        flat.zero_()
        for p, v in views:
            if p.grad is not v:
                p.grad = v

    def mean_grads(self, module: torch.nn.Module, accum: int = 1) -> None:
        """The module's gradients, summed over `accum` microbatches, to
        their mean over the microbatches and then over the ranks."""
        flat, views = self._grads[module]
        if any(p.grad is not v for p, v in views):
            raise RuntimeError("a backward replaced a gradient buffer view; the all-reduce "
                               "would miss it")
        if accum > 1:
            flat.div_(accum)
        dist.all_reduce(flat)
        if self.size > 1:
            flat.div_(self.size)

    def stats_buffer(self, module: torch.nn.Module) -> Optional[torch.Tensor]:
        """The flat fp32 buffer whose views are the module's batch-norm
        running statistics (made on the first call, with their values; the
        buffers are re-registered as the views), or None without batch
        norm. Made before a CUDA graph's capture (`replicate` makes it),
        it keeps one address for the graph."""
        if module not in self._stats:
            owners = [(b, n) for b in batch_norms(module) for n in ("mean", "var")]
            flat = None
            views = []
            if owners:
                flat = torch.cat([getattr(b, n).detach().float().reshape(-1)
                                  for b, n in owners])
                at = 0
                for b, n in owners:
                    t = getattr(b, n)
                    view = flat[at:at + t.numel()].view_as(t)
                    b.register_buffer(n, view)
                    views.append((b, n, view))
                    at += t.numel()
            self._stats[module] = (flat, views)
        flat, views = self._stats[module]
        if any(b._buffers[n] is not v for b, n, v in views):
            raise RuntimeError("a running statistic is no longer a view of its flat buffer; "
                               "the all-reduce would miss it")
        return flat

    def mean_stats(self, module: torch.nn.Module) -> None:
        """The module's running statistics averaged over the ranks, in one
        all-reduce (none without batch norm)."""
        flat = self.stats_buffer(module)
        if flat is None:
            return
        dist.all_reduce(flat)
        if self.size > 1:
            flat.div_(self.size)

    def mean_metrics(self, metrics: Metrics) -> Metrics:
        """The step's 0-d metrics averaged over the ranks, in one
        all-reduce."""
        stacked = torch.stack([v.float() for v in metrics.values()])
        dist.all_reduce(stacked)
        if self.size > 1:
            stacked = stacked / self.size
        return dict(zip(metrics, stacked.unbind()))

    def replicate(self, state) -> None:
        """Broadcast the lead's train state to every rank, in place: the
        trained modules' parameters and buffers, their Adam's state, the
        EMA shadow, the generator's state and the step. Each trained
        module's running statistics become views of its flat buffer first
        (`stats_buffer`), before any capture."""
        for name, tag in state.PLAYERS:
            module = getattr(state, name)
            self.stats_buffer(module)
            for t in [*module.parameters(), *module.buffers()]:
                self._broadcast(t.data)
            opt = getattr(state, f"opt_{tag}")
            for group in opt.param_groups:
                for p in group["params"]:
                    for key in sorted(opt.state.get(p, {})):
                        if torch.is_tensor(opt.state[p][key]):
                            self._broadcast(opt.state[p][key])
        for t in getattr(state, "g_ema", {}).values():
            self._broadcast(t)
        rng = state.rng.get_state()
        self._broadcast(rng)
        state.rng.set_state(rng)
        step = torch.tensor([state.step], dtype=torch.int64)
        self._broadcast(step)
        state.step = int(step)

    def _broadcast(self, t: torch.Tensor) -> None:
        """Broadcast from rank 0 in place; a host tensor crosses NCCL
        through a copy on the card."""
        if self.device.type == "cuda" and t.device.type != "cuda":
            on_card = t.to(self.device)
            dist.broadcast(on_card, src=0)
            t.copy_(on_card.cpu())
        else:
            dist.broadcast(t, src=0)

    def any(self, flag: bool) -> bool:
        """True on every rank when it is true on one."""
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def broadcast_flag(self, flag: bool) -> bool:
        """The lead's flag, on every rank."""
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=self.host_group)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)
