"""Tensor parallelism of the train steps, `--model_shards M` (port of
`gea/parallel/tp.py`).

`gea` keeps the single-program step (built with `axis_name=None`) and lets
GSPMD partition it over a ('data', 'model') mesh: every state leaf whose
last axis (the output-channel axis in `gea`'s layout) is at least
`tp_min_width` wide and divides by M shards over 'model', parameters, EMA
shadow and Adam's moments alike, and XLA places the collectives. PyTorch
has no GSPMD; the port writes the collectives itself and shards the
optimizer's state and the EMA over the 'model' axis:

* each rank keeps the module's full parameters, which the forward and
  backward use at their full shapes (the port's kernels run on them, and a
  CUDA graph keeps one address per parameter), and DP's full gradient
  buffer (`DataParallel.zero_grads`);
* what shards is the optimizer's state and the EMA shadow (`_Plan`): the
  rank's shard of a sharded parameter is a view of its piece of the full
  parameter, its Adam updates those views and stores its moments for them
  alone, and its EMA shadow holds those pieces alone; narrow leaves stay
  replicated. A rank thus holds the full parameters and gradients plus
  1/M of Adam's moments and of the EMA (`resident_bytes`);
* the gradients are all-reduced over every rank and divided by the world
  size, and each shard's gradient is a view of its piece; after every
  update one all-gather over the rank's model row, through buffers made for
  the call, refills the other ranks' pieces of the full parameters.

GSPMD cannot partition the Pallas kernels either, and runs them on
gathered operands around their custom calls. Splitting the convolutions'
compute over output channels is not done here.

Semantics are `gea`'s single-program step's on the global batch, not DP's:
every rank draws the single process's noise and reads the single process's
stream, and keeps its rows of every global-batch tensor (`rows`); batch
norm sums its statistics over every rank (`batch_moments`), in the forward
and, through autograd, in the backward; the gradients and metrics are
means over the global batch. Each microbatch of `--grad_accum` K (G rows)
is split over all W ranks when W divides G, and otherwise over the D data
rows, the M ranks of a row then computing the same rows: each rank's
gradient is the mean over its rows, so the sum over the ranks divided by W
is the global mean either way.

Every collective goes through `Collectives` (a sum over the world, an
all-gather over the model row): NCCL on the cards, gloo on the CPU.
"""

from __future__ import annotations

import copy
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from gea_torch.interop import (
    _TO_FLAX,
    discriminator_specs,
    generator_specs,
    reverter_specs,
)
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.ops.layers import batch_norms
from gea_torch.parallel.dp import DataParallel
from gea_torch.parallel.mesh import mesh_coords, model_groups

MODEL_AXIS = "model"
# The torch dim of `gea`'s last (output-channel) axis, per interop layout.
OUT_DIM = {"vec": 0, "dense": 0, "conv": 0, "convt": 1, "scale_dense": 0, "scale_conv": 0,
           "scale_convt": 1}


def leaf_spec(shape, model_shards: int, min_width: int) -> tuple:
    """`gea`'s rule for one state leaf of `shape` (in `gea`'s layout): its
    last axis on 'model' if at least `min_width` wide and divisible by the
    shard count, as a PartitionSpec's tuple; () replicates."""
    if len(shape) >= 1 and shape[-1] >= min_width and shape[-1] % model_shards == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def module_specs(module: torch.nn.Module) -> list:
    """The interop specs of a G, D or R (port key -> `gea` path, layout)."""
    for cls, specs in ((GeneratorLIS, generator_specs), (Discriminator, discriminator_specs),
                       (Reverter, reverter_specs)):
        if isinstance(module, cls):
            return specs(module.cfg)
    raise TypeError(f"no interop specs for {type(module).__name__}")


def shard_axes(module: torch.nn.Module, model_shards: int, min_width: int
               ) -> Dict[str, Optional[int]]:
    """Parameter name -> the torch dim it shards along, or None: `leaf_spec`
    applied to each parameter's shape in `gea`'s layout."""
    params = dict(module.named_parameters())
    out = {}
    for key, collection, _, layout in module_specs(module):
        if collection != "params":
            continue
        gea_shape = _TO_FLAX[layout](torch.empty(params[key].shape, device="meta")).shape
        out[key] = OUT_DIM[layout] if leaf_spec(gea_shape, model_shards, min_width) else None
    if set(out) != set(params):
        raise ValueError(f"interop specs and parameters differ: {sorted(set(out) ^ set(params))}")
    return out


def _split(full: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """`full` seen as (M, ...) along `axis`: M shards side by side."""
    s = full.shape
    return full.view(*s[:axis], m, s[axis] // m, *s[axis + 1:]).movedim(axis, 0)


class Collectives:
    """The collectives of TP: `all_reduce` sums over the world (the default
    group), `all_gather` collects the model row's flat shards."""

    def __init__(self, model_group):
        self.model_group = model_group

    def all_reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t)

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> None:
        """out (M, L) <- every model rank's t (L,), in model-rank order."""
        dist.all_gather(list(out.unbind(0)), t, group=self.model_group)


class _SumOverRanks(torch.autograd.Function):
    """A sum over every rank whose backward is the same sum (each rank's
    loss depends on the sum), differentiable again for WGAN-GP."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        out = t.clone(memory_format=torch.contiguous_format)
        comm.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad, ctx.comm), None


class _Plan:
    """One trained module's shards on this rank: each sharded parameter's
    piece, a view of the full parameter (what its Adam updates), and where
    the pieces sit in the flat (M, L) layout of the all-gather."""

    def __init__(self, module: torch.nn.Module, axes: Dict[str, Optional[int]], m: int,
                 index: int):
        self.m, self.index = m, index
        self.params = dict(module.named_parameters())
        self.sharded = [(n, ax) for n, ax in axes.items() if ax is not None]
        self.axes = dict(self.sharded)
        self.shards = {n: self.piece(n, self.params[n].detach()) for n, _ in self.sharded}
        self.offsets: List[Tuple[int, int]] = []
        at = 0
        for n, _ in self.sharded:
            k = self.shards[n].numel()
            self.offsets.append((at, k))
            at += k
        self.length = at

    def flat(self, pieces: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sharded names' `pieces`, flat and in order: what an
        all-gather sends."""
        return torch.cat([pieces[n].reshape(-1) for n, _ in self.sharded])

    def piece(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full-shaped tensor of parameter `name`."""
        return _split(full, self.axes[name], self.m)[self.index]

    def local(self, name: str) -> torch.Tensor:
        """What this rank's Adam and EMA update of parameter `name`: its
        piece or the whole (replicated) parameter."""
        return self.shards.get(name, self.params[name])

    def fill(self, outs: Dict[str, torch.Tensor], gathered: torch.Tensor) -> None:
        """Each sharded name's full tensor in `outs` from the (M, L) pieces."""
        for (n, ax), (at, k) in zip(self.sharded, self.offsets):
            src = gathered[:, at:at + k].view(self.m, *self.shards[n].shape)
            _split(outs[n], ax, self.m).copy_(src)


class TensorParallel(DataParallel):
    """This process's rank of a (data D, model M) world (`mesh_coords`):
    the `dp` hook of the step builders for `--model_shards M`, with the
    global batch of `batch_size` rows and `accum` microbatches."""

    single_program = True

    def __init__(self, device: torch.device, model_shards: int, batch_size: int,
                 accum: int = 1, min_width: int = 64):
        super().__init__(device)
        if self.size % model_shards:
            raise ValueError(f"model_shards {model_shards} must divide the device count "
                             f"{self.size}")
        self.model_shards, self.min_width = model_shards, min_width
        self.data_rank, self.model_rank = mesh_coords(self.rank, model_shards)
        groups = model_groups(self.size, model_shards)
        self.comm = Collectives(groups[self.data_rank])
        self.batch, self.accum = batch_size, accum
        micro = batch_size // accum
        self.parts = self.size if micro % self.size == 0 else self.size // model_shards
        self.part = self.rank if self.parts == self.size else self.data_rank
        if batch_size % accum or micro % self.parts:
            raise ValueError(f"a microbatch of {micro} rows does not split over "
                             f"{self.parts} ranks")
        self.local = batch_size // self.parts
        # module -> its plan; a state that is dropped takes its plans along.
        self._plans = weakref.WeakKeyDictionary()

    # -- rows of the global batch

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of each microbatch of a global-batch tensor,
        in order (the rank's batch, whose microbatches are its rows of
        the global ones)."""
        per = t.reshape(self.accum, self.parts, -1, *t.shape[1:])[:, self.part]
        return per.reshape(-1, *t.shape[1:])

    def world_rows(self, n: int) -> int:
        if n != self.local:
            raise ValueError(f"{n} rows: this rank's batch is {self.local}")
        return self.batch

    def local_rows(self, batch_size: int) -> int:
        if batch_size != self.batch:
            raise ValueError(f"batch {batch_size}: this world was built for {self.batch}")
        return self.local

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a per-row tensor over the global batch (duplicated
        rows count once per rank on both sides of the division)."""
        s = t.sum().reshape(1).float()
        self.comm.all_reduce(s)
        return (s / (t.numel() * self.size)).reshape(())

    def batch_moments(self, x32: torch.Tensor, dims: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, mean of squares) per channel over every rank's rows, for
        batch norm; differentiable through the sums."""
        n = x32.numel() // x32.shape[-1]
        sums = _SumOverRanks.apply(torch.stack([x32.sum(dims), x32.square().sum(dims)]),
                                   self.comm)
        sums = sums / (n * self.size)
        return sums[0], sums[1]

    def _all_reduce(self, t: torch.Tensor) -> None:
        self.comm.all_reduce(t)

    # -- the sharded state

    def replicate(self, state) -> None:
        """The lead's state on every rank (`DataParallel.replicate`), then
        sharded: each trained module's plan, its Adam moved onto the
        shards (its moments cut to them), the EMA shadow cut to this rank's
        pieces, batch norm summed over the ranks. Messages as `gea`'s `place_state`."""
        super().replicate(state)
        for name, tag in state.PLAYERS:
            module = getattr(state, name)
            axes = shard_axes(module, self.model_shards, self.min_width)
            plan = self._plans[module] = _Plan(module, axes, self.model_shards,
                                               self.model_rank)
            self._move_optimizer(getattr(state, f"opt_{tag}"), plan)
            for b in batch_norms(module):
                b.sync = self.batch_moments
        g_ema = getattr(state, "g_ema", {})
        if g_ema:
            plan = self._plans[state.generator]
            state.g_ema = {n: (plan.piece(n, v).clone() if n in plan.shards else v)
                           for n, v in g_ema.items()}
        frac = sharded_param_fraction(state, self._plans)
        if self.lead:
            if frac == 0.0:
                print(f"[gea_torch] warning: --model_shards {self.model_shards} sharded ZERO "
                      f"state leaves (no last axis >= tp_min_width={self.min_width} divisible "
                      f"by the shard count) — running fully replicated", flush=True)
            else:
                print(f"[gea_torch] tp: {frac:.0%} of state leaves sharded over "
                      f"{self.model_shards} model shards", flush=True)

    @staticmethod
    def _move_optimizer(opt: torch.optim.Optimizer, plan: _Plan) -> None:
        """The Adam of `plan`'s module onto its shards, in place: its param
        groups, lr, capturable form and scheduler stay; each moment is cut
        to this rank's piece."""
        names = {id(p): n for n, p in plan.params.items()}
        for group in opt.param_groups:
            params = []
            for p in group["params"]:
                n = names[id(p)]
                local = plan.local(n)
                st = opt.state.pop(p, None)
                if st is not None:
                    opt.state[local] = {
                        k: (plan.piece(n, v).clone() if local is not p and torch.is_tensor(v)
                            and v.shape == p.shape else v) for k, v in st.items()}
                params.append(local)
            group["params"] = params

    def local_params(self, module: torch.nn.Module):
        """(name, what this rank stores) of each parameter of `module`."""
        plan = self._plans.get(module)
        if plan is None:
            return list(module.named_parameters())
        return [(n, plan.local(n)) for n in plan.params]

    def mean_grads(self, module: torch.nn.Module, accum: int = 1) -> None:
        """DP's mean over the microbatches and the ranks; each shard's
        gradient is then the view of its piece of the full gradient."""
        super().mean_grads(module, accum)
        plan = self._plans[module]
        for n, shard in plan.shards.items():
            shard.grad = plan.piece(n, plan.params[n].grad)

    def mean_stats(self, module: torch.nn.Module) -> None:
        """Nothing: batch norm took its statistics over every rank."""

    def updated(self, module: torch.nn.Module) -> None:
        """After `module`'s update: the other ranks' pieces of its full
        parameters from the model row's shards (one all-gather)."""
        plan = self._plans[module]
        if not plan.sharded:
            return
        gathered = self._all_gather(plan, plan.shards)
        with torch.no_grad():
            plan.fill(plan.params, gathered)

    def _all_gather(self, plan: _Plan, pieces: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(M, L): every model rank's flat `pieces`, in model-rank order."""
        send = plan.flat(pieces)
        # Zeros, not empty: `--debug_checks` reads the collective's output
        # when the op returns, before gloo has filled it.
        out = send.new_zeros(plan.m, plan.length)
        self.comm.all_gather(out, send)
        return out

    def gather(self, plan: _Plan, pieces: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors of the sharded names from this rank's `pieces`
        (one all-gather; every rank calls it)."""
        full = {n: torch.empty_like(plan.params[n]) for n, _ in plan.sharded}
        plan.fill(full, self._all_gather(plan, pieces))
        return full

    def full_view(self, state):
        """A shallow copy of `state` with the full EMA shadow and Adams
        whose `state_dict` holds full moments: what checkpoints and FID
        read. A collective: every rank calls it at the same points."""
        view = copy.copy(state)
        for name, tag in state.PLAYERS:
            plan = self._plans[getattr(state, name)]
            opt = getattr(state, f"opt_{tag}")
            setattr(view, f"opt_{tag}", _FullAdam(self._full_optimizer_state(opt, plan)))
        g_ema = getattr(state, "g_ema", {})
        if g_ema:
            plan = self._plans[state.generator]
            full = self.gather(plan, g_ema) if plan.sharded else {}
            view.g_ema = {n: full.get(n, v) for n, v in g_ema.items()}
        return view

    def _full_optimizer_state(self, opt: torch.optim.Optimizer, plan: _Plan) -> dict:
        sd = opt.state_dict()
        sd["state"] = {i: dict(st) for i, st in sd["state"].items()}  # not the live dicts
        index = {n: i for i, n in enumerate(plan.params)}  # Adam's order is the module's
        for key in ("exp_avg", "exp_avg_sq"):
            pieces = {n: sd["state"][index[n]][key] for n, _ in plan.sharded
                      if index[n] in sd["state"]}
            if not pieces or len(pieces) != len(plan.sharded):
                continue  # nothing sharded, or no update yet: Adam has no moments
            for n, t in self.gather(plan, pieces).items():
                sd["state"][index[n]][key] = t
        return sd



class _FullAdam:
    """What `gea_torch.utils.checkpoint.optimizer_state` reads of an Adam:
    its `state_dict`, here with full moments."""

    def __init__(self, sd: dict):
        self._sd = sd

    def state_dict(self) -> dict:
        return self._sd


def sharded_param_fraction(state, plans: Dict[torch.nn.Module, _Plan]) -> float:
    """The share of the trained state's leaves (each parameter, its two
    Adam moments and its EMA shadow) that shard over 'model'."""
    total = sharded = 0
    for name, _ in state.PLAYERS:
        module = getattr(state, name)
        per = 3 + (1 if module is getattr(state, "generator", None)
                   and getattr(state, "g_ema", {}) else 0)
        plan = plans[module]
        total += per * len(plan.params)
        sharded += per * len(plan.sharded)
    return sharded / total if total else 0.0


def resident_bytes(state) -> Dict[str, int]:
    """Bytes of the storages that hold the trained modules' parameters,
    their gradients, their Adams' state and the EMA shadow, each storage
    counted once (a shard that views its parameter adds nothing): what a
    process keeps of its train state between steps, with or without TP."""
    seen, out = set(), {"params": 0, "grads": 0, "adam": 0, "ema": 0}

    def add(kind: str, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            out[kind] += st.nbytes()

    for name, tag in state.PLAYERS:
        params = list(getattr(state, name).parameters())
        for p in params:
            add("params", p)
        for p in params:
            if p.grad is not None:
                add("grads", p.grad)
        for st in getattr(state, f"opt_{tag}").state.values():
            for v in st.values():
                if torch.is_tensor(v) and v.numel():
                    add("adam", v)
    for t in getattr(state, "g_ema", {}).values():
        add("ema", t)
    return out
