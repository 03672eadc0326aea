"""K train steps per dispatch, `--steps_per_dispatch` (port of the chunked
dispatch of `gea/train/runner.py`: `chunk_steps`, `make_step_dispatcher`
and `build_step_fn`).

`gea` fuses K steps into one XLA program with `lax.scan`, so that one host
dispatch covers K optimizer updates. The port's counterpart on the card is
a CUDA graph: `StepDispatcher` captures K train steps once with
`torch.cuda.graph` and replays the graph once per K steps, so the host
enqueues one graph launch where it enqueued some 1,000 kernel launches a
step.

A graph reads and writes fixed addresses, so what a chunk varies lives in
static buffers that the host fills before each replay:

* the real batches, (K, B, H, W, 3): each inner step's batch is made by
  the loop's eager input path (the preprocess and the synthetic draw are
  keyed by the global step through a reseeded generator, which a capture
  cannot hold) and copied into its slot;
* the noise, (K, ...) per draw: the host draws each step's z, spatial
  noise and gradient-penalty eps from the state's generator in the order K
  eager steps draw them (`step.noise`), so the chunk trains on the numbers
  K eager steps would;
* the learning rate, (K,) per param group of a scheduled optimizer: each
  inner step copies its lr into its Adam's 0-d lr tensor (`make_optimizer`
  with `chunked`; capturable on the card), on either device; the
  schedulers advance on the host after the chunk and never run inside the
  capture.

The metrics come back as (K,) tensors copied out of the graph's static
outputs. `state.step` advances by K on the host after each replay: the
step's own `+= 1` runs at capture only.

Before its first capture the dispatcher runs one step on a side stream from
the chunk's first inputs, and then puts back every tensor that step changed
(parameters, Adam's moments and counts, the EMA shadow): the warm-up does
what a capture cannot (Triton's first compile, the kernel libraries' load
and their `cudaFuncSetAttribute`, Adam's lazy state, the steps' weight
tensors) and trains nothing. One graph is captured per chunk size, so the
ragged tail of a run (niter % K, or a resume at a misaligned step) costs
one more capture, not a different run length.

The kernels' launch counters are Python and run at capture, not at replay:
the capture's counts are taken off again and added back at every replay
(`ops.add_launch_counts`), so after N graphed steps the counts are N times
an eager step's. The warm-up's launches are taken off too.

No fallback: a capture or replay that fails raises, and with K > 1 the card
runs no train step eagerly (the warm-up's is undone). On the CPU
(`--device cpu`, the tests) the dispatcher fills the same buffers, lr
included, and runs the same K-step body eagerly.

With `gea_torch.utils.trace` on, a chunk's host time is three spans:
`dispatch.noise` (the K draws), `dispatch.fill` (the slots' and the lr's
copies) and `dispatch.replay` (the graph's launch, the launch counts and
the outputs' clone). Each enqueues work, and a launch that finds the
device's queue full waits in its span.
None runs inside a capture.

`--debug_checks` drives the checked eager step (`gea_torch.utils.debug`)
once per step, K times per chunk as `gea` drives its checked single step,
and stacks the metrics: an error names the step within the chunk.

A restore into the state (`load_state_dict`) after a capture leaves the
graphs on the old tensors: build a new dispatcher after it.

Under data parallelism the step's all-reduces (`gea_torch.parallel.dp`)
are captured with it: NCCL can be captured once its communicator exists,
and the warm-up's eager step issues them first. They reduce the players'
flat gradient buffers, whose addresses the graph keeps. Tensor
parallelism's all-gathers (`gea_torch.parallel.tp`) are captured the same
way: they fill the players' own parameters from flat shard buffers.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from gea_torch import ops
from gea_torch.config import dispatch_chunk
from gea_torch.train.state import scheduled_lrs
from gea_torch.utils import trace
from gea_torch.utils.debug import checked_step

Metrics = Dict[str, torch.Tensor]


@dataclass
class CapturedChunk:
    """One captured graph of k steps and what it was measured at."""

    graph: "torch.cuda.CUDAGraph"
    out: Metrics  # the graph's static outputs, (k,) each
    launches: Dict[str, int]  # kernel launches of one replay
    capture_s: float
    pool_peak_mb: float  # the most the capture held in the graph's pool


def players(state):
    """(optimizer, scheduler or None) of each trained module of `state`."""
    return [(getattr(state, f"opt_{tag}"), getattr(state, f"sched_{tag}"))
            for _, tag in state.PLAYERS]


def advance_schedules(state, k: int) -> None:
    """Step every scheduler k times (a capturable Adam's lr tensor, which
    the graphs read, is filled in place)."""
    for _, sched in players(state):
        if sched is not None:
            for _ in range(k):
                sched.step()


@contextlib.contextmanager
def schedules_off(state):
    """The state without its schedulers: the step then only updates; the
    dispatcher sets the lr itself and advances the schedules afterwards."""
    tags = [tag for _, tag in state.PLAYERS]
    kept = {tag: getattr(state, f"sched_{tag}") for tag in tags}
    for tag in tags:
        setattr(state, f"sched_{tag}", None)
    try:
        yield
    finally:
        for tag, sched in kept.items():
            setattr(state, f"sched_{tag}", sched)


def updated_tensors(state) -> List[torch.Tensor]:
    """Every tensor a train step updates in place: the trained modules'
    parameters and buffers, their Adam's parameters (the shards under tensor
    parallelism) and state, the EMA shadow."""
    out = []
    for name, tag in state.PLAYERS:
        module = getattr(state, name)
        opt = getattr(state, f"opt_{tag}")
        out += [*module.parameters(), *module.buffers()]
        out += [p for group in opt.param_groups for p in group["params"]]
        for st in opt.state.values():
            out += [v for v in st.values() if torch.is_tensor(v)]
    return out + list(getattr(state, "g_ema", {}).values())


class StepDispatcher:
    """`dispatch(state, reals) -> metrics`: len(reals) train steps (k), one
    per real batch (None for a step that reads none). With K = 1 it is the
    eager step and its metrics are 0-d; with K > 1 the metrics are (k,)."""

    def __init__(self, cfg, step: Callable[..., Metrics], debug: bool = False):
        self.k_cfg = dispatch_chunk(cfg)
        self.step = step
        self.checked = checked_step(step) if debug else None
        self.chunks: Dict[int, CapturedChunk] = {}
        self.buffers: Dict[str, torch.Tensor] = {}  # "real" and the noise keys, (K, ...)
        self.noise_keys: Sequence[str] = ()
        self.lr_buffers: Optional[List[tuple]] = None  # (param group, (K,) lr buffer)
        self.warm_up_s: Optional[float] = None

    def __call__(self, state, reals: Sequence) -> Metrics:
        k = len(reals)
        if self.checked is not None:
            return self._checked(state, reals)
        if self.k_cfg == 1:
            return self.step(state, reals[0])
        if not 1 <= k <= self.k_cfg:
            raise ValueError(f"a chunk of {k} steps under --steps_per_dispatch {self.k_cfg}")
        with trace.span("dispatch.noise"):
            noise = [self.step.noise(state) for _ in range(k)]
        with trace.span("dispatch.fill"):
            self._fill(state, reals, noise)
            self._fill_lr(state, k)
        # The draws are in their slots: free them before the replay (and a
        # first capture), so that neither holds their memory.
        del noise
        # On the CPU the replay's span holds the eager body.
        with schedules_off(state), trace.span("dispatch.replay"):
            metrics = (self._replay(state, k) if state.device.type == "cuda"
                       else self._body(state, k))
        advance_schedules(state, k)
        return metrics

    def _checked(self, state, reals: Sequence) -> Metrics:
        k, first = len(reals), state.step + 1
        if self.k_cfg == 1:
            return self.checked(state, reals[0], where=f"iter {first}")
        out = [self.checked(state, real, where=f"step {i + 1} of {k} of the chunk at iters "
                            f"{first}..{first + k - 1} (iter {first + i})")
               for i, real in enumerate(reals)]
        return {key: torch.stack([m[key] for m in out]) for key in out[0]}

    def _fill(self, state, reals: Sequence, noise: List[dict]) -> None:
        """Copy each step's real batch and draws into its slot."""
        slots = [{"real": real, **drawn} for real, drawn in zip(reals, noise)]
        if not self.buffers:
            self.noise_keys = tuple(noise[0])
            self.buffers = {key: torch.empty((self.k_cfg, *v.shape), dtype=v.dtype,
                                             device=state.device)
                            for key, v in slots[0].items() if v is not None}
        for i, slot in enumerate(slots):
            for key, buf in self.buffers.items():
                buf[i].copy_(slot[key])

    def _fill_lr(self, state, k: int) -> None:
        """The lr of each scheduled param group's next k updates into its
        (K,) buffer."""
        scheduled = [(opt, sched) for opt, sched in players(state) if sched is not None]
        if self.lr_buffers is None:
            self._check_form(state)
            self.lr_buffers = [(g, torch.zeros(self.k_cfg, dtype=g["lr"].dtype,
                                               device=state.device))
                               for opt, _ in scheduled for g in opt.param_groups]
        values = [v for _, sched in scheduled for v in scheduled_lrs(sched, k)]
        cuda = state.device.type == "cuda"
        for (_, buf), v in zip(self.lr_buffers, values):
            # Pinned and asynchronous on the card: the host does not wait.
            buf[:k].copy_(torch.tensor(v, dtype=buf.dtype, pin_memory=cuda),
                          non_blocking=cuda)

    @staticmethod
    def _check_form(state) -> None:
        cuda = state.device.type == "cuda"
        for opt, sched in players(state):
            for group in opt.param_groups:
                if (sched is not None and not torch.is_tensor(group["lr"])) or (
                        cuda and not group["capturable"]):
                    raise ValueError(
                        "chunked train steps need a tensor lr under a schedule and, on the "
                        "card, a capturable Adam: make the state with --steps_per_dispatch "
                        "> 1 (make_optimizer)")

    def _copy_lr(self, i: int) -> None:
        for group, buf in self.lr_buffers:
            group["lr"].copy_(buf[i])

    def _body(self, state, k: int) -> Metrics:
        """k steps on the buffers' first k slots, each with its lr; the
        metrics stacked."""
        out = []
        real = self.buffers.get("real")
        for i in range(k):
            self._copy_lr(i)
            noise = {key: (self.buffers[key][i] if key in self.buffers else None)
                     for key in self.noise_keys}
            out.append(self.step(state, None if real is None else real[i], **noise))
        return {key: torch.stack([m[key] for m in out]) for key in out[0]}

    def _replay(self, state, k: int) -> Metrics:
        chunk = self.chunks.get(k)
        if chunk is None:
            chunk = self.chunks[k] = self._capture(state, k)
        chunk.graph.replay()
        ops.add_launch_counts(chunk.launches)
        state.step += k
        return {key: v.clone() for key, v in chunk.out.items()}

    @contextlib.contextmanager
    def _uncounted(self, state):
        """Run without adding to the launch counts or the step count."""
        counts, step = ops.launch_counts(), state.step
        try:
            yield
        finally:
            ops.add_launch_counts({n: counts[n] - c for n, c in ops.launch_counts().items()})
            state.step = step

    def _warm_up(self, state) -> None:
        """One step on a side stream from slot 0, then every tensor it
        changed put back; a tensor it made (Adam's lazy state, whose fresh
        value is zeros) is zeroed."""
        t0 = time.perf_counter()
        dev = state.device
        before = {id(t): (t, t.detach().clone()) for t in updated_tensors(state)}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with self._uncounted(state), torch.cuda.stream(side):
            self._body(state, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t in updated_tensors(state):
                if id(t) in before:
                    t.copy_(before[id(t)][1])
                else:
                    t.zero_()
        torch.cuda.synchronize(dev)
        self.warm_up_s = time.perf_counter() - t0

    def _capture(self, state, k: int) -> CapturedChunk:
        if self.warm_up_s is None:
            self._warm_up(state)
        dev = state.device
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        # thread_local: the input prefetcher's thread may allocate pinned
        # memory and copy on its own stream meanwhile.
        with self._uncounted(state), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._body(state, k)
            launches = {n: c - counts[n] for n, c in ops.launch_counts().items()}
        torch.cuda.synchronize(dev)
        return CapturedChunk(
            graph=graph, out=out, launches=launches, capture_s=time.perf_counter() - t0,
            pool_peak_mb=(torch.cuda.max_memory_allocated(dev) - base) / 2**20)


def build_step_fn(cfg, step: Callable[..., Metrics]) -> StepDispatcher:
    """The driveable step of a trainer (`gea`'s `build_step_fn`): the
    dispatcher over `--steps_per_dispatch`, checked with `--debug_checks`.
    Shared by the three trainers, so that their contract cannot drift."""
    debug = cfg.debug_checks
    if debug:
        print("[gea_torch] --debug_checks: every floating output of the train step is "
              "checked for NaN/Inf (forward, backward and update; eager steps, several "
              "times the step cost, one wait for the device a step)", flush=True)
        if cfg.multihost:
            raise SystemExit("--debug_checks is single-host only")
    return StepDispatcher(cfg, step, debug=debug)
