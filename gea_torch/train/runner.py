"""The trainer's host loop (port of `gea/train/runner.py`): the run
directory, the input stream, resume, and `TrainLoop` with its periodic
side effects (losses on stdout, sample grids, the loss plot, checkpoints
with retention, `--fid_interval` tracking of the best snapshot with
`--stop_patience`, `--profile_dir` and `--tensorboard`) and its guards
(NaN/Inf abort, host-RSS budget), over chunks of `--steps_per_dispatch`
steps (`gea_torch.train.dispatch`).

Under data parallelism (`dp`, `gea_torch.parallel`) every rank runs this
loop on its slab of the global batch: its own host stream (seed + 7919 *
rank, as `gea`'s processes) or on-device draws with the rank mixed in.
The lead (rank 0) alone writes config.json, the grids, the plots, the
checkpoints, tensorboard and the profile, and scores FID; its
`--stop_patience` decision is broadcast. The metrics are averaged inside
the step, so the NaN guard fires on every rank at once, and the RSS guard
decides collectively: a trip on one rank makes every rank save (the lead
writes) and exit 19 together, where a rank that left alone would leave the
others waiting in a collective.

Per-step randomness is keyed by the global step, so a resumed run draws
what a run never interrupted would: the data stream fast-forwards to the
resumed step (`input_iterator(start_step=...)`), the flip mask and the
on-device synthetic batch come from a generator seeded by (seed, step)
(`step_generator`), and z, spatial noise and the penalty's eps come from
the train state's own generator, whose state the checkpoint keeps.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from gea_torch.data.hostpre import host_downsample_uint8, host_preprocess
from gea_torch.data.ondevice import preprocess_batch, synthetic_batch
from gea_torch.data.pipeline import backend_of, device_crop_size, make_dataset
from gea_torch.config import dispatch_chunk, resolve_device
from gea_torch.data.prefetch import device_prefetch
from gea_torch.ops.layers import eval_mode
from gea_torch.parallel import DataParallel, join, launcher_env, resolve_num_devices, spawn
from gea_torch.utils.checkpoint import (
    best_record,
    latest_step,
    record_best_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from gea_torch.utils.hostmem import EXIT_HOST_RSS, host_rss_gb, resolve_rss_budget_gb
from gea_torch.utils.meters import ThroughputMeter
from gea_torch.utils.plotting import LossPlotter

DATA_SEED_MIX = 0x5EED  # `gea`'s data key is PRNGKey(seed ^ 0x5EED)


def is_lead(dp) -> bool:
    return dp is None or dp.lead


def state_modules(state) -> list:
    """Every model a train state holds (trained or frozen)."""
    return [m for m in vars(state).values() if isinstance(m, torch.nn.Module)]


def prepare_run(cfg, dp=None) -> str:
    run_dir = os.path.abspath(cfg.save_path)
    os.makedirs(run_dir, exist_ok=True)
    if is_lead(dp):
        cfg.save(os.path.join(run_dir, "config.json"))
    return run_dir


def check_batch(cfg, num_chips: int = 1) -> None:
    """The global batch must split over the ranks, and each rank's batch
    into --grad_accum microbatches."""
    if cfg.batch_size % num_chips:
        raise ValueError(f"batch_size {cfg.batch_size} must divide over {num_chips} devices")
    accum = max(1, cfg.grad_accum)
    per_device = cfg.batch_size // num_chips
    if per_device % accum:
        what = "batch_size" if num_chips == 1 else "per-device batch"
        raise ValueError(f"{what} {per_device} must divide by --grad_accum {accum}")


def synthetic_on_device(cfg) -> bool:
    """True when the synthetic batch is drawn on the device (no input
    transfer)."""
    return cfg.dataset == "synthetic" and cfg.synthetic_on_device and cfg.on_device_pipeline


def step_generator(device: torch.device, rank: int = 0) -> Callable[[int, int],
                                                                    torch.Generator]:
    """(seed, step) -> one generator on `device`, reseeded for that step:
    what it draws is a pure function of (seed, step), and of the rank for a
    rank > 0 (`gea` folds the device index into the step's key)."""
    gen = torch.Generator(device)
    mix = [rank] if rank else []

    def at(seed: int, step: int) -> torch.Generator:
        key = np.random.SeedSequence([seed ^ DATA_SEED_MIX, step, *mix]).generate_state(
            1, np.uint64)
        return gen.manual_seed(int(key[0]) & 0x7FFF_FFFF_FFFF_FFFF)

    return at


def no_input() -> Iterator[None]:
    """The input stream of a step that reads no data (R-separate, whose
    frozen G is its data source): None per step (`gea`'s `dummy_input`)."""
    return (None for _ in itertools.count())


def rank_data(cfg, seed: int, dp=None) -> Tuple[Any, int]:
    """(cfg with this rank's batch, this rank's data seed): each rank
    streams its slab from a stream of its own, seeded seed + 7919 * rank
    (`gea`'s multihost processes)."""
    if dp is None or dp.size == 1:
        return cfg, seed
    return cfg.replace(batch_size=cfg.batch_size // dp.size), seed + 7919 * dp.rank


def input_iterator(cfg, device: torch.device, seed: int, start_step: int = 0,
                   dp=None) -> Iterator[Optional[torch.Tensor]]:
    """The input stream on the device, starting at batch `start_step`:
    None per step when the synthetic batch is drawn on the device; uint8
    batches for the on-device preprocess (at decode resolution, or at
    image_size with --host_resize; gathered on the device with
    --device_data_cache); float32 batches with --on_device_pipeline false.
    Under `dp`, this rank's slab (`rank_data`)."""
    if synthetic_on_device(cfg):
        return no_input()
    if cfg.device_data_cache and dp is not None and dp.size > 1:
        raise ValueError("--device_data_cache is single-host for now (the cache "
                         "replication protocol over non-addressable devices is not "
                         "wired); use --data_cache")
    cfg, seed = rank_data(cfg, seed, dp)
    if cfg.device_data_cache:
        from gea_torch.data.devicecache import device_cached_iterator

        return device_cached_iterator(cfg, device, seed, start_step=start_step)
    ds = make_dataset(cfg, seed=seed)
    if cfg.dataset == "folder" and is_lead(dp):
        print(f"[gea_torch] data: {cfg.dataroot} decoded by {backend_of(ds)} "
              f"(--data_backend {cfg.data_backend}"
              f"{', --data_cache' if cfg.data_cache else ''})", flush=True)
    crop = device_crop_size(cfg)
    batches = ds.batches(start_step)
    if not cfg.on_device_pipeline:
        # The flip is keyed by the batch index, as on the device.
        batches = (host_preprocess(raw, np.random.default_rng([seed ^ 0xFEED, i]),
                                   crop_size=crop, image_size=cfg.image_size,
                                   augment_flip=cfg.augment_flip)
                   for i, raw in enumerate(batches, start_step))
    elif cfg.host_resize:
        batches = (host_downsample_uint8(raw, crop, cfg.image_size) for raw in batches)
    return device_prefetch(batches, device, depth=3)


def make_input_fn(cfg, device: torch.device, dp=None) -> Callable[[Optional[torch.Tensor], int],
                                                                 torch.Tensor]:
    """(batch from `input_iterator`, step) -> the real batch, float32 in
    [-1, 1] on the device: the synthetic draw, or the on-device preprocess,
    run just before the step. Under `dp`, this rank's batch, drawn and
    flipped with the rank mixed in (`step_generator`)."""
    gen_at = step_generator(device, 0 if dp is None else dp.rank)
    if synthetic_on_device(cfg):
        batch = rank_data(cfg, cfg.seed, dp)[0].batch_size
        return lambda _, step: synthetic_batch(gen_at(cfg.seed, step), batch, cfg.image_size)
    if not cfg.on_device_pipeline:
        return lambda batch, step: batch
    crop = (cfg.image_size if cfg.host_resize and not cfg.device_data_cache
            else device_crop_size(cfg))

    def preprocess(raw: torch.Tensor, step: int) -> torch.Tensor:
        return preprocess_batch(raw, crop, cfg.image_size, cfg.augment_flip,
                                gen=gen_at(cfg.seed, step))

    return preprocess


def maybe_resume(cfg, state, dp=None) -> Tuple[Any, int]:
    """--load_path restores an earlier run; checkpoints already in
    --save_path resume this run. Checkpoints in save_path win: a relaunch
    with the same arguments must continue the run's own progress, not
    rewind to the warm start (and load_path may be gone by then, so its
    check applies only when it is used). An explicit load_path without
    checkpoints is an error. Under `dp` every rank restores the same step,
    and then holds the lead's state (`DataParallel.replicate`)."""
    state = _resume(cfg, state, is_lead(dp))
    if dp is not None:
        dp.replicate(state)
    return state, state.step


def _resume(cfg, state, lead: bool):
    own = latest_step(cfg.save_path) is not None
    if own and cfg.save_path != cfg.load_path:
        source = cfg.save_path
        if cfg.load_path and lead:
            print(f"[gea_torch] save_path has checkpoints: auto-resuming from it "
                  f"(ignoring --load_path {cfg.load_path} warm start)")
    elif cfg.load_path:
        if latest_step(cfg.load_path) is None:
            raise FileNotFoundError(f"--load_path {cfg.load_path!r} contains no checkpoints")
        source = cfg.load_path
    else:
        source = cfg.save_path if own else ""
    if not source:
        return state
    state = restore_checkpoint(source, state)
    if lead:
        print(f"[gea_torch] resumed from {source} at step {state.step}", flush=True)
    return state


class TrainLoop:
    """Drives `step_fn(state, reals) -> metrics` over the input stream: k
    steps a call, one per real batch in `reals` (`build_step_fn`'s
    dispatcher; k = --steps_per_dispatch K, or what is left of the run).
    `input_fn(batch, step)` makes step `step`'s real batch from the
    stream's batch. `loss_keys` are the metrics plotted and printed first:
    each trainer passes its own (G-LIS loss_d and loss_g, R-separate loss_r,
    R-iterative loss_d, loss_g and loss_r_sim).
    Metrics are tensors on the device, 0-d for one step and (k,) for a
    chunk, read on the host only at log intervals: the loop logs a chunk's
    last value, plots every inner step and checks every value for NaN/Inf.
    The host waits for the device once more, when the warm-up ends. Log,
    vis, FID and save fire at the end of the chunk that crosses their
    interval, as `gea`'s do.

    `--profile_dir` records a torch.profiler trace (CPU and CUDA) of the
    dispatches that run steps start+10..start+15, rounded out to chunk
    ends, into <profile_dir>/trace_<first iter>-<last iter>.json.
    `--tensorboard` writes the logged metrics as `train/<key>` and the
    meter's rates as `perf/<key>` into <run>/tb (and each FID as
    `train/fid`); where `torch.utils.tensorboard` cannot be loaded it says
    so and goes on.

    `vis_fn` and `fid_fn` run with every model of the state in inference
    mode (batch norm on its running statistics, which they leave as they
    were; `gea` applies them with train=False), each mode put back after.

    `fid_fn(state) -> float` (`--fid_interval`) scores the current model at
    every crossed multiple of fid_interval and at niter: the loop appends
    to <run>/fid.jsonl, plots plots/fid.png, saves each new best and
    protects it from retention, points best.json at it once its save is
    durable, and with `--stop_patience` ends the run after that many
    evaluations without a new best.

    Under `dp` the side effects above are the lead's; the other ranks
    train, join the collective decisions and write nothing."""

    def __init__(
        self,
        cfg,
        run_dir: str,
        state,
        step_fn: Callable[[Any, torch.Tensor], Dict[str, torch.Tensor]],
        data_iter: Iterator,
        input_fn: Callable[[Any, int], torch.Tensor],
        vis_fn: Optional[Callable[[Any, int], None]] = None,
        loss_keys: Tuple[str, ...] = ("loss_d", "loss_g"),
        fid_fn: Optional[Callable[[Any], float]] = None,
        dp=None,
    ):
        self.cfg = cfg
        self.dp = dp
        self.lead = is_lead(dp)
        self.num_chips = 1 if dp is None else dp.size
        self.run_dir = run_dir
        self.state = state
        self.step_fn = step_fn
        self.data_iter = data_iter
        self.input_fn = input_fn
        self.vis_fn = vis_fn
        self.loss_keys = loss_keys
        self.plotter = LossPlotter()
        self.fid_fn = fid_fn
        self._fid_plotter = LossPlotter()
        self._best_fid = float("inf")
        self._best_step: Optional[int] = None
        # The latest best, saved asynchronously, that best.json does not
        # point at yet: (step, fid). Committed once its save is durable.
        self._pending_best: Optional[Tuple[int, float]] = None
        # The step best.json points at now. Retention must protect it and
        # the pending best, or best.json could name a deleted directory.
        self._committed_best_step: Optional[int] = None
        self._evals_since_best = 0
        self.meter = ThroughputMeter(cfg.batch_size)
        self.last_metrics: Dict[str, float] = {}
        # Host seconds per loop iteration, and of those, waiting for input.
        self.step_s: list = []
        self.input_wait_s: list = []
        # Loop iterations (of one chunk each) up to the meter's warm-up end.
        self._warm_iterations = self.meter.warmup_steps
        self._profiler = None
        self._tb = None
        if cfg.tensorboard and self.lead:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except (ImportError, OSError) as e:
                print(f"[gea_torch] tensorboard disabled ({e})", flush=True)

    def _tb_write(self, step: int, metrics: Dict[str, float], stats: Dict[str, float]) -> None:
        if self._tb is None:
            return
        for k, v in metrics.items():
            self._tb.add_scalar(f"train/{k}", v, step)
        for k, v in stats.items():
            self._tb.add_scalar(f"perf/{k}", v, step)

    def _profile(self, start_step: int, it: int, k: int) -> None:
        """Start the trace before the dispatch that runs step start+10 (a
        0-based step index), stop it after the one that reaches start+15."""
        first, last = start_step + 10, start_step + 15
        if (self.cfg.profile_dir and self.lead and self._profiler is None and it < last
                and it + k > first):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.state.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._profiled_from = it + 1

    def _stop_profile(self) -> None:
        if self._profiler is None:
            return
        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)
        self._profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        iters = f"{self._profiled_from}-{self.state.step}"
        path = os.path.join(self.cfg.profile_dir, f"trace_{iters}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"[gea_torch] profiler trace of iters {iters} written to {path}", flush=True)

    def stats(self) -> Dict[str, float]:
        """The meter's rates (the global batch's images/s, and per chip)
        and the loop's median host times."""
        return {**self.meter.stats(self.num_chips), **self.timings()}

    def timings(self) -> Dict[str, float]:
        """Medians over the iterations after the warm-up."""
        skip = self._warm_iterations
        out = {}
        for key, xs in (("step_wall_s_median", self.step_s),
                        ("input_wait_s_median", self.input_wait_s)):
            xs = xs[skip:] or xs
            out[key] = statistics.median(xs) if xs else 0.0
        return out

    def _save(self, step: int) -> None:
        """An asynchronous save with retention that spares the best
        snapshots; the save in flight before it is then durable. The
        lead's alone."""
        if not self.lead:
            return
        save_checkpoint(self.run_dir, step, self.state, keep=self.cfg.keep_checkpoints,
                        async_save=True, protect=(self._committed_best_step, self._best_step))
        self._commit_pending_best()

    def _save_and_keep_all(self, step: int) -> None:
        """The guards' save (post-mortem, RSS): synchronous and pruning
        nothing, so a NaN state never evicts the finite checkpoints. Every
        rank calls it, the lead writes, and no rank goes on (to exit or
        raise) before the file is written."""
        if self.lead:
            save_checkpoint(self.run_dir, step, self.state)
            self._commit_pending_best()
        if self.dp is not None:
            self.dp.barrier()

    def _commit_pending_best(self) -> None:
        """Point best.json at the last best-save. Only after that save is
        known durable (every later save, and the final wait, waits for the
        one in flight): a crash never leaves best.json naming a missing
        directory."""
        if self._pending_best is not None:
            step, fid = self._pending_best
            record_best_step(self.run_dir, step, fid, "fid")
            self._committed_best_step = step
            self._pending_best = None

    def _track_fid(self, step: int) -> Tuple[bool, bool]:
        """One evaluation: (saved as a new best, stop early)."""
        with eval_mode(*state_modules(self.state)):
            fid = float(self.fid_fn(self.state))
        is_best = fid < self._best_fid
        self._evals_since_best = 0 if is_best else self._evals_since_best + 1
        patience = getattr(self.cfg, "stop_patience", 0)
        stop = patience > 0 and self._evals_since_best >= patience
        if stop:
            print(f"[gea_torch] early stop at iter {step}: no new best in {patience} "
                  f"evaluations (best {self._best_fid:.3f} @ {self._best_step})", flush=True)
        print(f"[gea_torch] iter {step}: fid={fid:.3f}" + (
            " (new best)" if is_best else f" (best {self._best_fid:.3f} @ {self._best_step})"),
            flush=True)
        with open(os.path.join(self.run_dir, "fid.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, "fid": round(fid, 4)}) + "\n")
        self._fid_plotter.add(step, fid=fid)
        self._fid_plotter.plot(os.path.join(self.run_dir, "plots", "fid.png"), ylabel="proxy-FID")
        self._tb_write(step, {"fid": fid}, {})
        if is_best:
            # The save runs in the background; best.json points at it at
            # the next moment it is known durable.
            self._save(step)
            self._best_fid, self._best_step = fid, step
            self._pending_best = (step, fid)
        return is_best, stop

    def run(self, start_step: int):
        try:
            return self._run(start_step)
        finally:
            # A run that ends (or fails) inside the profile window still
            # leaves its trace; the writer is flushed.
            self._stop_profile()
            if self._tb is not None:
                self._tb.close()

    def _run(self, start_step: int):
        cfg = self.cfg
        k_cfg = dispatch_chunk(cfg)
        rss_budget = resolve_rss_budget_gb(cfg.max_host_rss_gb)
        if self.fid_fn is not None and (cfg.load_path or start_step > 0):
            # A resumed run goes on comparing against its recorded best; a
            # fresh run into a reused save_path does not adopt a stale one.
            prior = best_record(self.run_dir)
            if prior is not None:
                self._best_fid = float(prior.get("metric", float("inf")))
                self._best_step = self._committed_best_step = int(prior["step"])
        it = start_step
        while it < cfg.niter:
            # Host-RSS guard: checkpoint and exit for a clean auto-resume.
            # Not before this process's first step (a relaunch must make
            # progress), and after the save in flight. A collective
            # decision: every rank stops when one trips.
            trip = it > start_step and host_rss_gb() > rss_budget
            if self.dp is not None:
                trip = self.dp.any(trip)
            if trip:
                self._save_and_keep_all(it)  # after the save in flight
                print(f"[gea_torch] host RSS {host_rss_gb():.1f} GB exceeds the "
                      f"{rss_budget:.1f} GB budget (--max_host_rss_gb). Checkpoint "
                      f"saved at step {it}; exiting {EXIT_HOST_RSS} for a clean "
                      "auto-resume restart.", flush=True)
                raise SystemExit(EXIT_HOST_RSS)
            k = min(k_cfg, cfg.niter - it)  # the ragged tail runs only what is left
            t0 = time.perf_counter()
            batches = [next(self.data_iter) for _ in range(k)]
            self.input_wait_s.append(time.perf_counter() - t0)
            self._profile(start_step, it, k)
            metrics = self.step_fn(self.state, [self.input_fn(batch, it + i)
                                                for i, batch in enumerate(batches)])
            if self.meter.tick(k):
                if self.state.device.type == "cuda":  # keep the warm-up off the clock
                    torch.cuda.synchronize(self.state.device)
                self.meter.restart_timer()
                self._warm_iterations = len(self.step_s) + 1
            prev, it = it, it + k
            if it >= start_step + 15:
                self._stop_profile()

            def crossed(interval: int) -> bool:
                # A multiple of `interval` in (prev, it]: with chunks, it
                # fires at the end of the chunk. <= 0 disables.
                return interval > 0 and it // interval > prev // interval

            if crossed(cfg.log_interval) or prev == start_step:
                # Averaged over the ranks: every rank sees the same values.
                # A 0-d metric is one step's; a (k,) one a chunk's.
                hist = {key: [float(v)] if v.dim() == 0 else v.tolist()
                        for key, v in metrics.items()}
                m = {key: vs[-1] for key, vs in hist.items()}
                bad = [key for key, vs in hist.items() if not np.all(np.isfinite(vs))]
                if bad:
                    self._save_and_keep_all(it)
                    raise FloatingPointError(
                        f"non-finite metrics {bad} at iter {it}; post-mortem "
                        f"checkpoint written to {self.run_dir}")
                self.last_metrics = m
                for j in range(k):
                    self.plotter.add(prev + j + 1, **{key: hist[key][j] for key in self.loss_keys
                                                       if key in hist})
                stats = self.meter.stats(self.num_chips)
                self._tb_write(it, m, stats)
                extras = " ".join(f"{k}={v:.4f}" for k, v in m.items()
                                  if k not in self.loss_keys)
                if self.lead:
                    print(f"[gea_torch] iter {it}/{cfg.niter} "
                          + " ".join(f"{k}={m[k]:.4f}" for k in self.loss_keys if k in m)
                          + (f" {extras}" if extras else "")
                          + f" | {stats['images_per_sec']:.1f} img/s"
                          + (f" ({stats['images_per_sec_per_chip']:.1f}/chip)"
                             if self.dp is not None else ""), flush=True)

            if crossed(cfg.vis_interval) and self.vis_fn is not None and self.lead:
                with eval_mode(*state_modules(self.state)):
                    self.vis_fn(self.state, it)
                self.plotter.plot(os.path.join(self.run_dir, "plots", "loss.png"))

            saved_for_best = stop_early = False
            if cfg.fid_interval > 0 and (crossed(cfg.fid_interval) or it == cfg.niter):
                if self.fid_fn is not None and self.lead:
                    saved_for_best, stop_early = self._track_fid(it)
                if self.dp is not None:
                    stop_early = self.dp.broadcast_flag(stop_early)
            if (crossed(cfg.save_interval) or it == cfg.niter or stop_early) and not saved_for_best:
                self._save(it)
            self.step_s.append(time.perf_counter() - t0)
            if stop_early:
                break

        wait_for_checkpoints()
        self._commit_pending_best()
        if self.dp is not None:  # no rank goes on before the lead's last save is on disk
            self.dp.barrier()
        return self.state


def _rank_stats(device: torch.device, train: Callable, cfg) -> Dict[str, Any]:
    """One spawned rank of `run_trainer`: its stats (rank 0's are kept)."""
    return train(device, cfg, DataParallel(device))[1]


def run_trainer(cfg, train: Callable, build_state: Callable) -> Tuple[Any, Dict[str, Any]]:
    """Run a trainer on the run's world and return the lead's (state,
    stats). `train(device, cfg, dp)` is one rank's run (dp None for a
    single process); `build_state(device, cfg)` makes a fresh state.

    * `--multihost`: this process is one rank of the launcher's group
      (`gea_torch.parallel.launcher_env`); `--fid_interval` is refused with
      more than one process, as in `gea`.
    * `--num_devices N` > 1: N spawned ranks on this host; the lead's
      state is read back from its last checkpoint.
    * otherwise one process on one device, without collectives."""
    device = resolve_device(cfg.device)
    if cfg.multihost:
        launch = launcher_env()
        if cfg.fid_interval > 0 and launch.size > 1:
            # The best-snapshot pinning decides on the lead only, as in
            # `gea`, which refuses it on pods.
            raise SystemExit("--fid_interval is not supported with --multihost yet; "
                             "track FID offline with gea_torch.cli.compute_fid/eval_stages")
        device = join(device, launch)
        print(f"[gea_torch] multihost: process {launch.rank}/{launch.size}, {device}",
              flush=True)
        return train(device, cfg, DataParallel(device))
    n = resolve_num_devices(cfg.num_devices, device)
    if n == 1:
        return train(device, cfg)
    check_batch(cfg, n)
    print(f"[gea_torch] data parallel: {n} ranks on {device.type}, "
          f"{cfg.batch_size // n} of the batch of {cfg.batch_size} each", flush=True)
    stats = spawn(_rank_stats, n, device, args=(train, cfg))
    state = build_state(device, cfg)
    if latest_step(cfg.save_path) is not None:
        state = restore_checkpoint(cfg.save_path, state)
    return state, stats
