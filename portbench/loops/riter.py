"""The R-iterative training loop: G, D and the reverser R trained jointly,
through the trainers' graphed path as `python -m
gea_torch.cli.train_r_iterative` builds it, closed loop.

Set-up builds one `RIterativeTrainState` (the port's G, D and R holding
the seed's weights, drawn in one draw over the three players' parameters;
one Adam each as `make_optimizer` makes it for chunked steps; the state's
generator seeded with the seed), the step (`build_r_iterative_step`), its
dispatcher (`build_step_fn`) and the input stream (`input_iterator`,
`make_input_fn`; the mix's flags choose `--dataset synthetic
--synthetic_on_device true`). As in the `train` loop, one chunk of K steps
captures the graph that the window replays, and its first replay is what
the check compares (`compare_riter`) with K steps of `reference.riter`.

The window, the traced segment and the spy's step are the `train` loop's.
A traced run then runs one more eager step under torch.profiler with the
program's span ranges on (`gea_torch.utils.trace`), and reads the device
time of the kernels launched inside the `riter.link` spans (the chain's R
passes, residual adds and renders) and inside `riter.gr_backward` (the G/R
loss's backward; the autograd engine's launches count for the span its
caller is in), if the program's counters say the step ran 2T links and
2(T + 1) renders. A program without the counters or the spans reads
nothing there.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable, Optional, Tuple

import torch

from portbench import compare_riter
from portbench.loops import exact_matmuls, phase, sync, with_limits
from portbench.loops.train import Loop as TrainLoop
from portbench.reference import glis, riter
from portbench.weights import load_into, make_weights

PLAYERS = (("g", "generator", "opt_g"), ("d", "discriminator", "opt_d"),
           ("r", "reverter", "opt_r"))
RANGE_PREFIX = "gea_torch.span::"


def build_players(cfg, seed: int, device: torch.device) -> Tuple:
    """(G, D, R, {"g", "d", "r": weights}): the port's single-stage G, D and
    R on the device, holding the seed's weights; the weights dicts are
    copies for the reference."""
    from gea_torch.models import Discriminator, GeneratorLIS, Reverter
    from gea_torch.train.state import generator_config

    with torch.device(device):
        modules = {"g": GeneratorLIS(generator_config(cfg), device=device),
                   "d": Discriminator(cfg, device=device),
                   "r": Reverter(cfg, device=device)}
    shapes = [(f"{who}.{n}", tuple(p.shape)) for who, m in modules.items()
              for n, p in m.named_parameters()]
    flat = make_weights(shapes, seed, device)
    weights: Dict[str, Dict[str, torch.Tensor]] = {who: {} for who in modules}
    for name, t in flat.items():
        who, leaf = name.split(".", 1)
        weights[who][leaf] = t
    for who, m in modules.items():
        load_into(m, weights[who])
    return modules["g"], modules["d"], modules["r"], weights


def host_events(prof) -> Iterable[Tuple]:
    """(name, on the device, start ns, end ns, correlation id) of each
    event of a profiler trace."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA, start, start + e.duration_ns(),
               e.correlation_id())


def span_kernel_ms(events: Iterable[Tuple], span: str) -> Optional[Tuple[float, int]]:
    """(device ms, kernels) of the kernels whose launch (the host's CUDA
    runtime or driver call, matched by correlation id) lies inside a range
    `gea_torch.span::<span>`, on any thread; None without such a range or
    without a kernel launched in one."""
    events = list(events)
    ranges = [(s, e) for n, dev, s, e, _ in events if not dev and n == RANGE_PREFIX + span]
    launches = {c: s for n, dev, s, _, c in events if not dev and n.startswith("cu") and c}
    if not ranges:
        return None
    ms, n_kernels = 0.0, 0
    for name, dev, s, e, c in events:
        t = launches.get(c) if dev else None
        if t is not None and any(lo <= t <= hi for lo, hi in ranges):
            ms += (e - s) / 1e6
            n_kernels += 1
    return (ms, n_kernels) if n_kernels else None


class Loop(TrainLoop):
    def make_config(self):
        from gea_torch.config import TrainRIterativeConfig

        flags = {**self.run.cell.config["flags"], **self.mix["flags"]}
        return TrainRIterativeConfig(**flags, seed=self.run.seed, device=self.run.device.type,
                                     niter=10 ** 12)

    def setup(self, warm: bool = True) -> None:
        from gea_torch.train import steps_r
        from gea_torch.train.dispatch import build_step_fn
        from gea_torch.train.runner import input_iterator, make_input_fn
        from gea_torch.train.state import RIterativeTrainState, chunked, make_optimizer

        run, dev = self.run, self.run.device
        cfg = self.cfg = self.make_config()
        g, d, r, self.weights0 = build_players(cfg, run.seed, dev)
        phase(run, "models built")
        sched = (cfg.lr_schedule, cfg.niter, cfg.lr_final, chunked(cfg))
        opts = {who: make_optimizer(m.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
                for who, m in (("g", g), ("d", d), ("r", r))}
        self.state = RIterativeTrainState(
            generator=g, discriminator=d, reverter=r, opt_g=opts["g"][0], opt_d=opts["d"][0],
            opt_r=opts["r"][0], sched_g=opts["g"][1], sched_d=opts["d"][1],
            sched_r=opts["r"][1], rng=torch.Generator(dev).manual_seed(run.seed))
        self.step = steps_r.build_r_iterative_step(cfg)
        self.fn = build_step_fn(cfg, self.step)
        self.data = input_iterator(cfg, dev, cfg.seed)
        self.input_fn = make_input_fn(cfg, dev)
        self.it = 0
        self.k = cfg.steps_per_dispatch

        m = self.chunk(self.k)
        self.prog = {"metrics": [{key: float(v[i]) for key, v in m.items()}
                                 for i in range(self.k)],
                     "moments": self.moments(),
                     "params": {who: self.params(getattr(self.state, name))
                                for who, name, _ in PLAYERS}}
        phase(run, f"chunk of {self.k} (captured, run, kept)")

    def moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each Adam's first moment; zeros for a parameter that it never
        stepped."""
        out = {}
        for who, name, opt_name in PLAYERS:
            opt = getattr(self.state, opt_name)
            out[who] = {n: opt.state[p]["exp_avg"].detach().clone()
                        if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                        for n, p in getattr(self.state, name).named_parameters()}
        return out

    # -- traced runs --------------------------------------------------------

    def time_kernel_calls(self) -> None:
        """The `train` loop's spy step, then one eager step under the
        profiler with the program's span ranges on: the chain's readings."""
        super().time_kernel_calls()
        for key, value in self.chain_readings().items():
            self.run.counts[key] = value

    def chain_readings(self) -> Dict[str, float]:
        """{"chain_ms", "gr_backward_ms"} of one eager step, each where the
        program has its spans and counters and they read a whole step."""
        from torch.profiler import ProfilerActivity, profile

        trace = importlib.import_module("gea_torch.utils.trace")
        counters = getattr(trace, "counters", None)
        real = self.input_fn(next(self.data), self.it)
        kept = trace.enable(True, ranges=True)
        trace.reset()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self.step(self.state, real)
                sync(self.run.device)
            spans = {k: v.count for k, v in trace.totals().items()}
            counts = counters() if counters is not None else {}
        finally:
            trace.enable(*kept)
            trace.reset()
        links = self.cfg.r_chain_length
        want = {"riter.links": 2 * links, "riter.renders": 2 * (links + 1)}
        self.run.notes.append(f"chain step: spans {spans}, counters {counts}")
        if any(counts.get(k) != v for k, v in want.items()) or spans.get("riter.link") != 2 * links:
            return {}
        events = list(host_events(prof))
        launched = {c for n, dev, _, _, c in events if not dev and n.startswith("cu") and c}
        kernels = [c for _, dev, _, _, c in events if dev]
        self.run.notes.append(f"chain step: {len(kernels)} device events, "
                              f"{sum(c in launched for c in kernels)} matched to a launch")
        out = {}
        for key, span in (("chain_ms", "riter.link"), ("gr_backward_ms", "riter.gr_backward")):
            got = span_kernel_ms(events, span)
            self.run.notes.append(f"{span}: (device ms, kernels) {got}")
            if got is not None:
                out[key] = got[0]
        return out

    # -- check --------------------------------------------------------------

    def reference_run(self, nx=glis.exact_fp32) -> Dict:
        flags = {**self.run.cell.config["flags"], "r_iterations": 0}
        reals, zs, sns = self.reference_inputs(len(self.prog["metrics"]))
        hp = {"r_chain_length": self.cfg.r_chain_length, "lambda_r": self.cfg.lambda_r,
              "lr": self.cfg.lr, "beta1": self.cfg.beta1, "beta2": self.cfg.beta2}
        with exact_matmuls():
            out = riter.train_steps(self.weights0["g"], self.weights0["d"], self.weights0["r"],
                                    reals, zs, sns, flags, hp, nx)
        out["params0"] = self.weights0
        return out

    def check(self) -> Dict[str, Dict]:
        return with_limits(self.run, compare_riter.train_numbers(self.prog, self.reference_run()))

