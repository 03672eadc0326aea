"""The training loop: the trainers' graphed path, as `TrainLoop._run`
drives it, closed loop.

Set-up builds one G-LIS train state (the port's G and D holding the seed's
weights, Adam for each as `make_optimizer` makes it for chunked steps, the
state's generator seeded with the seed), the step
(`build_glis_train_step`) and its dispatcher (`build_step_fn`), the input
stream (`input_iterator`, `make_input_fn`; the mix's flags choose
`--dataset synthetic --synthetic_on_device true`). It drives that state
through one chunk of `steps_per_dispatch` steps: that captures the graph
that the window replays, and its first replay (steps 1 to K) is what the
check compares: each step's losses, Adam's moments and the parameters
after the chunk.

The window dispatches chunks of K steps, each fed by the input layer,
reads the metrics back at every `log_interval` crossed (as the runner
does, with its non-finite check), and ends with a device synchronise.
`train_images_per_s` is the steps completed times the batch over the
window's seconds.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from portbench import compare, reference
from portbench.loops import build_models, exact_matmuls, phase, sync, with_limits
from portbench.spy import Spy, time_calls
from portbench.tracing import Spans, summarize, traced


class Loop:
    def __init__(self, run):
        self.run = run
        self.mix = run.cell.mix
        self.spans = Spans()

    # -- set-up -------------------------------------------------------------

    def make_config(self):
        from gea_torch.config import TrainGLISConfig

        flags = {**self.run.cell.config["flags"], **self.mix["flags"]}
        return TrainGLISConfig(**flags, seed=self.run.seed, device=self.run.device.type,
                               niter=10 ** 12)

    def setup(self, warm: bool = True) -> None:
        from gea_torch.train import steps
        from gea_torch.train.dispatch import build_step_fn
        from gea_torch.train.runner import input_iterator, make_input_fn
        from gea_torch.train.state import GLISTrainState, chunked, make_optimizer

        run, dev = self.run, self.run.device
        cfg = self.cfg = self.make_config()
        g, d, self.weights0 = build_models(cfg, run.seed, dev)
        phase(run, "models built")
        sched = (cfg.lr_schedule, cfg.niter, cfg.lr_final, chunked(cfg))
        opt_g, sched_g = make_optimizer(g.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
        opt_d, sched_d = make_optimizer(d.parameters(), cfg.lr, cfg.beta1, cfg.beta2, *sched)
        self.state = GLISTrainState(generator=g, discriminator=d, opt_g=opt_g, opt_d=opt_d,
                                    sched_g=sched_g, sched_d=sched_d,
                                    rng=torch.Generator(dev).manual_seed(run.seed))
        self.step = steps.build_glis_train_step(cfg)
        self.fn = build_step_fn(cfg, self.step)
        self.data = input_iterator(cfg, dev, cfg.seed)
        self.input_fn = make_input_fn(cfg, dev)
        self.it = 0
        self.k = cfg.steps_per_dispatch

        # The window's chunk size: its graph is captured here, and its
        # first replay is kept for the check. `warm` has nothing to add.
        m = self.chunk(self.k)
        self.prog = {"metrics": [{key: float(v[i]) for key, v in m.items()}
                                 for i in range(self.k)],
                     "moments": self.moments(),
                     "params": {"g": self.params(g), "d": self.params(d)}}
        phase(run, f"chunk of {self.k} (captured, run, kept)")

    def params(self, module) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in module.named_parameters()}

    def moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Each Adam's first moment; zeros for a parameter that it never
        stepped."""
        out = {}
        for who, module, opt in (("g", self.state.generator, self.state.opt_g),
                                 ("d", self.state.discriminator, self.state.opt_d)):
            out[who] = {n: opt.state[p]["exp_avg"].detach().clone()
                        if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                        for n, p in module.named_parameters()}
        return out

    def chunk(self, k: int) -> Dict[str, torch.Tensor]:
        with self.spans("input"):
            batches = [next(self.data) for _ in range(k)]
            reals = [self.input_fn(b, self.it + i) for i, b in enumerate(batches)]
        with self.spans("dispatch"):
            m = self.fn(self.state, reals)
        self.it += k
        return m

    # -- window -------------------------------------------------------------

    def drive(self, seconds: float) -> Dict:
        """Chunks for `seconds`, the metrics read back at every log interval
        crossed, then a synchronise: (steps, seconds, non-finite steps)."""
        interval = int(self.mix["flags"].get("log_interval", 50))
        start_it, bad = self.it, 0
        t0 = time.perf_counter()
        while True:
            prev = self.it
            m = self.chunk(self.k)
            if interval > 0 and self.it // interval > prev // interval:
                with self.spans("readback"):
                    hist = {key: v.tolist() for key, v in m.items()}
                bad += sum(1 for i in range(self.k)
                           if not all(abs(hist[key][i]) < float("inf") for key in hist))
            if time.perf_counter() - t0 >= seconds:
                break
        with self.spans("readback"):
            sync(self.run.device)
        return {"steps": self.it - start_it, "seconds": time.perf_counter() - t0, "bad": bad}

    def window(self) -> None:
        run = self.run
        self.spans.reset()
        out = self.drive(run.seconds)
        run.window_s = out["seconds"]
        run.counts["steps"] = out["steps"]
        run.counts["batch"] = self.cfg.batch_size
        run.attempted, run.failed = out["steps"], out["bad"]
        run.spans = dict(self.spans.seconds)
        run.end_to_end["train_images_per_s"] = out["steps"] * self.cfg.batch_size / out["seconds"]
        run.notes.append(f"window: {out['steps']} steps in {out['seconds']:.3f} s; host ms a step "
                         + " ".join(f"{k} {v / out['steps'] * 1e3:.3f}"
                                    for k, v in sorted(self.spans.seconds.items())))

    def traced_segment(self) -> None:
        spans = Spans()
        self.spans, kept = spans, self.spans
        with traced(spans, lambda: sync(self.run.device)) as got:
            out = self.drive(float(self.mix["trace_seconds"]))
        self.spans = kept
        self.run.trace_summary = summarize(got[0], units=out["steps"])

    def time_kernel_calls(self) -> None:
        """One eager step of the same state under the spy; each call timed."""
        real = self.input_fn(next(self.data), self.it)
        with Spy() as spy:
            self.step(self.state, real)
            sync(self.run.device)
        self.run.kernel_calls = time_calls(spy.calls)

    def release(self) -> None:
        del self.state, self.fn, self.step, self.data, self.input_fn
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- check --------------------------------------------------------------

    def reference_inputs(self, steps: int):
        """The first `steps` steps' real batches, codes and spatial noise,
        made again from the seed: the synthetic batch of each step, and z
        then the noise drawn in order from a generator seeded as the
        state's."""
        cfg, dev = self.cfg, self.run.device
        gen = torch.Generator(dev).manual_seed(self.run.seed)
        side = 2 * (cfg.image_size // 2 ** reference.glis.plan(cfg.image_size)[1])
        reals, zs, sns = [], [], []
        for i in range(steps):
            reals.append(reference.synthetic_reals(self.run.seed, i, cfg.batch_size,
                                                   cfg.image_size, dev))
            zs.append(torch.randn((cfg.batch_size, cfg.code_size), generator=gen, device=dev))
            sns.append(torch.randn((cfg.batch_size, side, side, cfg.spatial_code), generator=gen,
                                   device=dev) if cfg.spatial_code else None)
        return reals, zs, sns

    def reference_run(self, nx=reference.exact_fp32) -> Dict:
        flags = self.run.cell.config["flags"]
        reals, zs, sns = self.reference_inputs(len(self.prog["metrics"]))
        with exact_matmuls():
            out = reference.train_steps(self.weights0["g"], self.weights0["d"], reals, zs, sns,
                                        flags, flags, nx)
        out["params0"] = self.weights0
        return out

    def check(self) -> Dict[str, Dict]:
        return with_limits(self.run, compare.train_numbers(self.prog, self.reference_run()))
