"""The filtered-sampling loop: error-avoidance sampling of a trained G-LIS
as `export_model --with_scores 1 --all_stages 0` serves it, minus the
export step.

Set-up builds the port's G and D holding the seed's weights and serves
them with `ServingModel.from_modules(G, D, all_stages=False)`; it warms
every shape with the mix's `warm_requests` requests.

The window is one caller in a closed loop: request i is
`sample_filtered(count, seed=seed + i, batch_size, oversample)`, that is
`count * oversample` candidates rendered in batches of `batch_size`
through `stream`, scored by D, and the `count` best returned. A request
that raises or returns another count has failed, and misses the tail.
`filtered_images_per_s` is the images delivered over the window's
seconds; `request_p95_ms.filter` (a per-layer metric of the same window)
the 95th percentile of every request's time from its call to its return,
a failed one counting as infinite.

A sample of the window's requests, `checked_requests` of them drawn from
the seed, is kept for the check: after the window the reference renders
every candidate of each from the same codes (numpy's generator seeded as
the request, as `gea` draws them) and holds the answer to it.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, reference
from portbench.loops import build_models, exact_matmuls, phase, sync, with_limits
from portbench.spy import Spy, time_calls
from portbench.tracing import Spans, summarize, traced


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Loop:
    def __init__(self, run):
        self.run = run
        self.mix = run.cell.mix
        self.spans = Spans()
        self.kept: List = []

    def setup(self, warm: bool = True) -> None:
        from gea_torch.config import ModelConfig
        from gea_torch.serve import ServingModel

        run = self.run
        flags = run.cell.config["flags"]
        names = set(ModelConfig.__dataclass_fields__)
        self.cfg = ModelConfig(**{k: v for k, v in flags.items() if k in names})
        g, d, self.weights = build_models(self.cfg, run.seed, run.device)
        self.model = ServingModel.from_modules(g, d, all_stages=False)
        self.spy_on_serving()
        phase(run, "models built")
        for i in range(int(self.mix["warm_requests"]) if warm else 0):
            self.request(self.warm_seed(i))
            phase(run, f"warm request {i}")

    def spy_on_serving(self) -> None:
        """Host spans around the serving front's calls, on this instance and
        on `gea_torch.serve`'s fetch (put back by `release`): "sample" (the
        codes' draw, the renders and their join), "enqueue" (each
        `dispatch`), "fetch" (each wait for a render's copy to the host);
        the rest of a request is the top-k choice."""
        from gea_torch import serve

        model = self.model
        dispatch, sample, fetch = model.dispatch, model.sample, serve._fetch
        self._fetch = fetch

        def spanned(name, fn):
            def call(*args, **kw):
                with self.spans(name):
                    return fn(*args, **kw)
            return call

        model.dispatch = spanned("enqueue", dispatch)
        model.sample = spanned("sample", sample)
        serve._fetch = spanned("fetch", fetch)

    def warm_seed(self, i: int) -> int:
        return self.run.seed + 10 ** 9 + i

    def request(self, seed: int) -> Dict[str, np.ndarray]:
        m = self.mix
        return self.model.sample_filtered(int(m["count"]), seed=seed,
                                          batch_size=int(m["batch_size"]),
                                          oversample=int(m["oversample"]))

    def drive(self, seconds: float, first: int, keep: bool) -> Dict:
        """Requests first, first + 1, ... for `seconds`: their latencies
        (inf where failed) and the kept sample (a reservoir drawn from the
        seed)."""
        count = int(self.mix["count"])
        k = int(self.mix["checked_requests"])
        pick = random.Random(self.run.seed)
        lat: List[float] = []
        t0 = time.perf_counter()
        i = 0
        while True:
            seed = self.run.seed + first + i
            ts = time.perf_counter()
            try:
                with self.spans("request"):
                    out = self.request(seed)
                ok = out["images"].shape[0] == count and out["scores"].shape[0] == count
            except Exception as e:  # a failed request is counted, and misses the tail
                print(f"portbench: request {seed} failed: {e!r}", flush=True)
                out, ok = None, False
            lat.append(time.perf_counter() - ts if ok else math.inf)
            if keep and out is not None:
                if len(self.kept) < k:
                    self.kept.append((seed, out))
                else:
                    j = pick.randrange(i + 1)
                    if j < k:
                        self.kept[j] = (seed, out)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.run.device)
        return {"latencies": lat, "seconds": time.perf_counter() - t0, "requests": i}

    def window(self) -> None:
        run, m = self.run, self.mix
        self.spans.reset()
        out = self.drive(run.seconds, 0, keep=True)
        ok = [x for x in out["latencies"] if x < math.inf]
        run.window_s = out["seconds"]
        run.attempted, run.failed = out["requests"], out["requests"] - len(ok)
        run.counts.update(requests=out["requests"], delivered=len(ok) * int(m["count"]),
                          candidates=out["requests"] * int(m["count"]) * int(m["oversample"]),
                          renders=self.spans.counts.get("enqueue", 0))
        run.spans = dict(self.spans.seconds)
        run.end_to_end["filtered_images_per_s"] = len(ok) * int(m["count"]) / out["seconds"]
        run.counts["request_p95_ms"] = percentile(out["latencies"], 95) * 1e3
        per = {k: v / out["requests"] * 1e3 for k, v in self.spans.seconds.items()}
        lat_ms = " ".join(f"p{q} {percentile(out['latencies'], q) * 1e3:.2f}"
                          for q in (50, 90, 95, 100))
        run.notes.append(f"window: {out['requests']} requests, ms {lat_ms}; host ms a request "
                         + " ".join(f"{k} {v:.2f}" for k, v in sorted(per.items())))

    def traced_segment(self) -> None:
        spans = Spans()
        self.spans, kept = spans, self.spans
        with traced(spans, lambda: sync(self.run.device)) as got:
            out = self.drive(float(self.mix["trace_seconds"]), 10 ** 6, keep=False)
        self.spans = kept
        self.run.trace_summary = summarize(got[0], units=out["requests"])

    def time_kernel_calls(self) -> None:
        """One request under the spy; each call timed."""
        with Spy() as spy:
            self.request(self.warm_seed(0))
            sync(self.run.device)
        self.run.kernel_calls = time_calls(spy.calls)

    def release(self) -> None:
        from gea_torch import serve

        serve._fetch = self._fetch
        del self.model
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- check --------------------------------------------------------------

    def codes(self, seed: int):
        """The request's candidates' codes and spatial noise, drawn again:
        numpy's generator seeded with the request's seed, batch by batch,
        z then the noise."""
        m, cfg = self.mix, self.cfg
        n_cand = int(m["count"]) * int(m["oversample"])
        rng = np.random.default_rng(seed)
        zs, sns = [], []
        side = 2 * (cfg.image_size // 2 ** reference.glis.plan(cfg.image_size)[1])
        done = 0
        while done < n_cand:
            n = min(int(m["batch_size"]), n_cand - done)
            zs.append(rng.standard_normal((n, cfg.code_size)).astype(np.float32))
            if cfg.spatial_code > 0:
                sns.append(rng.standard_normal((n, side, side, cfg.spatial_code))
                           .astype(np.float32))
            done += n
        z = torch.from_numpy(np.concatenate(zs)).to(self.run.device)
        sn = (torch.from_numpy(np.concatenate(sns)).to(self.run.device) if sns else None)
        return z, sn

    def candidates(self, seed: int, nx=reference.exact_fp32, block: int = 256):
        """(uint8 images, scores) of every candidate of the request, by the
        reference, in blocks."""
        flags = self.run.cell.config["flags"]
        z, sn = self.codes(seed)
        imgs, scores = [], []
        with torch.no_grad(), exact_matmuls():
            for s in range(0, z.shape[0], block):
                x = reference.render_final(self.weights["g"], z[s:s + block],
                                           None if sn is None else sn[s:s + block], flags, nx)
                imgs.append(reference.to_uint8(x))
                scores.append(reference.score(self.weights["d"], x, flags, nx))
        return torch.cat(imgs), torch.cat(scores)

    def numbers_of(self, images, scores, seed: int) -> Dict[str, float]:
        ref_imgs, ref_scores = self.candidates(seed)
        dev = self.run.device
        return compare.filter_numbers(torch.as_tensor(np.asarray(images)).to(dev),
                                      torch.as_tensor(np.asarray(scores)).to(dev),
                                      ref_imgs, ref_scores, int(self.mix["count"]))

    def check(self) -> Dict[str, Dict]:
        worst: Dict[str, float] = {}
        if not self.kept:
            worst = {"structure": math.inf}
        for seed, out in self.kept:
            for k, v in self.numbers_of(out["images"], out["scores"], seed).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return with_limits(self.run, worst)

    def control(self, seed: int) -> Dict[str, float]:
        """The reference in fp8 in the program's place, on request `seed`."""
        imgs, scores = self.candidates(seed, reference.Numerics(fp8=True))
        top = reference.top_k(scores, int(self.mix["count"]))
        return self.numbers_of(imgs[top].cpu(), scores[top].cpu(), seed)
