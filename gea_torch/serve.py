"""Serving of the port (port of `gea/serve.py`): an exported artifact, or the
live modules, rendered with D-filtered (error-avoidance) sampling.

An artifact is a directory that `python -m gea_torch.cli.export_model`
writes: a `torch.export` program (`model.pt2`, the weights inside) and
`manifest.json`. Loading it needs this package's kernels (`gea_torch.ops`,
whose custom ops the program calls) and no model code, run directory or
config:

    from gea_torch import serve
    model = serve.load("exports/glis3_80")          # on the card
    out = model(z)                      # dict: images[, stages][, scores]
    imgs = model.sample(64, seed=0)["images"]       # uint8 (64, H, W, 3)
    best = model.sample_filtered(64, oversample=4)  # top 64 of 256 by D
    for out in model.stream(z_batches):             # pipelined
        ...

`ServingModel.from_modules(generator, discriminator)` serves the live
modules through the same function that `export_model` traces, so a live
render and an artifact's compute the same thing.

The program takes a batch of any size unless it was exported with a pinned
one (`manifest["batch"]` > 0). z (and spatial noise) come in as numpy and
the outputs go back as numpy; z is drawn on the host with numpy exactly as
`gea` draws it, so both packages render the same codes from the same seed.
On the card each batch is copied in from pinned memory, rendered on the
current stream and copied back into pinned memory without a wait, and an
event recorded after the copy says when it has landed: `stream` keeps up to
`depth` batches in flight that way.

What crosses to the host differs by path. `__call__`, `stream` and
`sample` copy every output of every row back. `sample_filtered` copies
back only each render's scores: it chooses the winners from them with
numpy, gathers the winners' images (and stages) on the card, and copies
the `count` winners back once, into one pinned block. The HTTP server's
filtered path renders through its batcher and chooses on the host, by the
same rule (`top_order`).

With `gea_torch.utils.trace` on, a request's host time is split into
spans: `serve.draw` (each batch's codes), `serve.stage_in` (pinned copies
to the card), `serve.render` (the render's launch), `serve.stage_out` (the
copies back and their event: on the filtered path the scores' alone),
`serve.join` (`sample`'s batches joined and cut), `serve.topk` (a round's
choice, and on the filtered path the enqueue of its gather) and
`serve.gather` (the filtered winners' copy back and its event).

`model.sharded()` serves the same program data-parallel
(`DataParallelServingModel`): one replica a card, the batch split over
them.
"""

from __future__ import annotations

import copy
import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from gea_torch.config import resolve_device
from gea_torch.models import Discriminator, GeneratorLIS, Reverter
from gea_torch.models.reverter import blend_correction, iterative_chain
from gea_torch.utils import trace

ARTIFACT = "model.pt2"
MANIFEST = "manifest.json"
PLATFORMS = ("cuda", "cpu")


def _axis(key: str) -> int:
    """An output's batch axis: stages are (S, B, ...), the rest (B, ...)."""
    return 1 if key == "stages" else 0


def _take(out: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    """Select candidate indices from a render dict (stages are (S, B, ...))."""
    return {k: (v[:, idx] if k == "stages" else v[idx]) for k, v in out.items()}


def _cat(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]):
    return {k: np.concatenate([a[k], b[k]], axis=_axis(k)) for k in a}


def top_order(scores: np.ndarray, count: int) -> np.ndarray:
    """The rows of the `count` best scores, best first: the one choice rule
    of every filtered path, so that ties resolve alike on all of them."""
    return np.argsort(scores)[::-1][:count]


def topk_rounds(draw, count: int, threshold: float = 0.0, max_rounds: int = 1):
    """Call ``draw(round)`` for fresh candidate dicts (with "scores"), keep a
    running top-``count`` by descending score, and stop once every kept
    sample clears ``threshold`` (or after ``max_rounds``). Returns
    (best, rounds_run); ``best`` is sorted by descending score. The HTTP
    server's filtered path, on host dicts; `ServingModel.sample_filtered`
    makes the same choice with the images left on the device."""
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    best: Optional[Dict[str, np.ndarray]] = None
    rounds = 0
    for r in range(1 if threshold <= 0 else max_rounds):
        out = draw(r)
        with trace.span("serve.topk"):
            best = out if best is None else _cat(best, out)
            best = _take(best, top_order(best["scores"], count))
        rounds = r + 1
        if threshold <= 0 or (best["scores"] >= threshold).all():
            break
    if best is None:
        raise RuntimeError("topk_rounds drew no candidates")
    return best, rounds


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255], clipped, with a truncating cast."""
    return ((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


class ServeFunction(nn.Module):
    """What an artifact computes: z (B, code) [, spatial noise] ->

      images  uint8 (B, H, W, 3)        the final stage
      stages  uint8 (S, B, H, W, 3)     every stage (`all_stages`)
      scores  float32 (B,)              sigmoid D realism of the final stage

    The stages are G's LIS stages, rendered from z after `correction`'s
    R-separate steps (z <- blend(z, R(G(z))), as `gea`'s `--r_path`
    export), or with `chain_links` the links of R-iterative's chain
    z_t = z_{t-1} + R(G(z_{t-1})) (`gea`'s `--ri_path`)."""

    def __init__(self, generator: GeneratorLIS, discriminator: Optional[Discriminator] = None,
                 reverter: Optional[Reverter] = None, correction: Optional[dict] = None,
                 chain_links: Optional[int] = None, all_stages: bool = True):
        super().__init__()
        if (correction is not None or chain_links is not None) and reverter is None:
            raise ValueError("a correction or a chain needs a reverter")
        if correction is not None and chain_links is not None:
            raise ValueError("a correction and a chain are exclusive")
        self.generator = generator.eval()
        self.discriminator = None if discriminator is None else discriminator.eval()
        self.reverter = None if reverter is None else reverter.eval()
        self.correction = correction
        self.chain_links = chain_links
        self.all_stages = all_stages

    def describe(self) -> dict:
        """The manifest's keys that this function fixes."""
        g = self.generator
        sn = g.spatial_noise_shape(1)
        if self.chain_links is not None:
            n_stages = self.chain_links + 1
        else:
            n_stages = g.cfg.r_iterations + 1
        return {
            "code_size": g.cfg.code_size,
            "image_size": g.cfg.image_size,
            "n_stages": n_stages,
            "spatial_code": g.cfg.spatial_code,
            "spatial_noise_shape": list(sn[1:]) if sn else None,
            "outputs": ["images"] + (["stages"] if self.all_stages else [])
            + (["scores"] if self.discriminator is not None else []),
        }

    def forward(self, z: torch.Tensor, spatial_noise: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        g = self.generator
        if self.chain_links is not None:
            images = iterative_chain(g, self.reverter, z, spatial_noise, self.chain_links)
        else:
            for _ in range(self.correction["steps"] if self.correction else 0):
                z_hat = self.reverter(g.render(z, spatial_noise)[0][-1])
                z = blend_correction(z, z_hat, self.correction["strength"],
                                     self.correction["shell_renorm"])
            images = g.render(z, spatial_noise)[0]
        out = {"images": to_uint8(images[-1])}
        if self.all_stages:
            out["stages"] = to_uint8(images)
        if self.discriminator is not None:
            out["scores"] = torch.sigmoid(self.discriminator(images[-1])).float()
        return out


def write_artifact(out_dir: str, exported, manifest: Dict[str, Any]) -> int:
    """Write the program (a `torch.export.ExportedProgram`) and the manifest;
    returns the program's size in bytes."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ARTIFACT)
    torch.export.save(exported, path)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return os.path.getsize(path)


class _Fetch:
    """An output on its way to the host: `np.asarray` waits for the event
    recorded after its copy (on the CPU there is none)."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event=None):
        self.host = host
        self.event = event

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        a = self.host.numpy()
        return a if dtype is None else a.astype(dtype)


class _Joined:
    """An output rendered in parts on several replicas: `np.asarray` waits
    for every part and joins them along the batch axis, cut to `n` rows
    (the padding off)."""

    __slots__ = ("parts", "axis", "n")

    def __init__(self, parts: list, axis: int, n: int):
        self.parts, self.axis, self.n = parts, axis, n

    def __array__(self, dtype=None, copy=None):
        a = np.concatenate([np.asarray(p) for p in self.parts], axis=self.axis)
        a = a[:, :self.n] if self.axis else a[:self.n]
        return a if dtype is None else a.astype(dtype)


class _Parts:
    """An output left on the replicas' devices: `tensors[i]` was rendered on
    `streams[i]` (None: the current stream), `per` rows each; the batch's
    rows run in replica order, the padding last."""

    __slots__ = ("tensors", "streams", "per")

    def __init__(self, tensors: list, streams: list, per: int):
        self.tensors, self.streams, self.per = tensors, streams, per


def _fetch(out: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in out.items()}


def _enqueue(fn, device: torch.device, args: List[np.ndarray],
             to_host: Optional[tuple] = None) -> Dict[str, Any]:
    """Render `args` with `fn` on `device` without waiting, on the current
    stream: on the card the inputs come in from pinned memory and the
    outputs named in `to_host` (every one where None) go back into pinned
    memory, with an event recorded after the copy; the others stay on
    `device` as tensors."""
    cuda = device.type == "cuda"
    with torch.inference_mode():
        with trace.span("serve.stage_in"):
            if cuda:
                tensors = [torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
                           for a in args]
            else:
                tensors = [torch.from_numpy(a).to(device) for a in args]
        with trace.span("serve.render"):
            out = fn(*tensors)
        with trace.span("serve.stage_out"):
            sent = [k for k in out if to_host is None or k in to_host]
            event = None
            if cuda:
                host = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=True)
                        .copy_(out[k], non_blocking=True) for k in sent}
                event = torch.cuda.Event()
                event.record()
            else:
                host = {k: out[k] for k in sent}
    return {k: _Fetch(host[k], event) if k in host else v for k, v in out.items()}


def _on_device(out: Dict[str, Any], rows: int) -> list:
    """A render's outputs that stayed on the device, as sources of
    `_gather`: (tensors, rows, stream) for each device that holds some of
    its first `rows` rows."""
    keys = [k for k, v in out.items() if isinstance(v, (torch.Tensor, _Parts))]
    first = out[keys[0]]
    if isinstance(first, torch.Tensor):
        return [({k: out[k] for k in keys}, rows, None)]
    return [({k: out[k].tensors[i] for k in keys}, min(first.per, rows - i * first.per), s)
            for i, s in enumerate(first.streams) if rows > i * first.per]


def _index(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Row numbers as an index on `device`, copied in without a wait."""
    t = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def _gather(sources: list, order: np.ndarray, device: torch.device) -> Dict[str, torch.Tensor]:
    """Rows `order` of `sources` ((tensors, rows, stream) each, their rows
    laid end to end), in that order, gathered with `index_select` on the
    sources' devices into tensors on `device` that its current stream may
    use. Nothing waits for the device."""
    device = _indexed(device)
    starts = np.cumsum([0] + [n for _, n, _ in sources])
    which = np.searchsorted(starts, order, side="right") - 1
    pieces, slots = [], []
    with torch.inference_mode():
        for j, (tensors, _, stream) in enumerate(sources):
            slot = np.flatnonzero(which == j)
            if not slot.size:
                continue
            with torch.cuda.stream(stream):  # a no-op for None
                idx = _index(order[slot] - starts[j], next(iter(tensors.values())).device)
                piece = {k: v.index_select(_axis(k), idx).to(device, non_blocking=True)
                         for k, v in tensors.items()}
            if stream is not None:
                current = torch.cuda.current_stream(device)
                current.wait_stream(stream)
                for v in piece.values():
                    v.record_stream(current)
            pieces.append(piece)
            slots.append(slot)
        back = _index(np.argsort(np.concatenate(slots)), device)
        return {k: torch.cat([p[k] for p in pieces], _axis(k)).index_select(_axis(k), back)
                for k in pieces[0]}


def _to_host(tensors: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, _Fetch]:
    """Copy `tensors` (on `device`) into one fresh block of host memory,
    pinned and from torch's caching host allocator on the card, behind one
    event; the caller owns the block."""
    cuda = device.type == "cuda"
    sizes = [-(-v.nbytes // 64) * 64 for v in tensors.values()]  # each part 64-byte aligned
    block = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=cuda)
    host, at = {}, 0
    with torch.inference_mode():
        for (k, v), size in zip(tensors.items(), sizes):
            host[k] = block[at:at + v.nbytes].view(v.dtype).view(v.shape).copy_(
                v, non_blocking=cuda)
            at += size
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(_indexed(device)))
    return {k: _Fetch(v, event) for k, v in host.items()}


class ServingModel:
    """Renders z into a dict of numpy arrays (see `ServeFunction`).

    `exported` is a `torch.export.ExportedProgram` (`load`) or a callable
    module that takes tensors on `device` (`from_modules`); `manifest`
    holds the call's contract: code_size, batch (0 = any),
    spatial_noise_shape, outputs, gan_loss."""

    def __init__(self, exported, manifest: Dict[str, Any],
                 device: str | torch.device = "cuda"):
        self.exported = exported
        self.manifest = manifest
        self.device = torch.device(device)
        self._fn = (exported.module() if isinstance(exported, torch.export.ExportedProgram)
                    else exported)

    @classmethod
    def from_modules(cls, generator: GeneratorLIS,
                     discriminator: Optional[Discriminator] = None, *,
                     reverter: Optional[Reverter] = None, correction: Optional[dict] = None,
                     chain_links: Optional[int] = None, all_stages: bool = True,
                     gan_loss: Optional[str] = None) -> "ServingModel":
        """Serve live modules through the `ServeFunction` that `export_model`
        traces; every stage is an output unless `all_stages` is False."""
        fn = ServeFunction(generator, discriminator, reverter, correction, chain_links,
                           all_stages)
        manifest = {**fn.describe(), "batch": 0,
                    "gan_loss": gan_loss or getattr(generator.cfg, "gan_loss", "bce")}
        return cls(fn, manifest, device=generator.device)

    @property
    def code_size(self) -> int:
        return int(self.manifest["code_size"])

    @property
    def image_size(self) -> int:
        return int(self.manifest["image_size"])

    @property
    def spatial_noise_shape(self) -> Optional[tuple]:
        sn = self.manifest.get("spatial_noise_shape")
        return tuple(sn) if sn else None

    def _inputs(self, z, spatial_noise) -> List[np.ndarray]:
        """The call's arguments as float32 arrays, checked against the
        manifest."""
        z = np.ascontiguousarray(z, np.float32)
        if z.ndim != 2 or z.shape[1] != self.code_size:
            raise ValueError(f"z must be (batch, {self.code_size}), got {z.shape}")
        fixed = int(self.manifest.get("batch", 0))
        if fixed and z.shape[0] != fixed:
            raise ValueError(f"this artifact was exported with a pinned batch of {fixed} "
                             f"(manifest['batch']); got {z.shape[0]}")
        if self.spatial_noise_shape is None:
            if spatial_noise is not None:
                raise ValueError("this artifact takes no spatial noise")
            return [z]
        if spatial_noise is None:
            raise ValueError("this run was trained with --spatial_code; pass spatial_noise "
                             f"of shape (batch, *{self.spatial_noise_shape})")
        sn = np.ascontiguousarray(spatial_noise, np.float32)
        if sn.shape != (z.shape[0], *self.spatial_noise_shape):
            raise ValueError(f"spatial_noise must be {(z.shape[0], *self.spatial_noise_shape)}, "
                             f"got {sn.shape}")
        return [z, sn]

    def dispatch(self, z: np.ndarray, spatial_noise: Optional[np.ndarray] = None, *,
                 to_host: Optional[tuple] = None) -> Dict[str, Any]:
        """Check and enqueue one render without waiting for it: returns the
        outputs as array-likes that `np.asarray` turns into numpy once their
        copy to the host has landed. The pipelining primitive of `stream`
        and of the HTTP batcher; `__call__` is dispatch and fetch. Only the
        outputs named in `to_host` (every one where None) are copied to the
        host; the others stay on the device as tensors."""
        return _enqueue(self._fn, self.device, self._inputs(z, spatial_noise), to_host)

    def __call__(self, z: np.ndarray, spatial_noise: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
        return _fetch(self.dispatch(z, spatial_noise))

    def stream(self, z_iter, depth: int = 8):
        """Yield one output dict per z batch, in order, with up to `depth`
        batches in flight. `z_iter` yields z arrays, or (z, spatial_noise)
        pairs for a --spatial_code artifact."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        q: deque = deque()
        for item in z_iter:
            # Retire before enqueueing once the window is full, so that at
            # most `depth` batches are ever in flight.
            if len(q) >= depth:
                yield _fetch(q.popleft())
            z, sn = item if isinstance(item, tuple) else (item, None)
            q.append(self.dispatch(z, sn))
        while q:
            yield _fetch(q.popleft())

    def sharded(self, devices=None) -> "DataParallelServingModel":
        """Data-parallel serving (`gea`'s `sharded`): the same program on
        every device of `devices`, one replica each, with each batch split
        over them. Rendering is parallel over samples, so no collective is
        needed. By default every visible card (the model's own device on
        the CPU)."""
        return DataParallelServingModel(self, devices)

    def _draws(self, count: int, seed: int, batch_size: int):
        """(z, spatial noise or None) for `count` samples, drawn with numpy
        from `seed` batch by batch as `gea` draws them; a pinned artifact
        draws whole batches."""
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        fixed = int(self.manifest.get("batch", 0))
        rng = np.random.default_rng(seed)

        def gen():
            done = 0
            while done < count:
                n = fixed or min(batch_size, count - done)
                # The span closes before the yield: the render runs outside it.
                with trace.span("serve.draw"):
                    z = rng.standard_normal((n, self.code_size)).astype(np.float32)
                    sn = (None if self.spatial_noise_shape is None else rng.standard_normal(
                        (n, *self.spatial_noise_shape)).astype(np.float32))
                yield z, sn
                done += n

        return gen()

    def sample(self, count: int, seed: int = 0, batch_size: int = 64
               ) -> Dict[str, np.ndarray]:
        """Draw z ~ N(0, 1) with numpy and render `count` samples in batches
        through `stream`; a pinned artifact renders whole batches and the
        result is cut to `count`."""
        chunks = list(self.stream(self._draws(count, seed, batch_size)))
        out = {}
        with trace.span("serve.join"):
            for k in chunks[0]:
                v = np.concatenate([c[k] for c in chunks], axis=_axis(k))
                out[k] = v[:, :count] if _axis(k) else v[:count]
        return out

    def _candidates(self, count: int, seed: int, batch_size: int):
        """Render `count` candidates drawn as `sample` draws them, each batch
        drawn while the one before renders, and wait for their scores alone:
        returns (scores, sources of `_gather` for the other outputs)."""
        renders, done = [], 0
        for z, sn in self._draws(count, seed, batch_size):
            rows = min(z.shape[0], count - done)
            renders.append((self.dispatch(z, sn, to_host=("scores",)), rows))
            done += rows
        scores = np.concatenate([_fetch({"scores": out["scores"]})["scores"][:rows]
                                 for out, rows in renders])
        return scores, [s for out, rows in renders for s in _on_device(out, rows)]

    def sample_filtered(
        self,
        count: int,
        seed: int = 0,
        batch_size: int = 64,
        oversample: int = 4,
        threshold: float = 0.0,
        max_rounds: int = 20,
    ) -> Dict[str, np.ndarray]:
        """Error-avoidance sampling: render ``oversample * count``
        candidates, score each with the discriminator and return the
        ``count`` best, sorted by descending score. With ``threshold`` > 0,
        rounds are drawn until ``count`` clear it (at most ``max_rounds``; a
        shortfall is filled from the best rejects with a notice). The
        absolute cutoff assumes BCE-calibrated sigmoid scores: on a hinge or
        WGAN-GP run it prints a warning (the top-k ranking holds).

        Only the candidates' scores cross to the host, a render at a time;
        each round's winners are chosen from them by `top_order` and
        gathered on the device, from the round's renders and the winners
        kept from the rounds before, and the ``count`` winners are copied
        to the host once, into one block that the caller owns. The result
        is the same, bit for bit, as `topk_rounds` over `sample`'s renders."""
        if "scores" not in self.manifest.get("outputs", ()):
            raise ValueError(
                "this model carries no discriminator scores; export the run with "
                "--with_scores 1 (or serve the modules with a discriminator) to enable "
                "filtered sampling"
            )
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if oversample < 1:
            raise ValueError(f"oversample must be >= 1, got {oversample}")
        if max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        gan_loss = self.manifest.get("gan_loss", "bce")
        if threshold > 0 and gan_loss != "bce":
            print(f"[gea_torch.serve] warning: artifact was trained with gan_loss={gan_loss}; "
                  "its scores are sigmoid(margin), not calibrated probabilities — "
                  f"d_threshold={threshold} is an arbitrary cutoff (top-k ranking is "
                  "unaffected)")
        n_cand = int(count * oversample)
        scores, best, rounds = None, None, 0
        for r in range(1 if threshold <= 0 else max_rounds):
            got, sources = self._candidates(n_cand, seed + r, batch_size)
            with trace.span("serve.topk"):
                if best is not None:  # the kept winners first, as `topk_rounds` joins them
                    got = np.concatenate([scores, got])
                    sources = [(best, scores.size, None)] + sources
                order = top_order(got, count)
                scores, best = got[order], _gather(sources, order, self.device)
            del sources  # the round's renders go before the next round's come
            rounds = r + 1
            if threshold <= 0 or (scores >= threshold).all():
                break
        with trace.span("serve.gather"):
            host = _to_host(best, self.device)
        out = {**_fetch(host), "scores": scores}
        if threshold > 0:
            cleared = int((scores >= threshold).sum())
            if cleared < count:
                print(
                    f"[gea_torch.serve] d_threshold={threshold}: only "
                    f"{cleared}/{count} candidates cleared it after {rounds} "
                    "rounds; filling from the best rejects"
                )
        return out


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its index: "cuda" is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DataParallelServingModel(ServingModel):
    """A ServingModel whose renders are split over replicas, one a device,
    each on a stream of its own (port of `gea`'s `DataParallelServingModel`).

    A batch is zero-padded up to a multiple of the replica count, split,
    rendered on every replica without a wait, gathered on the host and
    trimmed, so any batch size works; `__call__`, `stream`, `sample` and
    `sample_filtered` all route through `dispatch`. A pinned program
    renders its own batch only, so a pinned artifact needs the pinned size
    to split evenly, as in `gea`, and one replica: its replicas would get
    a slab of another size."""

    def __init__(self, base: ServingModel, devices=None):
        super().__init__(base.exported, base.manifest, device=base.device)
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if base.device.type == "cuda" else [base.device])
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices for data-parallel serving")
        n = len(self.devices)
        fixed = int(self.manifest.get("batch", 0))
        if fixed and fixed % n:
            raise ValueError(f"pinned batch {fixed} is not divisible by {n} devices")
        if fixed and n > 1:
            raise ValueError(f"a program pinned at batch {fixed} renders {fixed} rows only, and "
                             f"each of {n} replicas would get {fixed // n}: export with a "
                             "symbolic batch (export_model --batch 0) to serve it on "
                             f"{n} devices")
        self.replicas = [(dev, self._replica(base, dev),
                          torch.cuda.Stream(dev) if dev.type == "cuda" else None)
                         for dev in self.devices]

    @staticmethod
    def _replica(base: ServingModel, dev: torch.device):
        """The base's callable on `dev`: itself there, else a copy moved."""
        if _indexed(dev) == _indexed(base.device):
            return base._fn
        if isinstance(base.exported, torch.export.ExportedProgram):
            from torch.export.passes import move_to_device_pass

            return move_to_device_pass(base.exported, str(dev)).module()
        return copy.deepcopy(base._fn).to(dev)

    def dispatch(self, z: np.ndarray, spatial_noise: Optional[np.ndarray] = None, *,
                 to_host: Optional[tuple] = None) -> Dict[str, Any]:
        args = self._inputs(z, spatial_noise)
        b, n = args[0].shape[0], len(self.replicas)
        pad = (-b) % n
        if pad:
            args = [np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)]) for a in args]
        per = (b + pad) // n
        parts = []
        for i, (dev, fn, stream) in enumerate(self.replicas):
            slab = [np.ascontiguousarray(a[i * per:(i + 1) * per]) for a in args]
            if stream is None:
                parts.append(_enqueue(fn, dev, slab, to_host))
                continue
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                parts.append(_enqueue(fn, dev, slab, to_host))
        streams = [s for _, _, s in self.replicas]
        return {k: _Joined([p[k] for p in parts], _axis(k), b) if isinstance(parts[0][k], _Fetch)
                else _Parts([p[k] for p in parts], streams, per) for k in parts[0]}


def load(path: str, device: str | torch.device = "cuda") -> ServingModel:
    """Load an exported run directory (or the path of its `model.pt2`) onto
    `device`: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        art, man = os.path.join(path, ARTIFACT), os.path.join(path, MANIFEST)
    else:
        art, man = path, os.path.join(os.path.dirname(path), MANIFEST)
    if not os.path.exists(art):
        raise FileNotFoundError(
            f"no exported model at {art!r} — create one with "
            "`python -m gea_torch.cli.export_model --load_path <run> --out <dir>`"
        )
    if not os.path.exists(man):
        # Without the manifest there is no code_size/batch/spatial-noise
        # contract, and every later call would fail opaquely.
        raise FileNotFoundError(f"missing manifest at {man!r} — keep {MANIFEST} next to the "
                                "artifact (export_model writes both)")
    with open(man) as f:
        manifest: Dict[str, Any] = json.load(f)
    if dev.type not in manifest.get("platforms", ()):
        raise ValueError(f"{path!r} was exported for {manifest.get('platforms')}, not "
                         f"{dev.type} (export_model --platforms)")
    from torch.export.passes import move_to_device_pass

    exported = move_to_device_pass(torch.export.load(art), str(dev))
    return ServingModel(exported, manifest, device=dev)


def _main(argv=None) -> List[str]:
    """Render a grid (and the scores) straight from an artifact:

        python -m gea_torch.serve exports/glis3_80 --count 64 --out samples/

    Needs torch, numpy and this package's kernels; no run directory."""
    import argparse

    from gea_torch.utils.grids import tile_grid, write_png

    p = argparse.ArgumentParser(description=_main.__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("artifact", help="export_model output dir")
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--out", default="serve_samples")
    p.add_argument(
        "--d_filter", type=int, default=0,
        help="error-avoidance serving: render --oversample x count candidates, keep the "
        "top count by the bundled D score (artifact must be exported --with_scores)",
    )
    p.add_argument("--oversample", type=int, default=4,
                   help="candidate multiplier for --d_filter")
    p.add_argument(
        "--d_threshold", type=float, default=0.0,
        help="with --d_filter: absolute-score rejection sampling — keep redrawing until "
        "count samples clear this sigmoid-D cutoff (BCE-calibrated scores; top-k ranking "
        "is objective-agnostic)",
    )
    p.add_argument("--device", default="cuda", help="cuda, or cpu to run on the host")
    a = p.parse_args(argv)
    if a.rows < 1:
        raise SystemExit(f"--rows must be >= 1, got {a.rows}")
    if not a.d_filter and (a.d_threshold > 0 or a.oversample != 4):
        raise SystemExit("--d_threshold/--oversample only apply with --d_filter 1 "
                         "(refusing to silently return unfiltered samples)")
    model = load(a.artifact, device=a.device)
    if a.d_filter:
        out = model.sample_filtered(a.count, seed=a.seed, batch_size=a.batch_size,
                                    oversample=a.oversample, threshold=a.d_threshold)
    else:
        out = model.sample(a.count, seed=a.seed, batch_size=a.batch_size)
    os.makedirs(a.out, exist_ok=True)
    grid_path = os.path.join(a.out, "samples.png")
    write_png(grid_path, tile_grid(out["images"], rows=a.rows))
    wrote = [grid_path]
    if "scores" in out:
        scores_path = os.path.join(a.out, "scores.json")
        with open(scores_path, "w") as f:
            json.dump([round(float(s), 6) for s in out["scores"]], f)
        wrote.append(scores_path)
    print(f"[gea_torch.serve] wrote {', '.join(wrote)} ({out['images'].shape[0]} samples)")
    return wrote


if __name__ == "__main__":
    _main()
