"""HTTP inference server over an exported artifact, with dynamic batching
(port of `gea/serve_http.py`, over `gea_torch.serve`).

A stdlib HTTP server whose requests are coalesced into device batches
before they reach the card: the batcher gathers up to `--max_batch` rows
for at most `--max_wait_ms` after the first arrival, renders them as one
call, and splits the outputs back per request. One render of a batch of 64
costs about as much device time as one of a few rows, and every call pays
the host's launch overhead, so coalescing amortizes both.

    python -m gea_torch.serve_http --artifact exports/glis3_80 --port 8000
    python -m gea_torch.serve_http --artifact /tmp/art --device cpu   # host

    POST /render   {"z": [[...], ...]}                  explicit codes
                   {"count": 16, "seed": 7}             server-drawn codes
                   optional "format": "png_b64" (default) | "raw_b64" | "array"
                   optional "spatial_noise": [...]      --spatial_code runs
                   optional "oversample": 4             error-avoidance: the
                   optional "d_threshold": 0.7          server renders extra
                   optional "max_rounds": 8             candidates and keeps
                                                        the top count by D
    GET  /healthz  manifest summary
    GET  /stats    request/batch counters incl. realized batch sizes

Responses are JSON: images as per-sample base64 PNGs (or nested uint8
arrays), plus "scores" when the artifact carries the discriminator.
Error-avoidance serving is server-side: "oversample"/"d_threshold" on a
count request draw extra candidates through the same dynamic batcher
(chunked to max_batch, coalescing with other traffic) and return only the
most-realistic `count`, with a "filter" summary ({oversample, rounds[,
d_threshold, cleared]}) in the response.
"""

from __future__ import annotations

import json
import threading
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gea_torch import serve
from gea_torch.utils.grids import png_bytes

MAX_BODY = 64 * 1024 * 1024


class _Pending:
    """One submitted request: rows [start, stop) of the next device batch."""

    __slots__ = ("z", "sn", "done", "result", "error", "arrived")

    def __init__(self, z: np.ndarray, sn: Optional[np.ndarray]):
        import time

        self.z = z
        self.sn = sn
        self.done = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[Exception] = None
        self.arrived = time.monotonic()


class DynamicBatcher:
    """Coalesces concurrent render requests into single device calls.

    Two threads pipeline the work: the DISPATCH thread owns the model
    (device calls are serialized on one thread and one stream): it blocks
    for the first pending request, keeps gathering until `max_batch` rows
    are queued or `max_wait_ms` has passed since the first arrival, and
    dispatches the concatenation as one device call WITHOUT fetching the
    outputs. The RETIRE thread processes dispatched batches — at most
    `pipeline_depth` (default 4) may be dispatched-but-unretired at once —
    forcing them to host, slicing per request, and releasing the waiters —
    so device call N+1 overlaps the fetch/slice/PNG-encode of call N
    instead of serializing behind it (the in-flight <= K pattern of
    `ServingModel.stream`).

    Backpressure-adaptive growth: when every in-flight slot is taken, the
    dispatch thread keeps GATHERING newly arrived requests into the
    pending batch (up to max_batch) instead of queueing another small one,
    so that a loaded server makes fewer, larger device calls.

    Device batches are padded with zero rows up to a small set of bucket
    sizes (powers of two up to max_batch; or the pinned size for
    manifest["batch"] > 0 artifacts) and trimmed after, so that at most
    log2(max_batch)+1 batch shapes ever reach the program, all warmable at
    startup.
    """

    def __init__(
        self,
        model,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        bucket: bool = True,
        pipeline_depth: int = 4,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        fixed = int(model.manifest.get("batch", 0))
        if fixed:
            max_batch = min(max_batch, fixed)
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._fixed = fixed
        self._buckets: Optional[List[int]] = None
        if fixed:
            self._buckets = [fixed]
        elif bucket:
            self._buckets = [1]
            while self._buckets[-1] < max_batch:
                self._buckets.append(min(self._buckets[-1] * 2, max_batch))
        self._lock = threading.Condition()
        self._queue: List[_Pending] = []
        self._closed = False
        # stats (guarded by _lock)
        self.requests = 0
        self.rows = 0
        self.batch_sizes: Counter = Counter()
        # In-flight window between the dispatch and retire threads: at
        # most `pipeline_depth` dispatched-but-unRETIRED device batches.
        # A bounded Queue can't express that (get() frees the slot before
        # the fetch runs), so the window is a semaphore the dispatch
        # thread acquires per batch and the retire thread releases only
        # after the batch's waiters are done.
        import queue as _queue

        self.pipeline_depth = pipeline_depth
        self._slots = threading.Semaphore(pipeline_depth)
        self._inflight: "_queue.Queue" = _queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._retirer = threading.Thread(target=self._retire_loop, daemon=True)
        self._retirer.start()

    # ------------------------------------------------------------- client
    def submit(
        self, z: np.ndarray, spatial_noise: Optional[np.ndarray] = None
    ) -> Dict[str, np.ndarray]:
        """Validate, enqueue, block until the batch containing this
        request has been rendered; returns this request's slice."""
        z = np.asarray(z, np.float32)
        if z.ndim != 2 or z.shape[1] != self.model.code_size:
            raise ValueError(
                f"z must be (n, {self.model.code_size}), got {z.shape}"
            )
        if not 1 <= z.shape[0] <= self.max_batch:
            raise ValueError(
                f"request rows must be in [1, {self.max_batch}], "
                f"got {z.shape[0]}"
            )
        sn_shape = self.model.spatial_noise_shape
        if sn_shape is not None:
            if spatial_noise is None:
                raise ValueError(
                    "this artifact takes spatial_noise of per-sample shape "
                    f"{sn_shape}"
                )
            spatial_noise = np.asarray(spatial_noise, np.float32)
            if spatial_noise.shape != (z.shape[0], *sn_shape):
                raise ValueError(
                    f"spatial_noise must be {(z.shape[0], *sn_shape)}, "
                    f"got {spatial_noise.shape}"
                )
        elif spatial_noise is not None:
            raise ValueError("this artifact takes no spatial noise")
        item = _Pending(z, spatial_noise)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(item)
            self.requests += 1
            self.rows += z.shape[0]
            self._lock.notify_all()
        item.done.wait()
        if item.error is not None:
            raise item.error
        assert item.result is not None
        return item.result

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._worker.join(timeout=10)
        self._retirer.join(timeout=10)

    def warmup(self, reset_stats: bool = True) -> List[int]:
        """Compile every batch bucket up front (one render per bucket) so
        the first request under load pays serving latency, not
        first-compile latency. Submitted rows are clamped to max_batch —
        pinned-batch artifacts with batch > max_batch realize their one
        bucket through padding. Returns the bucket list warmed."""
        buckets = self._buckets or [self.max_batch]
        rng = np.random.default_rng(0)
        sn_shape = self.model.spatial_noise_shape
        for b in buckets:
            rows = min(b, self.max_batch)
            z = rng.standard_normal(
                (rows, self.model.code_size)
            ).astype(np.float32)
            sn = (
                rng.standard_normal((rows, *sn_shape)).astype(np.float32)
                if sn_shape is not None
                else None
            )
            self.submit(z, sn)
        if reset_stats:
            self.reset_stats()
        return list(buckets)

    def reset_stats(self) -> None:
        with self._lock:
            self.requests = 0
            self.rows = 0
            self.batch_sizes = Counter()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sizes = dict(sorted(self.batch_sizes.items()))
            batches = sum(self.batch_sizes.values())
            return {
                "requests": self.requests,
                "rows": self.rows,
                "batches": batches,
                "batch_sizes": {str(k): v for k, v in sizes.items()},
                "mean_batch_rows": round(self.rows / batches, 3)
                if batches
                else 0.0,
                "max_batch": self.max_batch,
                "max_wait_ms": self.max_wait_s * 1e3,
                "buckets": self._buckets,
            }

    # ------------------------------------------------------------- worker
    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block for the first request, then gather until max_batch rows
        or max_wait_ms after the first arrival. None = closed + drained."""
        import time

        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if not self._queue:
                return None
            # Anchor the hold window at the FIRST request's arrival, not
            # at worker wake-up: requests that queued while the previous
            # batch was rendering have already paid their wait.
            deadline = self._queue[0].arrived + self.max_wait_s
            while True:
                rows = sum(p.z.shape[0] for p in self._queue)
                if rows >= self.max_batch or self._closed:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            # take a prefix whose rows fit max_batch (requests are never
            # split across device calls)
            batch, rows = [], 0
            while self._queue:
                nxt = self._queue[0].z.shape[0]
                if batch and rows + nxt > self.max_batch:
                    break
                batch.append(self._queue.pop(0))
                rows += nxt
            return batch

    def _run(self) -> None:
        """Dispatch loop: renders are DISPATCHED here (copies to the host
        in flight, no wait) and pushed into a bounded in-flight window;
        the retire thread waits for them, slices per request, and releases
        the waiters. Device call N+1 thus overlaps the device->host fetch,
        per-request slicing, and the handler threads' PNG encode of call N;
        the window also keeps device memory bounded under load."""
        try:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                self._await_slot(batch)
                try:
                    item = self._dispatch(batch)
                except Exception as e:  # validation/dispatch failure
                    for p in batch:
                        p.error = e
                        p.done.set()
                    self._slots.release()
                    continue
                self._inflight.put(item)
        finally:
            self._inflight.put(None)  # retire-thread sentinel

    def _await_slot(self, batch: List[_Pending]) -> None:
        """Acquire an in-flight slot, growing `batch` with newly arrived
        requests while every slot is taken (see class docstring: on
        high-RTT transports, batch growth under backpressure beats
        dispatching more small calls)."""
        rows = sum(p.z.shape[0] for p in batch)
        while not self._slots.acquire(blocking=False):
            if rows >= self.max_batch:
                self._slots.acquire()  # full batch: just wait for a slot
                return
            with self._lock:
                while self._queue:
                    nxt = self._queue[0].z.shape[0]
                    if rows + nxt > self.max_batch:
                        break
                    batch.append(self._queue.pop(0))
                    rows += nxt
                if rows < self.max_batch:
                    # Wake on new arrivals; a Condition can't also wait
                    # on the semaphore, so re-poll the slot at a small
                    # bound either way.
                    self._lock.wait(timeout=0.002)

    def _retire_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, out_dev, n, target = item
            try:
                out = {k: np.asarray(v) for k, v in out_dev.items()}
                if n < target:
                    out = {
                        k: (v[:, :n] if k == "stages" else v[:n])
                        for k, v in out.items()
                    }
                splits = np.cumsum([p.z.shape[0] for p in batch])[:-1]
                parts = {
                    k: np.split(v, splits, axis=1 if k == "stages" else 0)
                    for k, v in out.items()
                }
                for i, p in enumerate(batch):
                    p.result = {k: parts[k][i] for k in parts}
            except Exception as e:  # surface the failure to every waiter
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.done.set()
                self._slots.release()

    def _bucket_for(self, rows: int) -> int:
        if self._buckets is None:
            return rows
        for b in self._buckets:
            if b >= rows:
                return b
        return self._buckets[-1]

    def _dispatch(self, batch: List[_Pending]):
        """Pad the coalesced batch to its bucket and dispatch the render;
        returns (batch, device outputs, real rows, bucket rows) for the
        retire thread."""
        z = np.concatenate([p.z for p in batch], axis=0)
        sn = (
            np.concatenate([p.sn for p in batch], axis=0)
            if batch[0].sn is not None
            else None
        )
        n = z.shape[0]
        target = self._bucket_for(n)
        with self._lock:
            self.batch_sizes[target] += 1
        if n < target:
            pad = target - n
            z = np.concatenate([z, np.zeros((pad, z.shape[1]), z.dtype)])
            if sn is not None:
                sn = np.concatenate(
                    [sn, np.zeros((pad, *sn.shape[1:]), sn.dtype)]
                )
        # ServingModel.dispatch returns copies in flight (async); stub or
        # third-party models without it degrade to synchronous __call__ —
        # the pipeline still overlaps slicing/encoding, just not the
        # device fetch.
        render = getattr(self.model, "dispatch", None) or self.model
        out_dev = render(z, sn) if sn is not None else render(z)
        return batch, out_dev, n, target


def _filtered_render(
    batcher: DynamicBatcher,
    model,
    count: int,
    rng: np.random.Generator,
    oversample: int,
    threshold: float,
    max_rounds: int,
):
    """Error-avoidance candidate rounds THROUGH the batcher: each round
    draws oversample*count codes, submits them in max_batch-sized chunks
    (so they coalesce with concurrent traffic), and serve.topk_rounds
    keeps the running top-count by D score."""
    n_cand = count * oversample
    sn_shape = model.spatial_noise_shape

    def draw(_round):
        outs = []
        remaining = n_cand
        while remaining:
            n = min(remaining, batcher.max_batch)
            z = rng.standard_normal((n, model.code_size)).astype(np.float32)
            sn = (
                rng.standard_normal((n, *sn_shape)).astype(np.float32)
                if sn_shape is not None
                else None
            )
            outs.append(batcher.submit(z, sn))
            remaining -= n
        return {
            k: np.concatenate(
                [o[k] for o in outs], axis=1 if k == "stages" else 0
            )
            for k in outs[0]
        }

    return serve.topk_rounds(
        draw, count, threshold=threshold, max_rounds=max_rounds
    )


# ===================================================================== http


def _png_b64(img: np.ndarray) -> str:
    import base64

    return base64.b64encode(png_bytes(img)).decode("ascii")


def _encode_images(images: np.ndarray, fmt: str):
    if fmt == "array":
        return images.tolist()
    if fmt == "raw_b64":
        # base64 of the raw uint8 HxWx3 buffer — ~free to encode vs PNG
        # (which costs host CPU per image: on a small serving host the
        # encoder, not the card, caps png_b64 throughput); the response
        # carries "shape" so clients can reconstruct.
        import base64

        return [base64.b64encode(img.tobytes()).decode("ascii") for img in images]
    return [_png_b64(img) for img in images]


class _Handler(BaseHTTPRequestHandler):
    # set by make_server(): batcher, model
    batcher: DynamicBatcher
    model: serve.ServingModel

    def log_message(self, *args):  # quiet by default; /stats is the signal
        pass

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:
        if self.path == "/healthz":
            m = self.model.manifest
            self._reply(
                200,
                {
                    "ok": True,
                    "code_size": m["code_size"],
                    "image_size": m["image_size"],
                    "outputs": m["outputs"],
                    "batch": m.get("batch", 0),
                    "spatial_noise_shape": m.get("spatial_noise_shape"),
                    "step": m.get("step"),
                },
            )
        elif self.path == "/stats":
            self._reply(200, self.batcher.stats())
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    def do_POST(self) -> None:
        if self.path != "/render":
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length < 0:
                self._reply(400, {"error": "invalid Content-Length"})
                return
            if length > MAX_BODY:
                # Drain (bounded) so the error response is deliverable —
                # closing mid-upload surfaces as ECONNRESET client-side,
                # not as this JSON error.
                remaining = min(length, 8 * MAX_BODY)
                while remaining > 0:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                self._reply(413, {"error": "body too large"})
                return
            req = json.loads(self.rfile.read(length) or b"{}")
            fmt = req.get("format", "png_b64")
            if fmt not in ("png_b64", "raw_b64", "array"):
                raise ValueError(
                    f"format must be png_b64|raw_b64|array, got {fmt!r}"
                )
            if ("z" in req) == ("count" in req):
                raise ValueError("pass exactly one of 'z' or 'count'")
            oversample = req.get("oversample")
            threshold = float(req.get("d_threshold") or 0.0)
            filtering = oversample is not None or threshold > 0
            filter_info: Optional[Dict[str, Any]] = None
            if filtering:
                # Error-avoidance serving over HTTP: the server draws oversample*count candidates THROUGH the
                # dynamic batcher (chunked to max_batch, so they coalesce
                # with other traffic) and returns the top count by the
                # bundled D score; d_threshold redraws until all kept
                # samples clear it (bounded by max_rounds).
                if "count" not in req:
                    raise ValueError(
                        "oversample/d_threshold apply to 'count' requests "
                        "(the server draws and filters its own codes)"
                    )
                if req.get("spatial_noise") is not None:
                    raise ValueError(
                        "filtered sampling draws its own spatial noise"
                    )
                if "scores" not in self.model.manifest.get("outputs", ()):
                    raise ValueError(
                        "artifact carries no discriminator scores; "
                        "re-export with --with_scores 1"
                    )
                oversample = 4 if oversample is None else int(oversample)
                if not 1 <= oversample <= 64:
                    raise ValueError(
                        f"oversample must be in [1, 64], got {oversample}"
                    )
                max_rounds = int(req.get("max_rounds", 8))
                if not 1 <= max_rounds <= 20:
                    raise ValueError(
                        f"max_rounds must be in [1, 20], got {max_rounds}"
                    )
            elif "max_rounds" in req:
                raise ValueError(
                    "max_rounds applies only with oversample/d_threshold"
                )
            if "z" in req:
                z = np.asarray(req["z"], np.float32)
            else:
                count = int(req["count"])
                if not 1 <= count <= self.batcher.max_batch:
                    raise ValueError(
                        f"count must be in [1, {self.batcher.max_batch}]"
                    )
                rng = np.random.default_rng(req.get("seed"))
                if filtering:
                    out, rounds = _filtered_render(
                        self.batcher, self.model, count, rng,
                        oversample, threshold, max_rounds,
                    )
                    filter_info = {"oversample": oversample, "rounds": rounds}
                    if threshold > 0:
                        filter_info["d_threshold"] = threshold
                        filter_info["cleared"] = int(
                            (out["scores"] >= threshold).sum()
                        )
                else:
                    z = rng.standard_normal(
                        (count, self.model.code_size)
                    ).astype(np.float32)
                    if (
                        self.model.spatial_noise_shape is not None
                        and "spatial_noise" not in req
                    ):
                        req["spatial_noise"] = rng.standard_normal(
                            (count, *self.model.spatial_noise_shape)
                        ).astype(np.float32)
            if filter_info is None:
                sn = (
                    np.asarray(req["spatial_noise"], np.float32)
                    if req.get("spatial_noise") is not None
                    else None
                )
                out = self.batcher.submit(z, sn)
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # device-side failure
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        payload: Dict[str, Any] = {
            "images": _encode_images(out["images"], fmt)
        }
        if fmt == "raw_b64":
            payload["shape"] = list(out["images"].shape[1:]) + ["uint8"]
        if "scores" in out:
            payload["scores"] = [round(float(s), 6) for s in out["scores"]]
        if "stages" in out:
            payload["stages"] = [
                _encode_images(stage, fmt) for stage in out["stages"]
            ]
        if filter_info is not None:
            payload["filter"] = filter_info
        self._reply(200, payload)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's listen backlog of 5 drops the connects of a burst of
    # clients beyond it, and each dropped one waits out the 1 s SYN
    # retransmission (measured on the H100 host: p99 1.5 s with 16 clients;
    # PERF.md, export and serving).
    request_queue_size = 128


def make_server(
    artifact: str,
    host: str = "127.0.0.1",
    port: int = 0,
    max_batch: int = 64,
    max_wait_ms: float = 5.0,
    model: Optional[serve.ServingModel] = None,
    bucket: bool = True,
    data_parallel: bool = False,
    pipeline_depth: int = 4,
    device: str = "cuda",
) -> Tuple[ThreadingHTTPServer, DynamicBatcher]:
    """Build (but don't start) the server; port 0 picks a free port. The
    artifact is loaded onto `device` unless a `model` is given.

    Call `server.serve_forever()` (blocking) or run it in a thread;
    shut down with `server.shutdown()` then `batcher.close()`.
    """
    model = model if model is not None else serve.load(artifact, device=device)
    if data_parallel:
        model = model.sharded()
    batcher = DynamicBatcher(
        model, max_batch=max_batch, max_wait_ms=max_wait_ms, bucket=bucket,
        pipeline_depth=pipeline_depth,
    )
    handler = type(
        "BoundHandler", (_Handler,), {"batcher": batcher, "model": model}
    )
    return _Server((host, port), handler), batcher


def main(argv: Optional[list] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--artifact", required=True, help="export_model output dir")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument(
        "--max_batch", type=int, default=64,
        help="largest coalesced device batch (rows)",
    )
    p.add_argument(
        "--max_wait_ms", type=float, default=5.0,
        help="how long to hold a batch open after its first request — "
        "the latency the first requester donates to throughput",
    )
    p.add_argument(
        "--bucket", type=int, default=1,
        help="pad device batches to power-of-two sizes so at most "
        "log2(max_batch)+1 batch shapes ever reach the program (0 = render "
        "each exact coalesced size)",
    )
    p.add_argument(
        "--pipeline_depth", type=int, default=4,
        help="max device batches dispatched-but-unretired at once; while "
        "all slots are taken the dispatcher grows the pending batch "
        "instead of queueing small calls (1 ~= the serial batcher plus "
        "fetch overlap)",
    )
    p.add_argument(
        "--warmup", type=int, default=1,
        help="render every batch bucket once before accepting traffic "
        "(0 = on first use)",
    )
    p.add_argument(
        "--data_parallel", type=int, default=0,
        help="split every device batch across all local cards "
        "(ServingModel.sharded): one artifact, N cards, batch split N "
        "ways; no collectives needed, rendering is sample-parallel",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu to serve on the host")
    a = p.parse_args(argv)
    server, batcher = make_server(
        a.artifact, a.host, a.port, a.max_batch, a.max_wait_ms,
        bucket=bool(a.bucket), data_parallel=bool(a.data_parallel),
        pipeline_depth=a.pipeline_depth, device=a.device,
    )
    if a.warmup:
        buckets = batcher.stats()["buckets"] or [batcher.max_batch]
        print(
            f"[gea_torch.serve_http] warming {len(buckets)} batch buckets "
            f"{buckets} ...", flush=True,
        )
        batcher.warmup()
    host, port = server.server_address[:2]
    print(
        f"[gea_torch.serve_http] serving {a.artifact} on http://{host}:{port} "
        f"(max_batch={batcher.max_batch}, max_wait_ms={a.max_wait_ms})",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.close()


if __name__ == "__main__":
    main()
