"""The port's HTTP serving layer (`gea_torch.serve_http`): `gea`'s cases
(`tests/test_serve_http.py`) with the same stub models, then one end-to-end
POST /render of a CPU artifact against `gea.serve_http` serving `gea`'s
artifact of the same weights (uint8 within 1 level, scores atol 1e-5)."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from gea_torch.serve_http import DynamicBatcher, make_server


class StubModel:
    """ServingModel lookalike: images[:, 0, 0, 0] encodes round(z[:, 0])
    so per-request slices can be verified after coalescing."""

    def __init__(self, code_size=8, batch=0, calls=None):
        self.manifest = {
            "batch": batch,
            "code_size": code_size,
            "image_size": 4,
            "outputs": ["images", "scores"],
            "step": 0,
        }
        self.calls = calls if calls is not None else []

    @property
    def code_size(self):
        return self.manifest["code_size"]

    @property
    def spatial_noise_shape(self):
        return None

    def __call__(self, z, spatial_noise=None):
        self.calls.append(z.shape[0])
        n = z.shape[0]
        images = np.zeros((n, 4, 4, 3), np.uint8)
        images[:, 0, 0, 0] = np.clip(np.round(z[:, 0]), 0, 255)
        stages = np.stack([images, images + 1])
        return {
            "images": images,
            "stages": stages,
            "scores": np.full((n,), 0.5, np.float32),
        }


def test_batcher_coalesces_and_splits_correctly():
    model = StubModel()
    b = DynamicBatcher(model, max_batch=64, max_wait_ms=250.0)
    results = {}

    def worker(i):
        z = np.full((2, 8), float(i), np.float32)
        results[i] = b.submit(z)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    b.close()

    # every request got ITS rows back, whatever the coalescing was
    for i in range(6):
        out = results[i]
        assert out["images"].shape == (2, 4, 4, 3)
        assert out["scores"].shape == (2,)
        assert out["stages"].shape == (2, 2, 4, 4, 3)  # split on axis 1
        assert np.all(out["images"][:, 0, 0, 0] == i)
        assert np.all(out["stages"][0, :, 0, 0, 0] == i)
    # 12 rows total; the 250ms window must have coalesced SOMETHING.
    # Device calls are padded to pow2 buckets, so sums can exceed 12.
    assert sum(model.calls) >= 12
    assert len(model.calls) < 6
    assert all(n in (1, 2, 4, 8, 16, 32, 64) for n in model.calls)
    stats = b.stats()
    assert stats["requests"] == 6
    assert stats["rows"] == 12
    assert stats["batches"] == len(model.calls)


def test_batcher_buckets_pad_to_pow2_and_trim():
    model = StubModel()
    b = DynamicBatcher(model, max_batch=64, max_wait_ms=1.0)
    out = b.submit(np.full((3, 8), 5.0, np.float32))
    b.close()
    assert model.calls == [4]  # 3 rows padded to the 4-bucket
    assert out["images"].shape == (3, 4, 4, 3)
    assert np.all(out["images"][:, 0, 0, 0] == 5)

    model2 = StubModel()
    b2 = DynamicBatcher(model2, max_batch=64, max_wait_ms=1.0, bucket=False)
    out2 = b2.submit(np.full((3, 8), 5.0, np.float32))
    b2.close()
    assert model2.calls == [3]  # exact-shape mode
    assert out2["images"].shape == (3, 4, 4, 3)


def test_batcher_pads_pinned_batch_and_trims():
    model = StubModel(batch=8)
    b = DynamicBatcher(model, max_batch=64, max_wait_ms=1.0)
    out = b.submit(np.full((3, 8), 7.0, np.float32))
    b.close()
    assert model.calls == [8]  # padded up to the pinned batch
    assert out["images"].shape == (3, 4, 4, 3)  # trimmed back
    assert out["stages"].shape == (2, 3, 4, 4, 3)
    assert np.all(out["images"][:, 0, 0, 0] == 7)


def test_warmup_compiles_buckets_and_clamps_pinned_batch():
    # symbolic-batch model: one render per pow2 bucket, stats reset after
    model = StubModel()
    b = DynamicBatcher(model, max_batch=8, max_wait_ms=1.0)
    warmed = b.warmup()
    b.close()
    assert warmed == [1, 2, 4, 8]
    assert model.calls == [1, 2, 4, 8]
    assert b.stats()["requests"] == 0  # reset

    # pinned batch LARGER than max_batch: warmup must clamp its submit to
    # max_batch rows (regression: it used to submit the full pinned size
    # and die on its own row validation); padding realizes the bucket
    model2 = StubModel(batch=128)
    b2 = DynamicBatcher(model2, max_batch=16, max_wait_ms=1.0)
    warmed2 = b2.warmup()
    b2.close()
    assert warmed2 == [128]
    assert model2.calls == [128]  # 16 submitted rows padded to the pin


def test_batcher_validates_and_propagates_errors():
    model = StubModel()
    b = DynamicBatcher(model, max_batch=4, max_wait_ms=1.0)
    with pytest.raises(ValueError):
        b.submit(np.zeros((1, 5), np.float32))  # wrong code_size
    with pytest.raises(ValueError):
        b.submit(np.zeros((5, 8), np.float32))  # rows > max_batch
    with pytest.raises(ValueError):
        b.submit(np.zeros((1, 8), np.float32), np.zeros((1, 2, 2, 1)))

    b.close()

    class BadModel(StubModel):
        def __call__(self, z, spatial_noise=None):
            raise RuntimeError("device exploded")

    b2 = DynamicBatcher(BadModel(), max_batch=4, max_wait_ms=1.0)
    with pytest.raises(RuntimeError, match="device exploded"):
        b2.submit(np.zeros((1, 8), np.float32))
    b2.close()


class _Lazy:
    """Array-like whose materialization blocks until `gate` opens —
    stands in for an un-fetched device buffer in the retire thread."""

    def __init__(self, gate, arr):
        self.gate = gate
        self.arr = arr

    def __array__(self, dtype=None, copy=None):
        assert self.gate.wait(timeout=10), "retire gate never opened"
        return self.arr if dtype is None else self.arr.astype(dtype)


class AsyncStub(StubModel):
    """ServingModel lookalike with an async `dispatch`: the device call
    returns immediately; the RETIRE-side fetch (np.asarray) blocks on
    `gate` — the shape of a real pipelined fetch on a slow transport."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.gate = threading.Event()

    def dispatch(self, z, spatial_noise=None):
        out = super().__call__(z)
        return {k: _Lazy(self.gate, v) for k, v in out.items()}


def test_batcher_grows_batch_under_backpressure():
    # While every in-flight slot is taken (retire blocked on the fetch),
    # newly arrived requests must coalesce into ONE growing batch instead
    # of being dispatched as more small calls (the measured high-RTT
    # regression vs the serial batcher — docs/RESULTS.md round 4).
    model = AsyncStub()
    b = DynamicBatcher(model, max_batch=64, max_wait_ms=1.0,
                       pipeline_depth=1)
    results = {}

    def worker(i):
        results[i] = b.submit(np.full((2, 8), float(i), np.float32))

    threads = [threading.Thread(target=worker, args=(0,))]
    threads[0].start()
    # first request dispatches alone and takes the only slot
    deadline = 5.0
    import time

    t0 = time.monotonic()
    while len(model.calls) < 1 and time.monotonic() - t0 < deadline:
        time.sleep(0.005)
    assert model.calls == [2]
    # four more arrive while the slot is held: the dispatcher must absorb
    # them all into its pending batch (queue drains, no second call yet)
    for i in range(1, 5):
        t = threading.Thread(target=worker, args=(i,))
        t.start()
        threads.append(t)
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        with b._lock:
            drained = not b._queue and b.requests == 5
        if drained and len(model.calls) == 1:
            break
        time.sleep(0.005)
    assert len(model.calls) == 1  # nothing dispatched while slot held
    model.gate.set()  # fetch completes -> slot frees -> ONE grown call
    for t in threads:
        t.join(timeout=10)
    b.close()
    assert model.calls == [2, 8]  # 4 requests x 2 rows coalesced
    for i in range(5):
        assert results[i]["images"].shape == (2, 4, 4, 3)
        assert np.all(results[i]["images"][:, 0, 0, 0] == i)
    sizes = b.stats()["batch_sizes"]
    assert sum(sizes.values()) == 2


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def http_server():
    model = StubModel()
    server, batcher = make_server(
        artifact="", model=model, max_batch=16, max_wait_ms=50.0
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", model
    server.shutdown()
    batcher.close()
    thread.join(timeout=10)


def test_http_render_healthz_stats_and_errors(http_server):
    base, model = http_server

    status, health = _get(base + "/healthz")
    assert status == 200 and health["ok"] and health["code_size"] == 8

    # explicit z, array format: identity encoding must round-trip
    z = np.full((3, 8), 9.0, np.float32)
    status, out = _post(
        base + "/render", {"z": z.tolist(), "format": "array"}
    )
    assert status == 200
    images = np.asarray(out["images"], np.uint8)
    assert images.shape == (3, 4, 4, 3)
    assert np.all(images[:, 0, 0, 0] == 9)
    assert out["scores"] == [0.5, 0.5, 0.5]
    assert len(out["stages"]) == 2  # per-stage view, outer list = stage

    # raw_b64: base64 of the raw uint8 buffer + shape for reconstruction
    status, out = _post(
        base + "/render", {"z": z.tolist(), "format": "raw_b64"}
    )
    assert status == 200 and out["shape"] == [4, 4, 3, "uint8"]
    import base64 as _b64

    raw = np.frombuffer(
        _b64.b64decode(out["images"][0]), np.uint8
    ).reshape(4, 4, 3)
    assert raw[0, 0, 0] == 9

    # server-drawn codes: png_b64 default decodes to valid PNGs
    status, out = _post(base + "/render", {"count": 2, "seed": 0})
    assert status == 200 and len(out["images"]) == 2
    import base64
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(out["images"][0])))
    assert img.size == (4, 4)

    # deterministic: same seed, same images
    status2, out2 = _post(base + "/render", {"count": 2, "seed": 0})
    assert out2["images"] == out["images"]

    # error paths -> 400 with a message, server stays up
    for bad in (
        {"z": [[1.0] * 5]},                       # wrong code_size
        {"z": [[1.0] * 8], "count": 1},           # both z and count
        {},                                        # neither
        {"count": 0},                              # out of range
        {"z": [[1.0] * 8], "format": "jpeg"},      # bad format
    ):
        status, err = _post(base + "/render", bad)
        assert status == 400 and "error" in err

    # negative Content-Length must be a 400, not a blocking rfile.read(-1)
    import http.client

    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    conn.putrequest("POST", "/render")
    conn.putheader("Content-Length", "-1")
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 400
    conn.close()

    status, _ = _get(base + "/healthz")
    assert status == 200

    status, stats = _get(base + "/stats")
    assert status == 200
    assert stats["requests"] >= 3
    assert stats["batches"] >= 1


def test_http_concurrent_requests_coalesce(http_server):
    base, model = http_server
    model.calls.clear()
    results = [None] * 8

    def worker(i):
        results[i] = _post(
            base + "/render",
            {"z": np.full((1, 8), float(i)).tolist(), "format": "array"},
        )

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (status, out) in enumerate(results):
        assert status == 200
        assert np.asarray(out["images"])[0, 0, 0, 0] == i
    assert sum(model.calls) >= 8  # padded pow2 buckets can exceed the rows
    assert len(model.calls) < 8  # at least one coalesced device call


class ScoredStubModel(StubModel):
    """Stub whose D score is a deterministic function of the code
    (sigmoid of z[:, 0]) so server-side top-k selection is verifiable
    by replaying the request's seeded draw."""

    def __call__(self, z, spatial_noise=None):
        out = super().__call__(z, spatial_noise)
        out["scores"] = (1.0 / (1.0 + np.exp(-z[:, 0]))).astype(np.float32)
        return out


@pytest.fixture()
def scored_server():
    model = ScoredStubModel()
    server, batcher = make_server(
        artifact="", model=model, max_batch=16, max_wait_ms=5.0
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", model
    server.shutdown()
    batcher.close()
    thread.join(timeout=10)


def test_http_filtered_top_k_exact(scored_server):
    """oversample on a count request returns exactly the top-count
    candidates of the seeded draw (one 16-row chunk -> replayable)."""
    base, model = scored_server
    status, out = _post(
        base + "/render",
        {"count": 4, "seed": 11, "oversample": 4, "format": "array"},
    )
    assert status == 200
    want_z = np.random.default_rng(11).standard_normal((16, 8))
    want = np.sort(1.0 / (1.0 + np.exp(-want_z[:, 0])))[::-1][:4]
    np.testing.assert_allclose(out["scores"], want, rtol=1e-5)
    assert out["scores"] == sorted(out["scores"], reverse=True)
    assert len(out["images"]) == 4
    assert out["filter"] == {"oversample": 4, "rounds": 1}


def test_http_filtered_threshold_rounds_and_shortfall(scored_server):
    """An unreachable d_threshold exhausts max_rounds, still returns
    count samples, and reports cleared honestly."""
    base, _ = scored_server
    status, out = _post(
        base + "/render",
        {"count": 3, "seed": 0, "d_threshold": 1.5, "max_rounds": 2},
    )
    assert status == 200
    assert len(out["images"]) == 3
    assert out["filter"]["rounds"] == 2
    assert out["filter"]["cleared"] == 0
    assert out["filter"]["d_threshold"] == 1.5

    # achievable threshold: stops early, everything clears
    status, out = _post(
        base + "/render",
        {"count": 2, "seed": 1, "d_threshold": 0.2, "max_rounds": 20},
    )
    assert status == 200
    assert out["filter"]["cleared"] == 2
    assert all(s >= 0.2 for s in out["scores"])


def test_http_filtered_chunks_large_candidate_pools(scored_server):
    """count*oversample beyond max_batch is drawn in max_batch chunks
    through the batcher (no request-size rejection)."""
    base, model = scored_server
    before = len(model.calls)
    status, out = _post(
        base + "/render", {"count": 16, "seed": 2, "oversample": 4}
    )
    assert status == 200 and len(out["images"]) == 16
    assert sum(model.calls[before:]) == 64  # 4 chunks of max_batch=16


def test_http_filtered_validation(scored_server, http_server):
    base, _ = scored_server
    for bad in (
        {"z": [[0.0] * 8], "oversample": 2},           # z-mode filter
        {"count": 2, "oversample": 0},                  # out of range
        {"count": 2, "oversample": 65},
        {"count": 2, "d_threshold": 0.5, "max_rounds": 0},
        {"count": 2, "max_rounds": 4},                  # rounds w/o filter
    ):
        status, out = _post(base + "/render", bad)
        assert status == 400, bad
        assert "error" in out

    # artifact without discriminator scores refuses filtering
    base_ns, model_ns = http_server
    model_ns.manifest["outputs"] = ["images"]
    status, out = _post(base_ns + "/render", {"count": 2, "oversample": 2})
    assert status == 400 and "with_scores" in out["error"]


# ------------------------------------------------- an artifact, end to end


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(gea's server, the port's) over artifacts of the same jittered
    weights: a G-LIS run of each package, exported for the CPU with every
    stage and the scores."""
    import jax
    import jax.numpy as jnp

    from gea import serve_http as jax_serve_http
    from gea.cli import export_model as jax_export_model
    from gea.config import TrainGLISConfig as JaxTrainGLISConfig
    from gea.train.state import GANTrainState
    from gea.utils import checkpoint as jax_ckpt
    from gea_torch.cli import export_model
    from gea_torch.config import TrainGLISConfig
    from gea_torch.interop import init_discriminator_params, init_generator_params
    from gea_torch.train import create_glis_state
    from gea_torch.utils import checkpoint as ckpt

    root = tmp_path_factory.mktemp("http")
    cfg = dict(image_size=16, code_size=16, num_features=4, max_features=16,
               dtype="float32", batch_size=8, dataset="synthetic", crop_size=32,
               r_iterations=1)
    pcfg = TrainGLISConfig(**cfg)
    rng = np.random.default_rng(1)
    g, d = (jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32), p)
        for p in (init_generator_params(pcfg, 0), init_discriminator_params(pcfg, 2)))
    empty = dict(rng=jax.random.PRNGKey(0), extras_g={}, extras_d={}, opt_g={}, opt_d={},
                 params_r={}, extras_r={}, opt_r={}, params_g_ema={})
    gea_run, port_run = str(root / "gea_run"), str(root / "port_run")
    JaxTrainGLISConfig(**cfg).save(os.path.join(gea_run, "config.json"))
    jax_ckpt.save_checkpoint(gea_run, 2, GANTrainState(
        step=jnp.asarray(2, jnp.int32), params_g=g, params_d=d, **empty))
    jax_ckpt.wait_for_checkpoints()
    pcfg.save(os.path.join(port_run, "config.json"))
    state = create_glis_state(pcfg, g, d, device="cpu")
    state.step = 2
    ckpt.save_checkpoint(port_run, 2, state)
    flags = ["--platforms", "cpu", "--all_stages", "1", "--with_scores", "1"]
    jax_export_model.main(["--load_path", gea_run, "--out", str(root / "gea")] + flags
                          + ["--selfcheck", "0"])
    export_model.main(["--load_path", port_run, "--out", str(root / "port"), "--device",
                       "cpu"] + flags)
    made = [jax_serve_http.make_server(str(root / "gea"), max_batch=8, max_wait_ms=5.0),
            make_server(str(root / "port"), max_batch=8, max_wait_ms=5.0, device="cpu")]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s, _ in made]
    for t in threads:
        t.start()
    yield [f"http://{s.server_address[0]}:{s.server_address[1]}" for s, _ in made]
    for (s, b), t in zip(made, threads):
        s.shutdown()
        b.close()
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("payload", [
    {"z": np.random.default_rng(4).standard_normal((3, 16)).tolist()},
    {"count": 4, "seed": 7, "oversample": 2},
], ids=["z", "count_oversample"])
def test_render_matches_gea_serve_http(servers, payload):
    gea_base, port_base = servers
    (s1, want), (s2, got) = (_post(b + "/render", {**payload, "format": "array"})
                             for b in (gea_base, port_base))
    assert s1 == s2 == 200
    assert sorted(got) == sorted(want)
    for k in ("images", "stages"):
        a, b = np.asarray(got[k], np.int16), np.asarray(want[k], np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, k
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
    assert got.get("filter") == want.get("filter")
    status, stats = _get(port_base + "/stats")
    assert status == 200 and stats["requests"] >= 1
    status, health = _get(port_base + "/healthz")
    assert health["outputs"] == ["images", "stages", "scores"] and health["step"] == 2
