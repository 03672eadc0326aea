"""The port's evaluation core (`gea_torch/eval/fid.py`) against `gea`'s
(`gea/eval/fid.py`) on the CPU, inputs made with numpy from a seed.

The random feature networks' filters are drawn with `jax.random`, which
torch cannot redraw; the port loads them from the committed
`gea_torch/eval/random_cnn_filters.npz`. This file also writes that file,
and the golden `tests/torch_port_fid_golden.json` that
`tests/test_torch_port_trainers_card.py` holds the card's features
against:

    python tests/test_torch_port_fid.py --write

Tolerances: features atol 1e-5 + rtol 1e-5 (fp32 convolutions summed in
another order); metrics fed by features from both networks rtol 1e-4;
metrics fed by the same float64 features on both sides exactly equal.
"""

import functools
import json
import os
import pathlib
import sys

if __name__ == "__main__":  # the writer runs outside pytest and its conftest
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from gea.eval import fid as jfid  # noqa: E402
from gea_torch.eval import fid  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "torch_port_fid_golden.json"
NAMES = list(fid.EXTRACTORS)
# The golden's 512 images at 80x80: two halves of 256 from different
# distributions, each np.clip(default_rng(seed).normal(shift, scale,
# (256, 80, 80, 3)), -1, 1) in float32 (the recipe is stored in the golden).
GOLDEN_SIZE = 80
GOLDEN_HALVES = [{"seed": 11, "shift": 0.0, "scale": 0.5, "count": 256},
                 {"seed": 12, "shift": 0.2, "scale": 0.4, "count": 256}]


GEA_MAKE_EXTRACTOR = jfid.make_feature_extractor


@functools.cache
def gea_extractor(name):
    """`gea`'s (extract, label); drawing the filters takes seconds, so once
    a process."""
    return GEA_MAKE_EXTRACTOR(16, name)


@pytest.fixture(autouse=True)
def drawn_once(monkeypatch):
    """`gea`'s MetricBundle and OnlineFID take the extractors drawn once."""
    monkeypatch.setattr(jfid, "make_feature_extractor",
                        lambda image_size, extractor="auto", inception_weights="":
                        gea_extractor("random" if extractor == "auto" else extractor))


def gea_filters(name):
    """The arrays that `gea`'s extractor closes over: 4 HWIO filters and
    the projection, as `jax.random` draws them on this host."""
    extract, _ = gea_extractor(name)
    kernels, proj = (c.cell_contents for c in extract.__wrapped__.__closure__)
    arrays = {f"{name}/conv{i}": np.asarray(k, np.float32) for i, k in enumerate(kernels)}
    arrays[f"{name}/proj"] = np.asarray(proj, np.float32)
    return arrays


def images(n, size, seed, shift=0.0, scale=0.5):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(shift, scale, (n, size, size, 3)), -1, 1).astype(np.float32)


def golden_images():
    return [images(h["count"], GOLDEN_SIZE, h["seed"], h["shift"], h["scale"])
            for h in GOLDEN_HALVES]


def golden_of(extract):
    """Feature mean, covariance trace and the proxy-FID between the two
    halves, for one feature extractor."""
    a, b = golden_images()
    fa, fb = (np.concatenate([np.asarray(extract(x[i:i + 64])) for i in range(0, len(x), 64)])
              .astype(np.float64) for x in (a, b))
    both = jfid.FIDStats.empty(fa.shape[1])
    both.update(np.concatenate([fa, fb]))
    sa, sb = jfid.FIDStats.empty(fa.shape[1]), jfid.FIDStats.empty(fa.shape[1])
    sa.update(fa)
    sb.update(fb)
    return {"mean": both.mean.tolist(), "cov_trace": float(np.trace(both.cov)),
            "fid_halves": jfid.frechet_distance(sa.mean, sa.cov, sb.mean, sb.cov)}


def write():
    jax.config.update("jax_default_matmul_precision", "highest")
    arrays = {}
    for name in NAMES:
        arrays.update(gea_filters(name))
    meta = {"jax_version": jax.__version__,
            "jax_threefry_partitionable": bool(jax.config.jax_threefry_partitionable)}
    np.savez(fid.FILTERS, **arrays, **{k: np.array(v) for k, v in meta.items()})
    golden = {**meta, "images": {"size": GOLDEN_SIZE, "halves": GOLDEN_HALVES},
              **{name: golden_of(gea_extractor(name)[0])
                 for name in NAMES}}
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {fid.FILTERS} ({sum(a.size for a in arrays.values())} fp32 values) and {GOLDEN}")


# ------------------------------------------------------------------ filters


@pytest.mark.parametrize("name", NAMES)
def test_filters_equal_geas_draws(name):
    """The committed filters are `gea`'s `jax.random` draws bit for bit."""
    stored = fid.load_filters()
    want = gea_filters(name)
    written = (f"written with jax {stored['jax_version']} "
               f"(threefry_partitionable={stored['jax_threefry_partitionable']}); this host "
               f"has jax {jax.__version__} "
               f"(threefry_partitionable={jax.config.jax_threefry_partitionable})")
    for key, arr in want.items():
        assert stored[key].dtype == np.float32 and stored[key].shape == arr.shape, key
        assert np.array_equal(stored[key], arr), f"{key} differs from gea's draw: {written}"
    chans = fid.EXTRACTORS[name]["chans"]
    assert [want[f"{name}/conv{i}"].shape[3] for i in range(4)] == list(chans[1:])
    assert want[f"{name}/proj"].shape == (2 * chans[-1], fid.EXTRACTORS[name]["feature_dim"])


def test_filter_file_holds_811112_values():
    stored = fid.load_filters()
    assert sum(v.size for k, v in stored.items() if "/" in k) == 811_112


# ------------------------------------------------------------------ features


@pytest.mark.parametrize("size", [16, 80])
@pytest.mark.parametrize("name", NAMES)
def test_features_match_gea(name, size):
    x = images(6, size, size)
    jextract, jlabel = gea_extractor(name)
    want = np.asarray(jextract(x))
    extract, label = fid.make_feature_extractor(size, name, device="cpu")
    got = extract(x)
    assert label == fid.EXTRACTORS[name]["label"] == jlabel
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # A bf16 batch (as the generator renders in bf16) is cast to fp32 first.
    bf = torch.from_numpy(x).bfloat16()
    np.testing.assert_array_equal(extract(bf).numpy(), extract(bf.float()).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_golden_matches_the_port(name):
    """The committed golden (written from `gea`) against the port's
    features on the CPU, at the tolerances
    `tests/test_torch_port_trainers_card.py` holds the card to: feature means and covariance trace rtol 1e-4, FID rtol 1e-3."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["images"] == {"size": GOLDEN_SIZE, "halves": GOLDEN_HALVES}
    want = golden[name]
    extract, _ = fid.make_feature_extractor(GOLDEN_SIZE, name, device="cpu")
    got = golden_of(lambda x: extract(x).numpy())
    mean = np.asarray(want["mean"])
    np.testing.assert_allclose(got["mean"], mean, rtol=1e-4, atol=1e-4 * np.abs(mean).max())
    np.testing.assert_allclose(got["cov_trace"], want["cov_trace"], rtol=1e-4)
    np.testing.assert_allclose(got["fid_halves"], want["fid_halves"], rtol=1e-3)


@pytest.mark.parametrize("request_", [{"extractor": "inception"},
                                      {"inception_weights": "/weights/iv3.h5"},
                                      {"extractor": "auto", "inception_weights": "iv3.h5"}],
                         ids=["extractor", "weights", "auto_with_weights"])
def test_inception_requests_raise(request_):
    """True FID is refused loudly, never replaced by the proxy."""
    with pytest.raises(RuntimeError, match="InceptionV3"):
        fid.make_feature_extractor(16, device="cpu", **request_)
    with pytest.raises(RuntimeError, match="InceptionV3"):
        fid.MetricBundle(16, device="cpu", **request_)


def test_auto_is_random_and_unknown_refused():
    _, label = fid.make_feature_extractor(16, "auto", device="cpu")
    assert label == "proxy-FID(random-cnn)"
    with pytest.raises(ValueError, match="unknown extractor"):
        fid.make_feature_extractor(16, "vgg", device="cpu")


def test_extractor_on_the_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fid.make_feature_extractor(16)


# ------------------------------------------------------- moments and distances


def feats(n, d, seed, shift=0.0):
    return np.random.default_rng(seed).normal(shift, 1.0, (n, d))


@pytest.mark.parametrize("n,d,blow_up", [(500, 16, False), (8, 64, False), (8, 64, True)],
                         ids=["full_rank", "rank_deficient", "eps_retry"])
def test_moments_and_frechet_equal_geas(n, d, blow_up, monkeypatch):
    """The same float64 features on both sides: moments and Frechet
    distance exactly equal, also with fewer samples than dimensions. The
    installed scipy's sqrtm stays finite on such random rank-deficient
    pairs; `eps_retry` makes its first call per side return NaN, as older
    sqrtm did on them, so that both sides take the eps*I retry."""
    a, b = feats(n, d, 1), feats(n, d, 2, shift=0.5)
    ours, theirs = [], []
    for mod, out in ((fid, ours), (jfid, theirs)):
        stats = [mod.FIDStats.empty(d) for _ in range(2)]
        for s, x in zip(stats, (a, b)):
            for i in range(0, n, 3):
                s.update(x[i:i + 3])
        out += [stats[0].mean, stats[0].cov, stats[1].mean, stats[1].cov]
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)

    from scipy import linalg

    calls = []
    real_sqrtm = linalg.sqrtm

    def counted(m, **kw):
        # `gea` asks for (root, error) with disp=False; the port for the root.
        calls.append(1)
        out = real_sqrtm(m, **kw)
        root = out[0] if kw else out
        if blow_up and len(calls) % 2:
            root = np.full_like(root, np.nan)
        return (root, out[1]) if kw else root

    monkeypatch.setattr(linalg, "sqrtm", counted)
    got = fid.frechet_distance(*ours)
    mine = len(calls)
    want = jfid.frechet_distance(*theirs)
    assert got == want and np.isfinite(got)
    assert mine == len(calls) - mine == (2 if blow_up else 1)
    monkeypatch.undo()
    plain = fid.frechet_distance(*ours)
    assert (got != plain) == blow_up  # the retry's eps*I moves the distance, a little
    np.testing.assert_allclose(got, plain, rtol=1e-2)


def test_frechet_raises_when_still_non_finite(monkeypatch):
    """Non-finite after the retry too: FloatingPointError on both sides."""
    from scipy import linalg

    monkeypatch.setattr(linalg, "sqrtm", lambda m, **kw: (np.full_like(m, np.nan), 0.0)
                        if kw else np.full_like(m, np.nan))
    mu, cov = np.zeros(4), np.eye(4)
    for mod in (fid, jfid):
        with pytest.raises(FloatingPointError, match="eps regularization"):
            mod.frechet_distance(mu, cov, mu, cov)


@pytest.mark.parametrize("metric", ["kid", "precision_recall"])
def test_kid_and_precision_recall_equal_geas(metric):
    real, fake = feats(300, 32, 3), feats(280, 32, 4, shift=0.3)
    if metric == "kid":
        for kw in ({}, {"subset_size": 100, "n_subsets": 5, "seed": 3}):
            assert fid.kid_score(real, fake, **kw) == jfid.kid_score(real, fake, **kw)
    else:
        assert fid.precision_recall(real, fake) == jfid.precision_recall(real, fake)
        with pytest.raises(ValueError, match="needs > k"):
            fid.precision_recall(real[:3], fake)


# ------------------------------------------------------------- the scorers


def batches(seed, shift, n=5, b=16, size=16):
    return [images(b, size, seed * 100 + i, shift=shift) for i in range(n)]


@pytest.mark.parametrize("second_opinion", [False, True], ids=["primary", "second_opinion"])
def test_metric_bundle_rows_match_gea(second_opinion):
    """MetricBundle over the same batches: reals and two groups of fakes
    (torch tensors on the port's side), one ragged at the sample cap."""
    reals, fakes = batches(1, 0.0), batches(2, 0.4)
    ours = fid.MetricBundle(16, "random", second_opinion=second_opinion, device="cpu")
    theirs = jfid.MetricBundle(16, "random", second_opinion=second_opinion)
    ours.set_reals((torch.from_numpy(x) for x in reals), 72)
    theirs.set_reals(iter(reals), 72)
    for n in (64, 70):
        g, h = ours.group(), theirs.group()
        g.consume((torch.from_numpy(x) for x in fakes), n)
        h.consume(iter(fakes), n)
        assert g.n == h.n == n
        got, want = ours.row(g, ndigits=10), theirs.row(h, ndigits=10)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k in ("precision", "recall"):
                assert got[k] == v, k  # fractions of 64-72 samples: a flip moves 1/64
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert (ours.label, ours.label_b) == (theirs.label, theirs.label_b)


def test_online_fid_and_compute_fid_match_gea():
    reals, fakes = batches(3, 0.0), batches(4, 0.5)
    ours = fid.OnlineFID(iter(reals), 16, num_samples=48, extractor="random", device="cpu")
    theirs = jfid.OnlineFID(iter(reals), 16, num_samples=48, extractor="random")
    want = theirs.score(iter(fakes))
    np.testing.assert_allclose(ours.score(iter(fakes)), want, rtol=1e-4)
    np.testing.assert_allclose(ours.score(iter(fakes)), want, rtol=1e-4)  # stateless real side
    got, label = fid.compute_fid(iter(reals), iter(fakes), 16, num_samples=48,
                                 extractor="random", device="cpu")
    np.testing.assert_allclose(got, ours.score(iter(fakes)), rtol=1e-12)
    assert label == "proxy-FID(random-cnn)"


def test_compute_features_and_stats_take_the_cap():
    xs = batches(5, 0.0, n=3, b=4)
    extract, _ = fid.make_feature_extractor(16, "random", device="cpu")
    jextract, _ = gea_extractor("random")
    got = fid.compute_features(iter(xs), extract, 10)
    want = jfid.compute_features(iter(xs), jextract, 10)
    assert got.shape == want.shape == (10, 256) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    stats = fid.compute_stats(iter(xs), extract, 10)
    assert stats.n == 10
    np.testing.assert_allclose(stats.mean, got.mean(axis=0), rtol=1e-12)
    with pytest.raises(ValueError, match="no samples"):
        fid.compute_stats(iter([]), extract, 10)


if __name__ == "__main__" and "--write" in sys.argv:
    write()
