"""Frechet distance evaluation (port of `gea/eval/fid.py`).

The metric is `gea`'s proxy-FID: Gaussian moments of the features of a
frozen, fixed-seed random CNN (`extractor="random"`, labelled
``proxy-FID(random-cnn)``; the independent second opinion
``"random-b"``, labelled ``proxy-FID(random-cnn-b)``), scored with the exact
``||mu1-mu2||^2 + tr(C1 + C2 - 2 sqrt(C1 C2))``. True FID needs InceptionV3
weights, which the port does not have: ``extractor="inception"`` and
``inception_weights`` raise, and ``"auto"`` means ``"random"``.

`gea` draws the random filters with `jax.random` (PRNGKey(1234), and seed
7777 for random-b), which torch cannot redraw; the port loads the same
arrays from `random_cnn_filters.npz` beside this file, written from `gea`
by ``python tests/test_torch_port_fid.py --write``. The feature network is
plain PyTorch (`conv2d`, `relu`, mean and max pooling, a matmul), in fp32
without TF32 on the card, on the device of the images: a batch stays on the
card through the extractor and only its features, (B, 256) or (B, 192),
reach the host, where the moments accumulate in float64 as in `gea`.

The numpy parts (`FIDStats`, `frechet_distance` with scipy's `sqrtm` and
its eps retry, `kid_score`, `precision_recall`) are copies of `gea`'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import pathlib
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gea_torch.config import resolve_device

FILTERS = pathlib.Path(__file__).with_name("random_cnn_filters.npz")

# The two random-feature networks of `gea/eval/fid.py` (`:112-124`, `:263-276`).
EXTRACTORS = {
    "random": {"seed": 1234, "chans": (3, 32, 64, 128, 256), "feature_dim": 256,
               "label": "proxy-FID(random-cnn)"},
    "random-b": {"seed": 7777, "chans": (3, 24, 48, 96, 192), "feature_dim": 192,
                 "label": "proxy-FID(random-cnn-b)"},
}

FeatureExtractor = Callable[..., torch.Tensor]


# ----------------------------------------------------------------- stats


@dataclasses.dataclass
class FIDStats:
    """Streaming Gaussian moments of a feature distribution."""

    n: int
    sum: np.ndarray  # (D,)
    outer: np.ndarray  # (D, D)

    @classmethod
    def empty(cls, dim: int) -> "FIDStats":
        return cls(0, np.zeros(dim, np.float64), np.zeros((dim, dim), np.float64))

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(1, self.n)

    @property
    def cov(self) -> np.ndarray:
        mu = self.mean
        return self.outer / max(1, self.n - 1) - np.outer(mu, mu) * (
            self.n / max(1, self.n - 1)
        )


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """d^2 = ||mu1-mu2||^2 + tr(C1 + C2 - 2 (C1 C2)^{1/2})."""
    from scipy import linalg

    diff = mu1 - mu2
    # `gea` passes disp=False and drops the error estimate; SciPy 1.18 took
    # the argument away, and without it every version returns the root alone.
    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.all(np.isfinite(covmean)):
        # Rank-deficient covariances (sample count <= feature dim) can make
        # sqrtm blow up; retry with the standard eps*I diagonal
        # regularization rather than report NaN into best.json.
        eps = 1e-6 * max(np.trace(cov1), np.trace(cov2), 1.0) / cov1.shape[0]
        off = eps * np.eye(cov1.shape[0])
        covmean = linalg.sqrtm((cov1 + off) @ (cov2 + off))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    fid = float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))
    if not np.isfinite(fid):
        raise FloatingPointError(
            "frechet_distance is non-finite even after eps regularization "
            "(degenerate covariance — too few samples for the feature dim?)"
        )
    return fid


# ------------------------------------------------------------ extractors


@functools.cache
def load_filters() -> dict:
    """The committed filters by key ("random/conv0".."random/conv3" in
    `gea`'s HWIO layout, "random/proj" (2 * C, D); the same for
    "random-b/..."), and the JAX version and threefry setting they were
    drawn with."""
    with np.load(FILTERS) as f:
        return {k: f[k] for k in f.files}


@contextlib.contextmanager
def exact_fp32():
    """fp32 convolutions and matmuls without TF32 (PyTorch lets cuDNN use
    TF32 by default), so that the features are `gea`'s fp32 features."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class RandomCNN(nn.Module):
    """`gea`'s frozen random feature network: 4 stages of a 3x3 stride-2
    conv (padding 1) and relu, mean and max over H and W concatenated, then
    a fixed projection. Takes NHWC images (B, H, W, 3) of any float dtype,
    as a tensor or a numpy array, and returns fp32 features (B, D) on the
    network's device. The filters are buffers, in fp32."""

    def __init__(self, name: str = "random"):
        super().__init__()
        filters = load_filters()
        for i in range(4):
            hwio = torch.from_numpy(filters[f"{name}/conv{i}"])
            self.register_buffer(f"conv{i}", hwio.permute(3, 2, 0, 1).contiguous())  # OIHW
        self.register_buffer("proj", torch.from_numpy(filters[f"{name}/proj"]).clone())

    def forward(self, images) -> torch.Tensor:
        x = torch.as_tensor(images).to(self.proj.device, torch.float32).permute(0, 3, 1, 2)
        with torch.no_grad(), exact_fp32():
            for i in range(4):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{i}"), stride=2, padding=1))
            h = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=-1)
            return h @ self.proj


def make_feature_extractor(
    image_size: int, extractor: str = "auto", inception_weights: str = "",
    device: str | torch.device = "cuda",
) -> Tuple[FeatureExtractor, str]:
    """(extract, label); label is embedded in every report. The network
    takes images of any size (`image_size` is kept for `gea`'s signature)
    and lives on `device`: CUDA unless the caller asks for the CPU."""
    if inception_weights or extractor == "inception":
        raise RuntimeError(
            "true FID (InceptionV3) is not available in gea_torch: the port has no "
            "InceptionV3 network or weights and downloads nothing. Use "
            "--extractor random (the labelled proxy-FID) or gea's evaluator.")
    name = "random" if extractor == "auto" else extractor
    if name not in EXTRACTORS:
        raise ValueError(f"unknown extractor {extractor!r}; use auto, random or random-b")
    return RandomCNN(name).to(resolve_device(device)), EXTRACTORS[name]["label"]


# ----------------------------------------------------------------- KID


def compute_features(batches: Iterable, extract: FeatureExtractor, max_samples: int) -> np.ndarray:
    """Raw feature matrix (N, D) in float64: KID needs samples, not just
    moments."""
    feats = []
    seen = 0
    for batch in batches:
        f = extract(batch).cpu().numpy()
        take = min(f.shape[0], max_samples - seen)
        feats.append(f[:take].astype(np.float64))
        seen += take
        if seen >= max_samples:
            break
    if not feats:
        raise ValueError("no samples provided to compute_features")
    return np.concatenate(feats, axis=0)


def precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray,
                     k: int = 3) -> Tuple[float, float]:
    """Improved precision and recall (Kynkäänniemi et al. 2019): manifold
    membership through k-NN radii. Precision is the fraction of fakes
    inside the real manifold (fidelity), recall the fraction of reals
    inside the fake manifold (coverage)."""
    real = _pr_cap(real_feats)
    fake = _pr_cap(fake_feats)
    if min(real.shape[0], fake.shape[0]) <= k:
        raise ValueError(
            f"precision_recall needs > k={k} samples per side, got "
            f"{real.shape[0]} real / {fake.shape[0]} fake"
        )
    return (
        _pr_covered(fake, real, _pr_radii2(real, k)),  # precision
        _pr_covered(real, fake, _pr_radii2(fake, k)),  # recall
    )


def _pr_cap(x: np.ndarray, cap: int = 4096) -> np.ndarray:
    """Bound the dense NxM distance matrices (4096^2 f64 = 134 MB)."""
    x = np.asarray(x, np.float64)
    if x.shape[0] > cap:
        x = x[np.random.default_rng(0).choice(x.shape[0], cap, replace=False)]
    return x


def _pr_dist2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared euclidean distances by the |a|^2+|b|^2-2ab expansion, in
    O(N*M) memory."""
    d2 = np.sum(a * a, axis=1)[:, None] + np.sum(b * b, axis=1)[None, :] - 2.0 * (a @ b.T)
    return np.maximum(d2, 0.0)


def _pr_radii2(x: np.ndarray, k: int) -> np.ndarray:
    """Squared distance to each point's k-th nearest neighbor."""
    d2 = _pr_dist2(x, x)
    np.fill_diagonal(d2, np.inf)
    return np.partition(d2, k - 1, axis=1)[:, k - 1]


def _pr_covered(q: np.ndarray, ref: np.ndarray, ref_r2: np.ndarray) -> float:
    d2 = _pr_dist2(q, ref)
    return float(np.mean(np.any(d2 <= ref_r2[None, :], axis=1)))


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def kid_score(real_feats: np.ndarray, fake_feats: np.ndarray, subset_size: int = 256,
              n_subsets: int = 20, seed: int = 0) -> Tuple[float, float]:
    """Kernel Inception Distance (Binkowski et al. 2018) over these
    features: unbiased MMD^2 with the cubic kernel k(x,y) = (x.y/D + 1)^3,
    averaged over random subsets. Returns (mean, std across subsets)."""
    rng = np.random.default_rng(seed)
    m = min(subset_size, real_feats.shape[0], fake_feats.shape[0])
    scores = []
    for _ in range(n_subsets):
        x = real_feats[rng.choice(real_feats.shape[0], m, replace=False)]
        y = fake_feats[rng.choice(fake_feats.shape[0], m, replace=False)]
        kxx = _poly_kernel(x, x)
        kyy = _poly_kernel(y, y)
        kxy = _poly_kernel(x, y)
        mmd2 = (
            (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
            + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
            - 2.0 * kxy.mean()
        )
        scores.append(mmd2)
    return float(np.mean(scores)), float(np.std(scores))


# --------------------------------------------------------------- scoring


def compute_stats(batches: Iterable, extract: FeatureExtractor, max_samples: int) -> FIDStats:
    """Moments of the features of the first `max_samples` images of
    `batches` (tensors on any device, or numpy arrays)."""
    stats: Optional[FIDStats] = None
    seen = 0
    for batch in batches:
        feats = extract(batch).cpu().numpy()
        if stats is None:
            stats = FIDStats.empty(feats.shape[-1])
        take = min(feats.shape[0], max_samples - seen)
        stats.update(feats[:take])
        seen += take
        if seen >= max_samples:
            break
    if stats is None or seen == 0:
        raise ValueError("no samples provided to compute_stats")
    return stats


def compute_fid(real_batches: Iterable, fake_batches: Iterable, image_size: int,
                num_samples: int = 10_000, extractor: str = "auto", inception_weights: str = "",
                device: str | torch.device = "cuda") -> Tuple[float, str]:
    extract, label = make_feature_extractor(image_size, extractor, inception_weights, device)
    rs = compute_stats(real_batches, extract, num_samples)
    fs = compute_stats(fake_batches, extract, num_samples)
    return frechet_distance(rs.mean, rs.cov, fs.mean, fs.cov), label


class GroupAccumulator:
    """Streaming multi-metric accumulator for one image group (a fake
    stream, one LIS stage, one link of a correction chain): every enabled
    metric is fed from one feature extraction per batch."""

    def __init__(self, bundle: "MetricBundle"):
        self._b = bundle
        self.stats: Optional[FIDStats] = None
        self.stats_b: Optional[FIDStats] = None
        self.feats: list = []  # raw primary features (float64) for KID
        self.n = 0

    def update(self, images) -> None:
        """Images (B, H, W, 3) as a tensor on the extractor's device (or
        any device, or a numpy array)."""
        b = self._b
        feats = b.extract(images).cpu().numpy()
        if self.stats is None:
            self.stats = FIDStats.empty(feats.shape[-1])
        self.stats.update(feats)
        self.n += feats.shape[0]
        if b.extract_b is not None:
            self.feats.append(feats.astype(np.float64))
            fb = b.extract_b(images).cpu().numpy()
            if self.stats_b is None:
                self.stats_b = FIDStats.empty(fb.shape[-1])
            self.stats_b.update(fb)

    def consume(self, batches: Iterable, max_samples: int) -> None:
        """Drain up to max_samples images from a batch iterator."""
        for batch in batches:
            take = min(batch.shape[0], max_samples - self.n)
            self.update(batch[:take])
            if self.n >= max_samples:
                return
        if self.n == 0:
            raise ValueError("no samples provided")


class MetricBundle:
    """Every offline metric over shared feature extractions: one primary
    extractor (and with `second_opinion` the independent random-b network,
    KID and precision/recall) scored against one pass over the reals."""

    def __init__(self, image_size: int, extractor: str = "auto", inception_weights: str = "",
                 second_opinion: bool = False, device: str | torch.device = "cuda"):
        self.extract, self.label = make_feature_extractor(
            image_size, extractor, inception_weights, device)
        self.extract_b = self.label_b = None
        if second_opinion:
            self.extract_b, self.label_b = make_feature_extractor(image_size, "random-b",
                                                                  device=device)
        self.pr_k = 3  # k-NN manifold size for precision/recall
        self._reals: Optional[GroupAccumulator] = None
        self._rf = self._rf_pr = self._real_r2 = None

    def group(self) -> GroupAccumulator:
        return GroupAccumulator(self)

    def set_reals(self, batches: Iterable, max_samples: int) -> None:
        self._reals = self.group()
        self._reals.consume(batches, max_samples)
        # The real-side matrices once: row() runs per stage or link.
        self._rf = self._rf_pr = self._real_r2 = None
        if self.extract_b is not None:
            self._rf = np.concatenate(self._reals.feats, axis=0)
            self._reals.feats = []  # moments already accumulated
            self._rf_pr = _pr_cap(self._rf)
            if self._rf_pr.shape[0] > self.pr_k:
                self._real_r2 = _pr_radii2(self._rf_pr, self.pr_k)

    def row(self, g: GroupAccumulator, ndigits: int = 4) -> dict:
        """Metric dict for one group against the reals."""
        r = self._reals
        if r is None or r.stats is None or g.stats is None:
            raise ValueError("row() needs set_reals() and a group with samples")
        out = {"frechet": round(frechet_distance(r.stats.mean, r.stats.cov,
                                                 g.stats.mean, g.stats.cov), ndigits)}
        if self.extract_b is not None:
            out["frechet_b"] = round(frechet_distance(r.stats_b.mean, r.stats_b.cov,
                                                      g.stats_b.mean, g.stats_b.cov), ndigits)
            gf = np.concatenate(g.feats, axis=0)
            kid_mean, kid_std = kid_score(self._rf, gf)
            out["kid_x1000"] = round(kid_mean * 1000, ndigits)
            out["kid_x1000_std"] = round(kid_std * 1000, ndigits)
            # Fidelity and coverage over the same features; groups too small
            # for the k-NN radii report null.
            gf_pr = _pr_cap(gf)
            if self._real_r2 is not None and gf_pr.shape[0] > self.pr_k:
                out["precision"] = round(_pr_covered(gf_pr, self._rf_pr, self._real_r2), ndigits)
                out["recall"] = round(
                    _pr_covered(self._rf_pr, gf_pr, _pr_radii2(gf_pr, self.pr_k)), ndigits)
            else:
                out["precision"] = out["recall"] = None
        return out


class OnlineFID:
    """Real-side moments computed once, the fake side scored repeatedly: the
    trainers' `--fid_interval` tracker."""

    def __init__(self, real_batches: Iterable, image_size: int, num_samples: int = 1024,
                 extractor: str = "auto", inception_weights: str = "",
                 device: str | torch.device = "cuda"):
        self.extract, self.label = make_feature_extractor(
            image_size, extractor, inception_weights, device)
        self.num_samples = num_samples
        rs = compute_stats(real_batches, self.extract, num_samples)
        self._mu, self._cov = rs.mean, rs.cov

    def score(self, fake_batches: Iterable) -> float:
        fs = compute_stats(fake_batches, self.extract, self.num_samples)
        return frechet_distance(self._mu, self._cov, fs.mean, fs.cov)
