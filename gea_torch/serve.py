"""Serving with D-filtered (error-avoidance) sampling on the port's models.

The port of `gea/serve.py`'s `ServingModel` rendering surface, built from a
generator and an optional discriminator instead of a `jax.export` artifact:

    model = ServingModel(generator, discriminator)
    out = model(z)                    # images, stages (uint8), scores
    best = model.sample_filtered(64)  # top 64 of 256 candidates by D score

Every render stacks all LIS stages of a batch into one S*B batch; the
discriminator scores the final stage. z is drawn on the host with numpy
exactly as `gea` draws it, so both packages render the same codes from the
same seed. Arrays come back as numpy, as in `gea`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gea_torch.models import Discriminator, GeneratorLIS


def _take(out: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    """Select candidate indices from a render dict (stages are (S, B, ...))."""
    return {k: (v[:, idx] if k == "stages" else v[idx]) for k, v in out.items()}


def _cat(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]):
    return {
        k: np.concatenate([a[k], b[k]], axis=1 if k == "stages" else 0) for k in a
    }


def topk_rounds(draw, count: int, threshold: float = 0.0, max_rounds: int = 1):
    """Call ``draw(round)`` for fresh candidate dicts (with "scores"), keep a
    running top-``count`` by descending score, and stop once every kept
    sample clears ``threshold`` (or after ``max_rounds``). Returns
    (best, rounds_run); ``best`` is sorted by descending score."""
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    best: Optional[Dict[str, np.ndarray]] = None
    rounds = 0
    for r in range(1 if threshold <= 0 else max_rounds):
        out = draw(r)
        best = out if best is None else _cat(best, out)
        order = np.argsort(best["scores"])[::-1][:count]
        best = _take(best, order)
        rounds = r + 1
        if threshold <= 0 or (best["scores"] >= threshold).all():
            break
    if best is None:
        raise RuntimeError("topk_rounds drew no candidates")
    return best, rounds


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255], clipped, with a truncating cast."""
    return ((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


class ServingModel:
    """Renders z into a dict of numpy arrays:

      images  uint8 (B, H, W, 3)        final LIS stage
      stages  uint8 (S, B, H, W, 3)     every LIS stage
      scores  float32 (B,)              sigmoid D realism (with a discriminator)
    """

    def __init__(self, generator: GeneratorLIS,
                 discriminator: Optional[Discriminator] = None):
        self.generator = generator.eval()
        self.discriminator = discriminator.eval() if discriminator is not None else None
        self.device = generator.device

    @property
    def code_size(self) -> int:
        return self.generator.cfg.code_size

    @property
    def image_size(self) -> int:
        return self.generator.cfg.image_size

    @property
    def spatial_noise_shape(self) -> Optional[tuple]:
        sn = self.generator.spatial_noise_shape(1)
        return sn[1:] if sn else None

    def __call__(self, z: np.ndarray, spatial_noise: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
        z = np.asarray(z, np.float32)
        if z.ndim != 2 or z.shape[1] != self.code_size:
            raise ValueError(f"z must be (batch, {self.code_size}), got {z.shape}")
        if self.spatial_noise_shape is not None:
            if spatial_noise is None:
                raise ValueError(
                    "this generator takes spatial noise; pass spatial_noise of "
                    f"shape (batch, *{self.spatial_noise_shape})"
                )
        elif spatial_noise is not None:
            raise ValueError("this generator takes no spatial noise")
        with torch.inference_mode():
            zt = torch.from_numpy(z).to(self.device)
            sn = None
            if spatial_noise is not None:
                sn = torch.from_numpy(np.asarray(spatial_noise, np.float32)).to(self.device)
            images, _ = self.generator.render(zt, sn)
            out = {"images": to_uint8(images[-1]), "stages": to_uint8(images)}
            if self.discriminator is not None:
                out["scores"] = torch.sigmoid(self.discriminator(images[-1])).float()
            return {k: v.cpu().numpy() for k, v in out.items()}

    def sample(self, count: int, seed: int = 0, batch_size: int = 64
               ) -> Dict[str, np.ndarray]:
        """Draw z ~ N(0, 1) with numpy and render `count` samples in batches."""
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        rng = np.random.default_rng(seed)
        chunks = []
        done = 0
        while done < count:
            n = min(batch_size, count - done)
            z = rng.standard_normal((n, self.code_size)).astype(np.float32)
            sn = None
            if self.spatial_noise_shape is not None:
                sn = rng.standard_normal((n, *self.spatial_noise_shape)).astype(np.float32)
            chunks.append(self(z, sn))
            done += n
        return {
            k: np.concatenate([c[k] for c in chunks], axis=1 if k == "stages" else 0)
            for k in chunks[0]
        }

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
        absolute cutoff assumes BCE-calibrated sigmoid scores."""
        if self.discriminator is None:
            raise ValueError(
                "this model carries no discriminator; build it with one to "
                "enable filtered sampling"
            )
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if oversample < 1:
            raise ValueError(f"oversample must be >= 1, got {oversample}")
        if max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
        n_cand = int(count * oversample)
        best, rounds = topk_rounds(
            lambda r: self.sample(n_cand, seed=seed + r, batch_size=batch_size),
            count,
            threshold=threshold,
            max_rounds=max_rounds,
        )
        if threshold > 0:
            cleared = int((best["scores"] >= threshold).sum())
            if cleared < count:
                print(
                    f"[gea_torch.serve] d_threshold={threshold}: only "
                    f"{cleared}/{count} candidates cleared it after {rounds} "
                    "rounds; filling from the best rejects"
                )
        return best
