"""Host-side dataset iteration (port of `gea/data/pipeline.py`).

A folder of JPEGs is decoded by the native C++ pool where its library
builds (`gea_torch/data/native_loader.py`, `--data_backend auto|native`),
any other folder by a thread pool with PIL (which releases the GIL inside
decode); batches go to the device as uint8 and the crop, resize, flip and
normalise run there (`gea_torch/data/ondevice.py`). A `synthetic` mode
yields deterministic pseudo-images.

Every stream is counter-based: batch i of a seeded stream is a pure
function of (seed, i), and epoch e's shuffle is
`default_rng([seed, e]).permutation(n)`, so `batches(start_batch=N)`
restarts mid-stream without decoding the skipped prefix (the native pool
has an order of its own, also a pure function of (seed, i)). The bytes are
those of `gea`'s streams for the same arguments and backend. The trainer
fast-forwards the stream to the resumed step, which makes resume
deterministic.

Not ported yet: `gea`'s grain loader and its LSUN reader.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np

from gea_torch.data import native_loader

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def require_enough_images(n: int, batch_size: int, what: str) -> None:
    """Fail fast when a dataset cannot fill one batch: the epoch loops
    below would otherwise spin forever yielding nothing."""
    if n < batch_size:
        raise ValueError(
            f"{what} has {n} images but batch_size is {batch_size}; "
            "reduce --batch_size or provide more data"
        )


def epoch_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """Shuffle order for epoch `epoch` of a seeded stream, a pure function
    of (seed, epoch)."""
    return np.random.default_rng([seed, epoch]).permutation(n)


def list_images(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if fn.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(dirpath, fn))
    if not out:
        raise FileNotFoundError(f"no images found under {root!r}")
    return out


def _decode(path: str, crop_size: int, out_size: int) -> np.ndarray:
    """Decode to RGB uint8, center-crop `crop_size` pixels at native
    resolution and resize the crop to an `out_size` square.

    crop_size <= 0, or an image smaller than crop_size, takes the largest
    centered square. A JPEG is decoded at a reduced scale (PIL's draft)
    only when the crop still holds at least 2 * out_size pixels; the crop
    and resize are then one bilinear box-resize pass."""
    from PIL import Image

    with Image.open(path) as im:
        w0, h0 = im.size
        cs = min(w0, h0) if crop_size <= 0 else min(crop_size, w0, h0)
        if im.format == "JPEG" and cs >= 2 * out_size:
            im.draft("RGB", (max(1, w0 * out_size // cs), max(1, h0 * out_size // cs)))
        im = im.convert("RGB")
        w, h = im.size  # draft may have shrunk the decode resolution
        if (w, h) == (w0, h0):
            # Integer center crop (torchvision's rounding), then bilinear.
            left = int(round((w0 - cs) / 2.0))
            top = int(round((h0 - cs) / 2.0))
            im = im.crop((left, top, left + cs, top + cs))
            if cs != out_size:
                im = im.resize((out_size, out_size), Image.BILINEAR)
        else:
            # Prescaled decode: the crop box is fractional in decoded coords.
            sx, sy = w / w0, h / h0
            left, top = (w0 - cs) / 2 * sx, (h0 - cs) / 2 * sy
            im = im.resize((out_size, out_size), Image.BILINEAR,
                           box=(left, top, left + cs * sx, top + cs * sy))
        return np.asarray(im, dtype=np.uint8)


def shuffled_indices(seed: int, n: int, batch_size: int, start_batch: int) -> Iterator[np.ndarray]:
    """Endless index batches of a counter-based shuffled stream, dropping
    each epoch's ragged remainder."""
    bpe = n // batch_size
    i = start_batch
    epoch, order = -1, None
    while True:
        e, off = divmod(i, bpe)
        if e != epoch:
            epoch, order = e, epoch_permutation(seed, e, n)
        yield order[off * batch_size:(off + 1) * batch_size]
        i += 1


class FolderDataset:
    """Endless shuffled uint8 batches (batch_size, decode_size,
    decode_size, 3) over an image folder, each image already the native
    resolution center crop."""

    def __init__(self, root: str, batch_size: int, crop_size: int, decode_size: int,
                 workers: int = 4, seed: int = 0):
        self.paths = list_images(root)
        require_enough_images(len(self.paths), batch_size, root)
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.decode_size = decode_size
        self.seed = seed
        self.pool = ThreadPoolExecutor(max_workers=max(1, workers))

    def __len__(self) -> int:
        return len(self.paths)

    def batches(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        for idx in shuffled_indices(self.seed, len(self.paths), self.batch_size, start_batch):
            yield np.stack(list(self.pool.map(
                lambda j: _decode(self.paths[j], self.crop_size, self.decode_size), idx)))


class SyntheticDataset:
    """Deterministic pseudo-images: smooth colored gradients plus noise."""

    def __init__(self, batch_size: int, decode_size: int, seed: int = 0):
        self.batch_size = batch_size
        self.decode_size = decode_size
        self.seed = seed

    def __len__(self) -> int:
        return 10_000

    def batches(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        s = self.decode_size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        i = start_batch
        while True:
            rng = np.random.default_rng([self.seed, i])
            phase = rng.random((self.batch_size, 1, 1, 3), dtype=np.float32)
            base = 0.5 + 0.5 * np.sin(
                2 * np.pi * (yy[None, :, :, None] * phase + xx[None, :, :, None]))
            noise = rng.random(base.shape, dtype=np.float32) * 0.1
            yield (np.clip(base + noise, 0, 1) * 255).astype(np.uint8)
            i += 1


class ArrayDataset:
    """Shuffled batches of an in-memory uint8 array `data` (the CIFAR-10
    reader, the decoded folder cache)."""

    def __init__(self, data: np.ndarray, batch_size: int, seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.data)

    def batches(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        for idx in shuffled_indices(self.seed, len(self.data), self.batch_size, start_batch):
            yield self.data[idx]


def all_jpeg(paths: List[str]) -> bool:
    return all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)


class CachedFolderDataset(ArrayDataset):
    """The whole folder decoded once into one uint8 array, by the native
    decode where its library builds and every file is a JPEG, else by PIL
    (threads either way, as `gea`'s); shuffled batches are then served
    from memory."""

    def __init__(self, root: str, batch_size: int, crop_size: int, decode_size: int,
                 workers: int = 4, seed: int = 0):
        paths = list_images(root)
        require_enough_images(len(paths), batch_size, root)
        data = np.empty((len(paths), decode_size, decode_size, 3), np.uint8)
        decode = _decode
        if all_jpeg(paths) and native_loader.native_available():
            decode = native_loader.decode_square
        self.backend = "native" if decode is not _decode else "pil"
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            for i, arr in enumerate(pool.map(
                    lambda p: decode(p, crop_size, decode_size), paths)):
                data[i] = arr
        super().__init__(data, batch_size, seed)


def device_crop_size(cfg) -> int:
    """Crop the device or host preprocess applies after decode. Folder
    batches are already center-cropped inside decode, so their crop is a
    no-op (decode_size); synthetic and cifar10 batches get the configured
    crop."""
    decode_size = max(cfg.crop_size, cfg.image_size)
    return decode_size if cfg.dataset in ("folder", "lsun") else cfg.crop_size


def make_dataset(cfg, seed: int = 0):
    """The host dataset of a train config (dataset, dataroot, batch_size,
    crop_size, image_size, data_workers, data_cache, data_backend)."""
    decode_size = max(cfg.crop_size, cfg.image_size)
    if cfg.dataset == "synthetic":
        return SyntheticDataset(cfg.batch_size, decode_size, seed=seed)
    if cfg.dataset == "folder":
        args = (cfg.dataroot, cfg.batch_size, cfg.crop_size, decode_size)
        if cfg.data_cache:
            return CachedFolderDataset(*args, workers=cfg.data_workers, seed=seed)
        if cfg.data_backend not in ("auto", "native", "pil"):
            raise ValueError(f"data_backend {cfg.data_backend!r} is not ported to "
                             "gea_torch yet; use auto, native or pil")
        if cfg.data_backend in ("auto", "native"):
            loader = _try_native_loader(*args, workers=cfg.data_workers, seed=seed)
            if loader is not None:
                return loader
            if cfg.data_backend == "native":
                raise RuntimeError(
                    "native data backend requested but unavailable "
                    "(no toolchain/libjpeg, or non-JPEG files in folder)"
                )
        return FolderDataset(*args, workers=cfg.data_workers, seed=seed)
    if cfg.dataset == "cifar10":
        return cifar10_dataset(cfg, seed)
    raise ValueError(f"dataset {cfg.dataset!r} is not ported to gea_torch yet")


def _try_native_loader(root: str, batch_size: int, crop_size: int, decode_size: int,
                       workers: int, seed: int) -> Optional[native_loader.NativeFolderLoader]:
    """The C++ pool over `root` when its library builds and every file is
    a JPEG; None otherwise (`gea`'s `_try_native_loader`)."""
    if not native_loader.native_available():
        return None
    paths = list_images(root)
    if not all_jpeg(paths):
        return None
    try:
        return native_loader.NativeFolderLoader(paths, batch_size, crop_size, decode_size,
                                                workers=workers, seed=seed)
    except RuntimeError:
        return None


def backend_of(dataset) -> str:
    """Which decode a folder dataset of `make_dataset` runs: "native" or
    "pil" (and "none" for a dataset that decodes nothing)."""
    if isinstance(dataset, native_loader.NativeFolderLoader):
        return "native"
    if isinstance(dataset, FolderDataset):
        return "pil"
    return getattr(dataset, "backend", "none")


def cifar10_dataset(cfg, seed: int) -> ArrayDataset:
    """CIFAR-10 from a local extracted copy: the python pickle batches
    `data_batch_*` under cfg.dataroot."""
    arrays = []
    for name in sorted(os.listdir(cfg.dataroot)):
        if name.startswith("data_batch"):
            with open(os.path.join(cfg.dataroot, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            arrays.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
    if not arrays:
        raise FileNotFoundError(f"no CIFAR-10 data_batch files under {cfg.dataroot!r}")
    data = np.concatenate(arrays).astype(np.uint8)
    require_enough_images(len(data), cfg.batch_size, "cifar10")
    return ArrayDataset(data, cfg.batch_size, seed)
