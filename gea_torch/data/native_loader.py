"""The native C++ JPEG loader (port of `gea/data/native_loader.py`).

A C++ worker pool (`gea_torch/csrc/loader.cpp`, `gea`'s source) decodes,
prescales in the DCT domain and center-crops JPEGs into a ring of uint8
batch buffers; Python copies out the ready batch, so the GIL never gates
the decode. `decode_square` is its one-image decode; `NativeFolderLoader`
yields the same uint8 batches (batch_size, decode_size, decode_size, 3) as
`FolderDataset`, which the runner, the prefetch and the device cache take
alike.

The pool shuffles with its own `std::mt19937_64` in ticket order, and its
batches run across epoch boundaries: the order is `gea`'s native order, not
`epoch_permutation`'s. Batch i is still a pure function of (seed, i), so
`batches(start_batch=N)` restarts the stream without decoding the skipped
prefix.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Sequence

import numpy as np

from gea_torch.data.native_build import load_library


def native_available() -> bool:
    return load_library() is not None


def decode_square(path: str, crop_size: int, out_size: int) -> np.ndarray:
    """One image: decode, center-crop `crop_size` pixels at native
    resolution, resize to an (out_size, out_size, 3) uint8 square."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    out = np.empty((out_size, out_size, 3), np.uint8)
    rc = lib.gea_decode_square(path.encode(), crop_size, out_size,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"native decode failed for {path!r}")
    return out


class NativeFolderLoader:
    """Endless shuffled uint8 batches from the C++ pool, each image already
    the native-resolution center crop. The pool starts at the first
    `batches()` call, at that call's batch; it is one pool, so a later call
    at another batch raises."""

    def __init__(self, paths: Sequence[str], batch_size: int, crop_size: int,
                 decode_size: int, workers: int = 4, seed: int = 0):
        from gea_torch.data.pipeline import require_enough_images

        require_enough_images(len(paths), batch_size, "native loader input")
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.decode_size = decode_size
        self.workers = workers
        self.seed = seed
        self.paths: List[bytes] = [p.encode() for p in paths]
        self._handle = None
        self._start_batch: Optional[int] = None

    def __len__(self) -> int:
        return len(self.paths)

    def _ensure_handle(self, start_batch: int) -> None:
        if self._handle is not None:
            if start_batch != self._start_batch:
                raise ValueError(
                    "NativeFolderLoader streams from one shared C++ pool; it was started "
                    f"at batch {self._start_batch} and cannot restart at {start_batch}")
            return
        arr = (ctypes.c_char_p * len(self.paths))(*self.paths)
        self._handle = self._lib.gea_loader_create(
            arr, len(self.paths), self.batch_size, self.crop_size, self.decode_size,
            self.workers, self.seed, start_batch)
        if not self._handle:
            self._handle = None
            raise RuntimeError("gea_loader_create failed")
        self._start_batch = start_batch

    def batches(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        self._ensure_handle(start_batch)
        s = self.decode_size
        while True:
            out = np.empty((self.batch_size, s, s, 3), np.uint8)
            rc = self._lib.gea_loader_next(self._handle,
                                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc != 0:
                return
            yield out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.gea_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
