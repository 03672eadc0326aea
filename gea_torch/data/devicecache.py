"""Dataset resident in device memory (`--device_data_cache`; port of
`gea/data/devicecache.py`).

The decoded dataset, the `[N, decode, decode, 3]` uint8 array that
`CachedFolderDataset` builds, is copied to the device once. Each step then
sends only the batch's indices from `epoch_permutation` and gathers the
batch on the device, so batch i is the same pure function of (seed, i) as
on the streaming path, byte for byte. CelebA at decode 160 is about
202,599 x 160 x 160 x 3 = 15.6 GB, which fits beside the flagship model in
an H100's 80 GB. `--host_resize` is moot here: nothing streams, and the
device preprocess resizes.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from gea_torch.data.pipeline import make_dataset, shuffled_indices


def device_cached_iterator(cfg, device: torch.device, seed: int,
                           start_step: int = 0) -> Iterator[torch.Tensor]:
    """Endless (B, d, d, 3) uint8 batches gathered on `device` from the
    resident dataset."""
    if cfg.multihost:
        raise ValueError("--device_data_cache is single-host; use --data_cache")
    if not cfg.on_device_pipeline:
        raise ValueError(
            "--device_data_cache requires the on-device preprocess "
            "(--on_device_pipeline true): the cache holds raw uint8 and "
            "the crop/resize/flip must run on the device"
        )
    ds = make_dataset(cfg.replace(data_cache=True), seed=seed)
    if not hasattr(ds, "data"):
        raise ValueError(f"--device_data_cache needs a cacheable dataset, got "
                         f"{type(ds).__name__} (dataset={cfg.dataset!r})")
    n = len(ds.data)
    print(f"[gea_torch] --device_data_cache: {n} images x {ds.data.shape[1]}px -> "
          f"{ds.data.nbytes / 1e9:.2f} GB resident on {device} (index-only input "
          "transfer from here on)", flush=True)
    cache = torch.from_numpy(np.ascontiguousarray(ds.data)).to(device)
    del ds

    def gen() -> Iterator[torch.Tensor]:
        for idx in shuffled_indices(seed, n, cfg.batch_size, start_step):
            yield cache.index_select(0, torch.from_numpy(idx).to(device, non_blocking=True))

    return gen()
