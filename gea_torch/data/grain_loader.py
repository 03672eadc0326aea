"""The grain loader, `--data_backend grain` (port of
`gea/data/grain_loader.py`).

`grain.MapDataset` over the folder's file list, with `gea`'s chain:
`source(paths).shuffle(seed).repeat(None).map(decode).batch(batch_size,
drop_remainder=True)`, iterated with `num_threads` workers. The decode is
the port's PIL `_decode`, which equals `gea`'s bit for bit, so the batches
are `gea`'s. The iterator is index-addressed: `batches(start_batch)`
restarts at batch `start_batch` without decoding the skipped prefix.

`grain` imports `jax` wherever JAX is installed, so it is imported here
only when a loader is made; without it that raises (no fallback to PIL).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from gea_torch.data.pipeline import _decode, require_enough_images


class GrainFolderLoader:
    """Endless uint8 batches (batch_size, decode_size, decode_size, 3) of
    a shuffled file list, reshuffled each epoch."""

    backend = "grain"

    def __init__(self, paths: List[str], batch_size: int, crop_size: int, decode_size: int,
                 workers: int = 4, seed: int = 0):
        import grain

        # grain repeats without end: a list shorter than a batch would
        # fill batches with duplicates.
        require_enough_images(len(paths), batch_size, "grain loader input")
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.decode_size = decode_size
        self._paths = list(paths)
        ds = (grain.MapDataset.source(self._paths)
              .shuffle(seed=seed)
              .repeat(None)
              .map(lambda p: _decode(p, crop_size, decode_size))
              .batch(batch_size, drop_remainder=True))
        self._iter_dataset = ds.to_iter_dataset(
            grain.ReadOptions(num_threads=max(1, workers), prefetch_buffer_size=4))

    def __len__(self) -> int:
        return len(self._paths)

    def batches(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        it = iter(self._iter_dataset)
        if start_batch:
            it.set_state({"next_index": int(start_batch)})
        for batch in it:
            yield np.asarray(batch)
