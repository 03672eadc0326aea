"""Throughput meter (port of `gea/utils/meters.py`)."""

from __future__ import annotations

import time
from typing import Dict, Optional


class ThroughputMeter:
    """Steps/s and images/s since the end of a warm-up of `warmup_steps`."""

    def __init__(self, batch_size: int, warmup_steps: int = 3) -> None:
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0: Optional[float] = None
        self._steps_timed = 0

    def tick(self, n: int = 1) -> bool:
        """Record n enqueued train steps. Returns True once, when the
        warm-up ends: the caller then waits for the device (on CUDA,
        `torch.cuda.synchronize()`) and calls `restart_timer`, so that the
        warm-up's queued work stays out of the timed window."""
        prev = self._count
        self._count += n
        if prev < self.warmup_steps <= self._count:
            self._t0 = time.perf_counter()
            return True
        if prev >= self.warmup_steps:
            self._steps_timed += n
        return False

    def restart_timer(self) -> None:
        self._t0 = time.perf_counter()

    def stats(self, num_chips: int = 1) -> Dict[str, float]:
        if self._t0 is None or self._steps_timed == 0:
            return {"steps_per_sec": 0.0, "images_per_sec": 0.0,
                    "images_per_sec_per_chip": 0.0}
        sps = self._steps_timed / (time.perf_counter() - self._t0)
        ips = sps * self.batch_size
        return {"steps_per_sec": sps, "images_per_sec": ips,
                "images_per_sec_per_chip": ips / max(1, num_chips)}
