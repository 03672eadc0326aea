"""Host -> device prefetch (port of `gea/data/prefetch.py`).

A background thread keeps `depth` batches ahead of the train loop. On a
CUDA device each host batch is copied into pinned memory and sent with a
`non_blocking` copy on a side stream; an event recorded after the copy is
what the consumer's stream waits on, so the copy overlaps the previous
steps' work and the loop blocks only when the queue is empty. On the CPU
batches pass through as tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np
import torch


# How long closing the iterator waits for its worker to finish a host batch.
CLOSE_TIMEOUT_S = 60.0
# The worker threads' name.
THREAD_NAME = "gea_torch-prefetch"


def device_prefetch(host_iter: Iterator[np.ndarray], device: torch.device,
                    depth: int = 2) -> Iterator[torch.Tensor]:
    """Wrap a host batch iterator; yields tensors on `device`, `depth`
    ahead. A worker error reaches the consumer. Closing the iterator (or
    dropping it) stops the worker thread and waits for it to end (at most
    CLOSE_TIMEOUT_S, for a host batch in progress)."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    failure: list = []
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(item) -> bool:
        """A bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch: np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if side is None:
            return host, None
        with torch.cuda.stream(side):
            # The pinned buffer stays reserved by the caching host
            # allocator until the copy that reads it has finished.
            t = host.pin_memory().to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return t, done

    def worker():
        try:
            for batch in host_iter:
                if stop.is_set() or not put(to_device(batch)):
                    return
        except BaseException as e:  # data errors reach the consumer
            failure.append(e)
        finally:
            put(None)

    thread = threading.Thread(target=worker, name=THREAD_NAME, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if failure:
                    raise RuntimeError("input pipeline worker failed") from failure[0]
                return
            t, done = item
            if done is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(done)
                # Allocated on the side stream, used on the compute stream:
                # the allocator must not hand its memory back to the side
                # stream before the compute stream's use has finished.
                t.record_stream(compute)
            yield t
    finally:
        stop.set()
        # The worker ends before the iterator does. Left running, a daemon
        # thread may be inside a torch call (a tensor made from or handed
        # back to numpy, a pinned copy) when the interpreter exits; torch
        # takes the GIL back in a C++ destructor there, and the process
        # aborts ("terminate called without an active exception"), as a
        # spawned rank did at the end of its run. A put waiting on the full
        # queue is released; a host batch in progress is waited for.
        deadline = time.monotonic() + CLOSE_TIMEOUT_S
        while thread.is_alive() and time.monotonic() < deadline:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=0.05)
