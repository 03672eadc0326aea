"""Closing the host -> device prefetch (`gea_torch.data.prefetch.device_prefetch`)
ends its worker thread before `close()` returns.

Why: the worker is a daemon thread that turns host batches into tensors
(`torch.from_numpy`; on a card a pinned copy). A process that exits while
such a thread is inside a torch call aborts: torch takes the GIL back in a
C++ destructor, the exiting interpreter ends the thread there, and the
C++ runtime terminates ("terminate called without an active exception",
SIGABRT). A spawned data-parallel rank exits right after its run, so a
worker left running made `spawn` fail with "process 1 terminated with
signal SIGABRT" now and then (`tests/test_torch_port_parallel_cli.py`'s
world-2 resume case, in loaded test runs). `test_close_ends_the_worker`
fails on the port before the repair: its worker outlived `close()` by up
to half a second."""

import gc
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from gea_torch.data.prefetch import THREAD_NAME, device_prefetch

BATCH = np.zeros((4, 8, 8, 3), np.uint8)


def endless(delay: float = 0.0):
    while True:
        if delay:
            time.sleep(delay)
        yield BATCH


def workers() -> set:
    """The prefetch worker threads alive in this process (an iterator of
    another test may have left its own: each case reads only the workers
    that appear after its `before`)."""
    return {t for t in threading.enumerate() if t.name == THREAD_NAME}


def test_close_ends_the_worker():
    """The queue full and the worker waiting to put its next batch: after
    `close()` no thread of the iterator is left."""
    before = workers()
    it = device_prefetch(endless(), torch.device("cpu"), depth=3)
    for _ in range(2):
        assert torch.equal(next(it), torch.from_numpy(BATCH))
    time.sleep(0.2)  # the worker refills the queue and waits on it
    assert workers() - before
    it.close()
    assert not workers() - before


def test_close_waits_for_a_batch_in_progress():
    """A host batch that takes a while: `close()` returns once the worker
    has finished it and ended."""
    before = workers()
    it = device_prefetch(endless(delay=0.3), torch.device("cpu"), depth=1)
    next(it)
    t0 = time.monotonic()
    it.close()
    assert not workers() - before
    assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("how", ["exhausted", "dropped"])
def test_the_worker_ends_with_the_iterator(how):
    """A finite host stream read to its end, or an iterator dropped
    without `close()` (its frame is finalised): no worker is left."""
    before = workers()
    if how == "exhausted":
        got = list(device_prefetch(iter([BATCH] * 5), torch.device("cpu"), depth=2))
        assert len(got) == 5
    else:
        it = device_prefetch(endless(), torch.device("cpu"), depth=2)
        next(it)
        del it
        gc.collect()
    assert not workers() - before


def test_a_process_that_closes_its_iterators_exits_cleanly():
    """Runs that each close their prefetch at the end, as a spawned rank's
    two resumed runs do, then the interpreter exits: exit code 0, no
    abort, every time."""
    code = textwrap.dedent("""
        import numpy as np, torch
        from gea_torch.data.prefetch import THREAD_NAME, device_prefetch
        batch = np.zeros((16, 32, 32, 3), np.uint8)
        def endless():
            while True:
                yield batch[:, 1:31, 1:31]
        for run in range(2):
            it = device_prefetch(endless(), torch.device("cpu"), depth=3)
            for _ in range(20):
                next(it)
            it.close()
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=root) for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        assert "terminate called" not in err
