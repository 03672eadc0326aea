"""`gea_torch.parallel.spawn`'s rendezvous on the CPU: the group meets at a
store that the parent holds on a port the OS gave it, so no port is chosen
first and bound later by a rank, where another process (another test's
gloo group, under a parallel test run) could take it in between.

Every spawn has a timeout that fails the test on a hang."""

import socket
import threading

import torch
import torch_port_spawn_workers as workers

from gea_torch.parallel import mesh, spawn

SPAWN_TIMEOUT_S = 120


def test_a_port_taken_by_another_process_does_not_stop_the_group(monkeypatch):
    """The port `free_port` hands out is taken before the ranks start (here
    by a listening socket of this process): the group still meets."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        monkeypatch.setattr(mesh, "free_port", lambda: taken.getsockname()[1])
        assert spawn(workers.rank_sum, 2, torch.device("cpu"), args=(7,),
                     timeout=SPAWN_TIMEOUT_S) == (7, 2, 3.0)


def test_concurrent_spawns_each_meet_their_own_group():
    """Three 2-rank groups started at once in one process, as parallel test
    workers start theirs: each meets its own ranks and ends in time."""
    results, errors = {}, []

    def run(tag):
        try:
            results[tag] = spawn(workers.rank_sum, 2, torch.device("cpu"), args=(tag,),
                                 timeout=SPAWN_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append((tag, repr(e)))

    threads = [threading.Thread(target=run, args=(tag,)) for tag in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SPAWN_TIMEOUT_S + 30)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == {tag: (tag, 2, 3.0) for tag in range(3)}
