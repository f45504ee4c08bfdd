"""The multi-rank tests' harness: a gloo rendezvous broken by a stray
connection starts the ranks again; every other failure is raised.

A connection from another process to a rank's gloo listener during the
full-mesh connect fails the group with "Gloo connectFullMesh failed ...
Connection closed by peer" (seen under the suite's parallel workers, in
the 4-rank fixture of ``test_torch_dist_moe_lm.py``).  No jax here.
"""

import os

import pytest
import torch.multiprocessing as mp

import torch_dist_helpers as H

BROKEN = ("Gloo connectFullMesh failed with [pair.cc:553] Connection "
          "closed by peer [127.0.0.1]:18052.")


def _failing(messages):
    """A start function that raises ``messages`` in turn, then returns."""
    calls = []

    def start(value):
        calls.append(value)
        if len(calls) <= len(messages):
            raise mp.ProcessRaisedException(messages[len(calls) - 1], 0, 1)
        return value

    return start, calls


def test_broken_rendezvous_starts_the_ranks_again(capsys):
    start, calls = _failing([BROKEN, BROKEN])
    assert H.rendezvous_retried(start, "done") == "done"
    assert len(calls) == H.SPAWN_ATTEMPTS == 3
    assert capsys.readouterr().err.count("gloo rendezvous broken") == 2


@pytest.mark.parametrize("messages,calls_made", [
    (["AssertionError: rank 1 disagrees"], 1),
    ([BROKEN] * 3, 3),
], ids=["other_failure", "broken_every_time"])
def test_other_failures_and_the_last_attempt_raise(messages, calls_made):
    start, calls = _failing(messages)
    with pytest.raises(mp.ProcessRaisedException) as err:
        H.rendezvous_retried(start, "never")
    assert str(err.value) == messages[-1]
    assert len(calls) == calls_made


def _fails_once(rank, world, marker):
    """Rank 1 raises the rendezvous failure on the first start only."""
    if rank == 1 and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError(BROKEN)
    return rank * 10


def test_spawn_runs_the_ranks_again_after_a_broken_rendezvous(tmp_path):
    marker = str(tmp_path / "failed-once")
    assert H.spawn(_fails_once, 2, tmp_path / "ranks", marker) == [0, 10]
    assert os.path.exists(marker)
