"""Graceful preemption for the port's trainer — counterpart of
``container_engine_accelerators_tpu/utils/preempt.py``.

Kubernetes drains a node for maintenance with SIGTERM and a grace
period.  The trainer converts that signal into a final checkpoint and an
exit with code 80 (the maintenance event's code): a Job that saw exit 0
would count the pod as complete and never reschedule it, while a
non-zero code restarts it, and the restart resumes from the checkpoint.

Usage::

    with PreemptionGuard() as guard:   # installs the SIGTERM handler
        for step in range(start, steps):
            state, metrics = step_fn(state, ...)
            if guard.should_stop:
                checkpoint_and_exit(checkpointer, state, step,
                                    args.checkpoint_interval, profiling)

Without ``--checkpoint-dir`` the trainer passes None as the checkpointer:
progress is lost, and the exit code still asks for a restart.
"""

import logging
import signal
import threading

import torch

log = logging.getLogger(__name__)

# The node agent's maintenance event code, seen from inside the workload.
PREEMPTED_EXIT_CODE = 80


class PreemptionGuard:
    """Latch SIGTERM into a flag the training loop polls between steps.

    The handler only sets an event and never saves from signal context:
    the main thread may be inside a step, and the save must run on the
    thread that owns the tensors.  Polling between steps bounds the
    reaction time to one train step.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._signum = None
        self._previous = {}
        for s in signals:
            self._previous[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):  # noqa: ARG002 — signal signature
        self._signum = signum
        self._stop.set()
        log.warning("received signal %d: will checkpoint and exit %d "
                    "after the current step", signum, PREEMPTED_EXIT_CODE)

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    @property
    def signum(self):
        return self._signum

    def uninstall(self) -> None:
        """Restore the previous handlers."""
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


def checkpoint_and_exit(checkpointer, state, step: int,
                        checkpoint_interval: int, profiling=None):
    """The trainer's SIGTERM tail: stop an active profile (``profiling``,
    anything with a ``stop()`` that ends and writes the trace), wait for
    the device, save a final checkpoint unless the interval save already
    covered ``step`` (the loop index just completed), then exit for a Job
    restart.  Always raises ``SystemExit`` with
    :data:`PREEMPTED_EXIT_CODE`."""
    if profiling:
        profiling.stop()
    if checkpointer:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if (step + 1) % checkpoint_interval != 0:
            checkpointer.save(state, wait=True)
        checkpointer.close()
        log.warning("preempted at step %d: checkpoint saved; exiting "
                    "%d for Job restart + resume", step + 1,
                    PREEMPTED_EXIT_CODE)
    else:
        log.warning("preempted at step %d with no --checkpoint-dir: "
                    "progress is lost", step + 1)
    raise SystemExit(PREEMPTED_EXIT_CODE)
