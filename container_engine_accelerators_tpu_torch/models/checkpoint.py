"""Checkpoint/resume for the port's trainer — counterpart of
``container_engine_accelerators_tpu/models/checkpoint.py``.

A restarted training pod (a node drain, a preemption) must continue from
its last saved step, not from step 0.  :class:`TrainCheckpointer` keeps
one directory per step under ``directory``, ``<directory>/<step>/
state.pt``, a ``torch.save`` of the step and the model's and the
optimizer's state dicts, and the newest ``max_to_keep`` of them.

A save is atomic: it writes into a temporary directory beside the steps
and ``os.replace``-s it into place, so a step either landed whole or is
absent, whatever kills the writer.  The server (``cmd/serve_lm.py
--checkpoint-dir``) restores the same files through the same class.

A file does not depend on the layout it was trained under.  A state
sharded over a mesh (``parallel/mesh.py``) is gathered whole on every
rank, rank 0 alone writes it, in the same format and with the same
atomic rename and fsyncs, and the other ranks wait for its outcome (an
error is raised on every rank).  A restore reads the file on every rank
and lays each tensor out as the state's own parameter is laid out, so a
checkpoint of a 2-rank FSDP run restores on one GPU and the other way
round.
"""

import logging
import os
import shutil
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from container_engine_accelerators_tpu_torch.models.train import TrainState
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    broadcast_control,
    full,
)
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"

# Checkpoint targets are typically network mounts that flap under node
# pressure; a failed interval save must not kill a training job that
# could checkpoint fine 100ms later.  Small budget: a save that fails 3
# times is a real outage and should surface.
SAVE_RETRY = RetryPolicy(max_attempts=3, initial_backoff_s=0.2,
                         max_backoff_s=2.0)


def _whole_tree(state: TrainState) -> dict:
    """The state as one layout-free tree of plain tensors: every DTensor
    gathered whole (a collective: every rank calls this, in one order),
    a plain tensor as it is."""
    opt = state.optimizer.state_dict()
    opt["state"] = {i: {k: full(v) for k, v in entry.items()}
                    for i, entry in opt["state"].items()}
    return {"step": int(state.step),
            "model": {k: full(v) for k, v in state.model.state_dict().items()},
            "optimizer": opt}


def _lay_out(value, like):
    """``value`` (whole, on the CPU) laid out as ``like`` is: a DTensor of
    ``like``'s placements, or ``value`` itself when ``like`` is a plain
    tensor (or absent)."""
    if isinstance(like, DTensor):
        return distribute_tensor(value.to(like.device), like.device_mesh,
                                 like.placements)
    return value


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainCheckpointer:
    """Save/restore a :class:`TrainState` under ``directory`` keyed by
    step.  One writer per directory (the trainer); readers (the server)
    only restore.  The writer removes the temporary directories of a
    writer that died mid-save after its own next commit."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write(self, step: int, tree: dict) -> None:
        """One attempt: write into a temporary directory, fsync, rename it
        to the step's directory, then drop the steps past ``max_to_keep``
        and any temporary directory left behind."""
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)  # an earlier failed attempt
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self.directory)
        stale = [n for n in os.listdir(self.directory)
                 if n.startswith(_TMP_PREFIX)]
        for name in stale + [str(s) for s in
                             self.all_steps()[:-self.max_to_keep]]:
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)

    def save(self, state: TrainState, wait: bool = False) -> None:
        """Save ``state`` at ``state.step``.  The write is synchronous, so
        ``wait`` (the JAX checkpointer's asynchronous-save flag) changes
        nothing.  A step already on disk is not written again."""
        del wait
        step = int(state.step)
        tree = _whole_tree(state)
        if not dist.is_initialized():
            self._save_tree(step, tree)
            return
        error = None
        if dist.get_rank() == 0:
            try:
                self._save_tree(step, tree)
            except Exception as e:  # noqa: BLE001 — raised on every rank
                error = e
        error = broadcast_control(error)
        if error is not None:
            raise error

    def _save_tree(self, step: int, tree: dict) -> None:
        # Transient filesystem faults (and the armed ``checkpoint.save``
        # site) retry under a small budget.  A failed attempt may still
        # have committed (the error hit after the rename), so each retry
        # first checks whether the step already landed.
        last: Optional[Exception] = None
        for attempt in SAVE_RETRY.attempts():
            try:
                # The probe sits INSIDE the try: it touches the same
                # flaky filesystem the retry exists for.
                if os.path.isdir(self._step_dir(step)):
                    if attempt:
                        log.warning("checkpoint step %d landed despite the "
                                    "previous attempt's error; continuing",
                                    step)
                    return
                faults.check("checkpoint.save")
                self._write(step, tree)
                return
            except OSError as e:
                log.warning("checkpoint save attempt %d for step %d "
                            "failed: %s", attempt + 1, step, e)
                last = e
        raise last

    def restore_latest(self, state: TrainState
                       ) -> Tuple[TrainState, Optional[int]]:
        """Load the newest checkpoint into ``state`` in place.

        The file is read onto the CPU; ``load_state_dict`` then copies the
        weights into the model's parameters and the optimizer moves its
        state onto each parameter's device (AdamW's ``step`` counters stay
        CPU tensors, as the optimizer keeps them).  So the model must be on
        its device, and the optimizer built over its parameters, first.
        Returns (state, step), or (state unchanged, None) when there is no
        checkpoint yet (first boot of the Job).
        """
        step = self.latest_step()
        if step is None:
            return state, None
        tree = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                          map_location="cpu", weights_only=True)
        own = state.model.state_dict()
        tree["model"] = {k: _lay_out(v, own.get(k))
                         for k, v in tree["model"].items()}
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        for i, entry in tree["optimizer"]["state"].items():
            p = params[i]
            for k, v in entry.items():
                # Moments; not AdamW's step (nor an absent buffer).
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    entry[k] = _lay_out(v, p)
        state.model.load_state_dict(tree["model"])
        state.optimizer.load_state_dict(tree["optimizer"])
        state.step = int(tree["step"])
        log.info("restored checkpoint at step %d", step)
        return state, step

    def close(self) -> None:
        """Nothing is in flight (saves are synchronous); kept for the JAX
        checkpointer's interface."""
