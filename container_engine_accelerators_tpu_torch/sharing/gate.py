"""The MPS gate: the reference's ``isMpsHealthy`` (ref:
pkg/gpu/nvidia/manager.go:376-386, SURVEY §3.1; the counterpart of the
JAX package's ``sharing/gate.py::CoreSharingGate``).

Under the ``mps`` strategy co-tenant containers share a GPU through the
CUDA Multi-Process Service: one control daemon per node
(``nvidia-cuda-mps-control -d``) owns the GPU, and each client process
reaches it through the pipe directory (``CUDA_MPS_PIPE_DIRECTORY``,
default ``/tmp/nvidia-mps``) with its share set by
``CUDA_MPS_ACTIVE_THREAD_PERCENTAGE`` and
``CUDA_MPS_PINNED_DEVICE_MEM_LIMIT``.  Without a daemon those envs are
decoration, so the gate refuses the strategy unless the daemon answers.

``verify`` runs ``nvidia-cuda-mps-control``, found under the driver
mounts' ``bin/`` as the JAX gate finds libtpu under them, with
``get_default_active_thread_percentage`` on its standard input and the
pipe directory in its env.  A missing binary, a non-zero exit, a
timeout or an answer that is not a number raises ``MpsGateError``.
``check_allocatable`` asks again before every Allocate, without the
search and with a shorter timeout, and raises ``ValueError`` so the
service rejects the request.

KNOWN LIMITATION, as in the reference and the JAX gate: the query proves
that the daemon ANSWERS, not that it enforces the thread and memory
limits.  Enforcement happens in each client's CUDA driver when it
connects; nothing on the node agent's side can observe it.
"""

import logging
import os
import subprocess
from typing import List, Optional

from container_engine_accelerators_tpu_torch.utils.device import Mount

log = logging.getLogger(__name__)

CONTROL_BINARY = "nvidia-cuda-mps-control"
PIPE_DIRECTORY_ENV = "CUDA_MPS_PIPE_DIRECTORY"
DEFAULT_PIPE_DIRECTORY = "/tmp/nvidia-mps"
QUERY = "get_default_active_thread_percentage"
VERIFY_TIMEOUT_S = 10.0
ALLOCATE_TIMEOUT_S = 2.0


class MpsGateError(RuntimeError):
    """The MPS control daemon does not answer on this node."""


class MpsGate:
    def __init__(self, mount_paths: List[Mount],
                 pipe_directory: str = DEFAULT_PIPE_DIRECTORY):
        self.mount_paths = list(mount_paths)
        self.pipe_directory = pipe_directory
        self._binary: Optional[str] = None  # set once verify succeeds

    def find_control(self) -> Optional[str]:
        for mount in self.mount_paths:
            path = os.path.join(mount.host_path, "bin", CONTROL_BINARY)
            if os.path.isfile(path) and os.access(path, os.X_OK):
                return path
        return None

    def verify(self) -> float:
        """Full check; returns the daemon's default active thread
        percentage, or raises MpsGateError."""
        binary = self.find_control()
        if binary is None:
            searched = [os.path.join(m.host_path, "bin")
                        for m in self.mount_paths]
            raise MpsGateError(f"mps requires {CONTROL_BINARY} under the "
                               f"driver install (searched {searched})")
        percentage = self._query(binary, VERIFY_TIMEOUT_S)
        self._binary = binary
        log.info("MPS gate: %s answers on %s (default active thread "
                 "percentage %s)", binary, self.pipe_directory, percentage)
        return percentage

    def check_allocatable(self) -> None:
        """Ask the daemon again before an Allocate; ValueError (the
        service's rejection path) when it does not answer."""
        try:
            if self._binary is None:
                self.verify()
            else:
                self._query(self._binary, ALLOCATE_TIMEOUT_S)
        except MpsGateError as e:
            self._binary = None
            raise ValueError(f"MPS control daemon not answering: {e}") from None

    def _query(self, binary: str, timeout_s: float) -> float:
        env = dict(os.environ, **{PIPE_DIRECTORY_ENV: self.pipe_directory})
        try:
            proc = subprocess.run([binary], input=QUERY + "\n", env=env,
                                  capture_output=True, text=True,
                                  timeout=timeout_s)
        except subprocess.TimeoutExpired:
            raise MpsGateError(f"{binary} did not answer {QUERY!r} within "
                               f"{timeout_s:g} s") from None
        except OSError as e:
            raise MpsGateError(f"cannot run {binary}: {e}") from None
        answer = proc.stdout.strip()
        if proc.returncode != 0:
            raise MpsGateError(
                f"{binary} exited {proc.returncode} on {QUERY!r} (pipe "
                f"directory {self.pipe_directory}): "
                f"{(answer + ' ' + proc.stderr.strip()).strip()[:300]}")
        try:
            return float(answer)
        except ValueError:
            raise MpsGateError(f"{binary} answered {answer[:200]!r} to "
                               f"{QUERY!r}, not a number") from None
