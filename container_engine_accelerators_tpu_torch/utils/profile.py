"""A ``torch.profiler`` window over a trainer's steps, shared by
``cmd/train_lm.py`` and ``cmd/train_resnet.py`` (their ``--profile-dir``)
and read by ``cmd/trace_summary.py``."""

import logging
import os

import torch

log = logging.getLogger(__name__)


class ProfileWindow:
    """``torch.profiler`` over a window of train steps (CPU activity, and
    CUDA activity on the card), each step marked ``ProfilerStep#<n>``.
    :meth:`stop` waits for the device, ends the trace and writes it into
    ``directory`` as a Chrome trace, ``<name>.<pid>.pt.trace.json``
    (``name``: the trainer's)."""

    def __init__(self, directory, device, name):
        from torch.profiler import ProfilerActivity, profile

        self.directory, self.device, self.name = directory, device, name
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.path = None
        self._prof = profile(activities=activities)
        self._prof.start()

    @staticmethod
    def step(step):
        return torch.profiler.record_function(f"ProfilerStep#{step}")

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory, f"{self.name}.{os.getpid()}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        log.info("wrote torch.profiler trace to %s", self.path)
