"""What the program recorded about itself: the table of its own spans
and counters for the most recent profiled window, which in a ``--trace
1`` run is the traced slice (``utils/profile.py::last_window`` of the
port), and the seconds its kernels' first load took
(``ops/build.py::LOAD_S``).  A program that records neither gives None
for each, and the metrics that read them are left out."""


def _window():
    from container_engine_accelerators_tpu_torch.utils import profile

    last = getattr(profile, "last_window", None)
    return None if last is None else last()


def span(name: str):
    """``{"n", "host_s", "device_s"}`` of the program's span ``name`` in
    the window, or None where it did not run."""
    w = _window()
    s = None if w is None else w["spans"].get(name)
    return s if s and s["n"] else None


def counts(*names):
    """The window's sums of the program's counters ``names``, or None
    unless every one was counted."""
    w = _window()
    if w is None or any(n not in w["counts"] for n in names):
        return None
    return [w["counts"][n] for n in names]


def load_s():
    from container_engine_accelerators_tpu_torch.ops import build

    return getattr(build, "LOAD_S", None)
