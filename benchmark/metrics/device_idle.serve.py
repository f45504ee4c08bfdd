"""device_idle.serve: share of the traced slice of serving iterations in
which no operation ran on the device (the union of its kernels, copies
and memsets against the slice's length), in percent."""


def read(run):
    t = run.trace
    if t is None or run.mix["kind"] != "serve":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
