"""backward_ms: device milliseconds of a training step's backward pass
(``loss.backward()``, remat's recompute of each block's forward
included; on a mesh also the gradients' sum), mean over the traced
steps: the time between two CUDA events the program itself records on
the current stream around its span ``lm.train.backward``, timed inside
the program.  The training cells keep the device busy, so that time is
the backward's kernels' own."""

from harness import program


def read(run):
    s = program.span("lm.train.backward")
    if s is None or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / s["n"]
