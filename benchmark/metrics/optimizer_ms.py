"""optimizer_ms: device milliseconds of a training step's optimizer
step (AdamW over the f32 master weights and moments), mean over the
traced steps: the time between two CUDA events the program itself
records on the current stream around its span ``lm.train.optimizer``,
timed inside the program."""

from harness import program


def read(run):
    s = program.span("lm.train.optimizer")
    if s is None or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / s["n"]
