"""prefill_device_ms: device milliseconds of a prefill, mean over the
traced slice's ``DecodeEngine.submit`` calls: the time between two CUDA
events the program itself records on the current stream around its
span ``lm.engine.submit.prefill`` (the padded prompt's copy and the
batch-1 prefill into a fresh lane), timed inside the program, so it
also holds any idle time between the prefill's operations."""

from harness import program


def read(run):
    s = program.span("lm.engine.submit.prefill")
    if s is None or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / s["n"]
