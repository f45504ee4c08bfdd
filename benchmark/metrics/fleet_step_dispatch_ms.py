"""fleet_step_dispatch_ms: host milliseconds of the program's own span
``lm.engine.step.dispatch`` (inside ``DecodeEngine.step``: the enqueue
of the fleet's forward, the argmax, ``where`` and the cursor rewind,
before the step's tokens are read back), mean over the traced slice's
fleet steps."""

from harness import program


def read(run):
    s = program.span("lm.engine.step.dispatch")
    return None if s is None else 1e3 * s["host_s"] / s["n"]
