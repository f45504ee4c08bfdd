"""head_ms: device milliseconds a training step spends in the tied LM
head's tensor-core path: its forward (the logits' GEMM) plus its
backward (the gradient's split and the GEMMs of dX and dE), each the
time between two CUDA events the program records on the current stream
around its span, ``lm.train.head.forward`` and
``lm.train.head.backward``, over that span's count, as ``backward_ms``
reads its span.  A program whose head takes another path (or that has no
such spans) gives None."""

from harness import program


def read(run):
    total = 0.0
    for name in ("lm.train.head.forward", "lm.train.head.backward"):
        s = program.span(name)
        if s is None or s["device_s"] is None:
            return None
        total += s["device_s"] / s["n"]
    return 1e3 * total
