"""ops_load_s: seconds the program's first ``ops/build.py::load_ops``
call took in the run (the kernels' library checked and loaded, built
first where the checkout has no build), part of ``setup_s``; the
program times it itself, always."""

from harness import program


def read(run):
    return program.load_s()
