"""setup_s: seconds from the process's start to the window's start
(imports, the kernels' load or build, weights drawn on the card, the
cell's warm-up and fill), host clock.  Check work done during set-up is
not counted."""


def read(run):
    return run.setup_s
