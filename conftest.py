"""Builds the native binaries (``make native``) once, before any test file
is imported.

Several test files decide at import time whether the binaries under
``native/*/build`` exist, and skip their tests if not; one asserts that
a binary exists.  Under pytest-xdist every worker imports its files
before any session fixture runs, so the build must happen first, in the
main process (the controller under xdist: the process without
``config.workerinput``).  If ``make`` is missing, fails or runs past its
time limit, one line says so and nothing else changes: those tests then
skip as they would without this file.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD_TIMEOUT_S = 300


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    try:
        proc = subprocess.run(["make", "native"], cwd=REPO,
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"conftest: make native did not run: {e}", file=sys.stderr)
        return
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()[-1:]
        print(f"conftest: make native failed (exit {proc.returncode}): "
              f"{' '.join(tail)}", file=sys.stderr)
