"""Kubernetes resource-quantity parsing (a copy of the JAX package's
``scheduler/quantity.py``).

The reference leans on ``kubernetes.utils.quantity.parse_quantity``
(ref: gpudirect-tcpxo/topology-scheduler/schedule-daemon.py:23,106-108);
that package is not available here, so this is a small self-contained
parser for the quantity grammar the scheduler actually meets: plain
integers/decimals, the ``n``/``u``/``m`` sub-unit suffixes for CPU,
binary suffixes (Ki..Ei) and decimal suffixes (k..E) for memory.
Returns a float in base units (cores / bytes / counts).  An
unparseable quantity logs a warning and counts as 0 rather than
crashing the scheduling daemon on one malformed pod spec.
"""

import logging
from typing import Union

log = logging.getLogger(__name__)

_SUFFIXES = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}


def parse_quantity(value: Union[str, int, float, None]) -> float:
    """Parse a Kubernetes quantity ('100m', '1Gi', '2', 3) to a float."""
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        return 0.0
    try:
        for suffix in sorted(_SUFFIXES, key=len, reverse=True):
            if s.endswith(suffix):
                return float(s[: -len(suffix)]) * _SUFFIXES[suffix]
        # Scientific notation (e.g. "1e3") and plain numbers.
        return float(s)
    except ValueError:
        log.warning("unparseable resource quantity %r, counting as 0", value)
        return 0.0
