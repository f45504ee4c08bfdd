"""GetPreferredAllocation's pick for GPUs.

The reference no-ops the hook (ref: pkg/gpu/nvidia/beta_plugin.go:95-103):
PCIe GPUs on one host are interchangeable.  The port keeps the JAX
package's ``choose_preferred`` with no topology signal, which is that
package's own answer for interchangeable devices: the must-include IDs,
then the rest in natural order (``nvidia2`` before ``nvidia10``).
"""

import re
from typing import List

_NAT_RE = re.compile(r"(\d+)")


def natural_key(device_id: str):
    """Sort ``nvidia2`` before ``nvidia10`` (and ``.../vgpu2`` before 10)."""
    return [int(p) if p.isdigit() else p for p in _NAT_RE.split(device_id)]


def choose_preferred(available: List[str], must_include: List[str],
                     size: int) -> List[str]:
    """Pick ``size`` IDs from ``available`` that hold ``must_include``;
    a naturally sorted list."""
    available = sorted(set(available), key=natural_key)
    must = [d for d in sorted(set(must_include), key=natural_key)
            if d in available]
    if size <= 0:
        return []
    if size <= len(must):
        return must[:size]
    if size >= len(available):
        return available
    pool = [d for d in available if d not in must]
    return sorted(must + pool[:size - len(must)], key=natural_key)
