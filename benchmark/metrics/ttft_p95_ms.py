"""ttft_p95_ms: 95th percentile (nearest rank) over every request whose
first token came in the window, from when its client sent it (closed
loop: when the client's previous answer came) to its first token, host
clock."""

import math


def read(run):
    ttft = sorted(run.samples["ttft"])
    if not ttft:
        return None
    return 1e3 * ttft[math.ceil(0.95 * len(ttft)) - 1]
