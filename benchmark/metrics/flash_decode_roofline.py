"""flash_decode_roofline: the bytes the flash-decode launches of the
traced fleet steps need (each lane's visible K/V rows, the query and
the output, read or written once, at the lane lengths the step passed)
at the card's HBM bandwidth, over those launches' device time, in
percent."""

from harness import counts, kernels
from harness.weights import sizes


def read(run):
    t = run.trace
    lengths = run.trace_info["fleet_step_lengths"]
    if t is None or not lengths:
        return None
    s = sizes(run.cfg)
    need, spent = 0.0, 0.0
    for ops, lens in zip(t.iterations["fleet_step"], lengths):
        fd = [us for name, us in ops if kernels.is_flash_decode(name)]
        need += len(fd) * counts.flash_decode_bytes(lens, s["H"], s["KVH"],
                                                    s["hd"])
        spent += sum(fd) / 1e6
    if not spent:
        return None
    return counts.share(need / counts.PEAK_HBM_BYTES, spent,
                        "flash_decode_roofline")
