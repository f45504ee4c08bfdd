"""flash_attn_roofline: the flash-attention kernels' least time at the
bf16 peak over their device time in the traced steps, in percent.  Each
forward, dQ and dK/dV launch's bound is 2 d FLOPs a product over the B H
T (T + 1) / 2 causal pairs, 2 / 3 / 4 products; the time includes the
delta pre-pass the dQ op runs."""

from harness import counts, kernels


def read(run):
    t = run.trace
    if t is None or run.mix["kind"] != "train":
        return None
    s = run.arch.sizes(run.cfg)
    shape = (run.mix["batch"], run.mix["seq_len"], s["H"], s["hd"])
    bound = sum(t.launches(kernels.flash_attention(kind))
                * counts.flash_attention_bound_s(kind, *shape)
                for kind in counts.FLASH_PRODUCTS)
    spent = t.time_s(kernels.flash_attention(None))
    if not bound or not spent:
        return None
    return counts.share(bound, spent, "flash_attn_roofline")
