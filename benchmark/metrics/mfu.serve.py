"""mfu.serve: forward FLOPs of the prompt and generated tokens the
window processed (2 N a token and the attention over each query's
visible keys; bucket padding and idle lanes not counted) over the
window's time at the card's dense bf16 peak, in percent."""

from harness import counts


def read(run):
    c = run.counters
    if run.mix["kind"] != "serve" or not c["tokens"]:
        return None
    flops = counts.forward_flops(
        run.cfg, c["prefill_tokens"] + c["decode_tokens"],
        c["prefill_keys"] + c["decode_keys"])
    return counts.share(flops, run.window_s * counts.PEAK_BF16_FLOPS,
                        "mfu.serve")
