"""mfu.train: model FLOPs of the window's training steps (6 N a token
for every product, tied head included, and 3 x the causal attention's
forward; remat's recompute not counted) over the window's time at the
card's dense bf16 peak, in percent.  The count is the architecture's
(``arch/<architecture>.py::train_step_flops``)."""

from harness import counts


def read(run):
    if run.mix["kind"] != "train" or not run.counters["steps"]:
        return None
    flops = (run.arch.train_step_flops(run.cfg, run.mix["batch"],
                                       run.mix["seq_len"])
             * run.counters["steps"])
    return counts.share(flops, run.window_s * counts.PEAK_BF16_FLOPS,
                        "mfu.train")
