"""train_tokens_per_s: trained tokens (batch x sequence) of every step
of the window over the window's whole time, host clock; the window
starts and ends on a synchronize."""


def read(run):
    if run.mix["kind"] != "train":
        return None
    return run.counters["tokens"] / run.window_s
