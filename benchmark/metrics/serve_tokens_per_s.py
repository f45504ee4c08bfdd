"""serve_tokens_per_s: generated tokens (first tokens included) emitted
in the window over the window's whole time, host clock."""


def read(run):
    if run.mix["kind"] != "serve":
        return None
    return run.counters["tokens"] / run.window_s
