"""prefill_ms: host milliseconds of ``DecodeEngine.submit()`` (the
bucket-padded batch-1 prefill, the lane insert and the first token,
read back), total over count in the window."""


def read(run):
    spans = run.spans["prefill"]
    return 1e3 * sum(spans) / len(spans) if spans else None
