"""Prompt bucketing — the part of ``container_engine_accelerators_tpu/
models/batching.py`` that per-request serving uses.  The continuous-
batching engines (``DecodeEngine``, ``SpecDecodeEngine``, ``EngineLoop``)
come with a later serving slice of the port."""


def bucket_len(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped (one shape per bucket)."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)
