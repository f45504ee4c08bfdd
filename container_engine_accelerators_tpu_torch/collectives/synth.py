"""The port's copy of ``container_engine_accelerators_tpu/collectives/
synth.py::bus_factor``, the accounting both the bandwidth sweep and the
schedule engine use.  The engine itself (schedules, synthesis) is not
ported yet."""


def bus_factor(op: str, n: int) -> float:
    """nccl-tests bus-bandwidth factor over ``n`` ranks: ``busbw = algbw *
    factor`` (``bench.py`` keeps the same accounting)."""
    if op == "all_reduce":
        return 2 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter"):
        return (n - 1) / n
    return 1.0  # point-to-point shift
