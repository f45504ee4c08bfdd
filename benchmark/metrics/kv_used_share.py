"""kv_used_share: of the K/V rows the decode engine's fleet cache
reserves (slots x slot length), the share its live lanes hold, summed
over the traced slice's fleet steps from the program's own counters
``lm.engine.kv.used_rows`` and ``lm.engine.kv.reserved_rows``."""

from harness import program


def read(run):
    c = program.counts("lm.engine.kv.used_rows", "lm.engine.kv.reserved_rows")
    if c is None or not c[1]:
        return None
    return 100.0 * c[0] / c[1]
