"""prefill_pad_share: of the tokens the traced slice's prefills
processed, the share that is padding up to the prompt's power-of-two
bucket, from the program's own counters
``lm.engine.prefill.prompt_tokens`` and ``lm.engine.prefill.pad_tokens``
(``DecodeEngine.submit``)."""

from harness import program


def read(run):
    c = program.counts("lm.engine.prefill.prompt_tokens",
                       "lm.engine.prefill.pad_tokens")
    if c is None or not c[0] + c[1]:
        return None
    return 100.0 * c[1] / (c[0] + c[1])
