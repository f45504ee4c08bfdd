"""Prometheus text-exposition parsing, shared by every scrape surface.

The agent exports one format (`metrics/metrics.py`), but two consumers
grew their own regex parsers for it — ``cmd/agent_top.py`` (live
console) and ``fleet/telemetry.py`` (process-mode fleet aggregation) —
and the copies had already drifted: one tolerated unlabeled samples
and unescaped label values, the other didn't.  This module is the one
parser both import, stdlib-only like the rest of ``obs/``.
"""

import re
from typing import Dict, List, Tuple

# Sample line: `family{label="v",...} value` — the label block is
# optional (`family value` is a legal exposition line).
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')

Samples = Dict[str, List[Tuple[dict, float]]]


# Single pass: sequential str.replace would corrupt values where one
# escape's output forms another's input (`\\n` — escaped backslash then
# a literal n — must stay `\n`, not become a newline).
_ESCAPE_RE = re.compile(r"\\(.)")


def _unescape(raw: str) -> str:
    return _ESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), raw)


def parse_samples(text: str) -> Samples:
    """Exposition text -> ``{family: [(labels, value), ...]}``.
    Comment/blank/malformed lines and non-float values are skipped —
    a scrape surface must tolerate families it has never heard of."""
    families: Samples = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        family, labels_raw, value_raw = m.groups()
        try:
            value = float(value_raw)
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(labels_raw or "")}
        families.setdefault(family, []).append((labels, value))
    return families
