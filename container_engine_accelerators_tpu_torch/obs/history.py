"""Fleet history ledger: persistent run records + attributed trends.

Every gate in the repo judges one run against pinned constants —
correct for catching a cliff, structurally blind to a slope.  A 10%
per-week bleed in goodput, busbw, p99, or leak slope never trips a
hard floor until it has already cost weeks, and when it finally does
trip, nothing in the verdict says *why*.  This module is the
longitudinal layer under all of them:

- **RunLedger**: an append-only JSONL file under ``TPU_HISTORY_DIR``
  (``ledger.jsonl``), one record per bench cell / fleet_sim run /
  soak run.  Each record carries the headline metrics, the per-run
  ``cpu_attr`` subsystem shares (obs/profiler.py), the critical-path
  dominant phase (obs/critpath.py), sentinel leak slopes, SLO
  verdicts, and a ``VERSION`` + seed + config-key stamp so records
  are comparable (same config key) and joinable (same ``run_id`` as
  the raw bench JSONL).  Appends are single ``O_APPEND`` writes, so
  two processes recording concurrently interleave whole lines; the
  sink rotates at a size cap exactly like the trace sink
  (``<path>.1`` keeps the previous generation, inode-guarded so only
  the writer that still owns the live file rotates it).  Corrupt or
  torn lines are counted (``history.skipped``) and skipped on read —
  never a crash.  A malformed ``TPU_HISTORY_DIR`` (a file where a
  directory should be, an uncreatable path) degrades to
  recording-off with a counted ``history.disabled`` event: the
  TPU_FAULT_SPEC rule — a typo'd env var costs the history, not the
  run.

- **trend engine**: per ``(metric, config key)`` robust baseline
  from the last ``BASELINE_N`` runs — median + MAD (median absolute
  deviation), the estimator that one outlier run cannot drag — and
  regression verdicts with **attribution**: when p99 or goodput
  regresses past ``median ± k·MAD``, the verdict names which
  subsystem share moved (``cpu_attr`` delta in points vs the
  baseline median share) and which critical-path phase grew, so the
  report says "p99 +18%, serving share flat, shm-staging share
  +9pts, dominant phase dcn.chunk.stage" instead of a bare number.

- **learned thresholds**: :func:`learned_limit` turns prior runs'
  observations (e.g. soak leak slopes) into a sentinel threshold —
  ``median + k·MAD`` — with a pinned-constant fallback when history
  is thinner than ``min_runs`` and a hard ceiling the learned value
  can never relax past (by default the pinned constant itself: the
  fleet's history may tighten a budget, never loosen it).

Stdlib-only, like everything in obs/ — the CLIs, fleet/soak.py, and
agent_top all sit on this module.
"""

import json
import logging
import os
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.metrics import counters

log = logging.getLogger(__name__)

HISTORY_DIR_ENV = "TPU_HISTORY_DIR"
HISTORY_CAP_ENV = "TPU_HISTORY_MAX_BYTES"
LEDGER_NAME = "ledger.jsonl"
SCHEMA_VERSION = 1

# Sink rotation cap (live file + one rotated generation ≈ 2x on
# disk); a malformed env degrades to this default, never to a crash.
DEFAULT_CAP_BYTES = 4 << 20

# Baseline window: the last N comparable runs feed the median/MAD.
BASELINE_N = 8
# Fewer prior runs than this and the trend engine refuses to judge
# (``no_baseline``) and learned thresholds fall back to the pinned
# constant — two points fit any line.
MIN_BASELINE_RUNS = 3
# Regression threshold: |value - median| > k·MAD (same k the learned
# sentinel thresholds use).
DEFAULT_K = 3.0
# MAD floor, as a fraction of |median|: a perfectly flat history has
# MAD 0 and would flag scheduling noise as a regression — the floor
# grants every baseline a minimum tolerance band.
MAD_FLOOR_FRAC = 0.05
# Attribution: subsystem share moves under this many points are
# reported as "flat".
ATTR_FLAT_PTS = 2.0

# Metric direction: is a bigger number better?  Names not matched by
# either list default to higher-is-better (throughput-shaped) — the
# registry is consulted suffix-blind on dotted names.
_LOWER_IS_BETTER = (
    "p99", "p50", "_ms", "ratio", "errors", "shed", "slope",
    "exposed", "elapsed", "lost", "overhead", "detect_windows",
    "false_positives",
)
_HIGHER_IS_BETTER = (
    "mbps", "qps", "goodput", "busbw", "pct_of_memcpy",
    "images_per_sec", "tokens", "value",
)


def metric_direction(name: str) -> str:
    """``"lower"`` or ``"higher"`` — which way this metric regresses.
    Substring match, lower-is-better wins ties (``p99`` inside any
    name means latency-shaped, whatever else the name says)."""
    low = name.lower()
    if any(tok in low for tok in _LOWER_IS_BETTER):
        return "lower"
    if any(tok in low for tok in _HIGHER_IS_BETTER):
        return "higher"
    return "higher"


def new_run_id() -> str:
    """A fresh run id every emitter stamps into its raw JSONL and its
    ledger record — the join key between the two."""
    return uuid.uuid4().hex[:16]


def repo_version() -> str:
    """The VERSION stamp (repo root), ``"unknown"`` when the tree
    layout does not carry one (installed package, trimmed image)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        with open(os.path.join(root, "VERSION"),
                  encoding="utf-8") as fh:
            v = fh.read().strip()
        return v or "unknown"
    except OSError:
        return "unknown"


def config_key(*parts) -> str:
    """A stable comparability stamp: runs share a baseline only when
    their config keys match.  ``None`` parts are skipped."""
    return ":".join(str(p) for p in parts if p is not None)


class LedgerError(Exception):
    """The ledger EXISTS but cannot be read (permissions, a directory
    where the file should be) — the agent_trend exit-2 signal.  A
    missing ledger is just an empty history, never this."""


def _env_cap() -> int:
    raw = os.environ.get(HISTORY_CAP_ENV)
    if raw is None:
        return DEFAULT_CAP_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        log.error("malformed %s=%r; using default %d",
                  HISTORY_CAP_ENV, raw, DEFAULT_CAP_BYTES)
        return DEFAULT_CAP_BYTES


class RunLedger:
    """The append-only run history under one directory.

    ``root=None`` resolves ``TPU_HISTORY_DIR``; an unset env means
    recording is off (``enabled`` False) and every ``record`` is a
    silent no-op — benches run identically with and without history.
    A *malformed* root (uncreatable, or a file) also disables
    recording, but loudly: logged once and counted as
    ``history.disabled``.
    """

    def __init__(self, root: Optional[str] = None,
                 cap_bytes: Optional[int] = None):
        if root is None:
            root = os.environ.get(HISTORY_DIR_ENV)
        self.root = root
        self.cap_bytes = _env_cap() if cap_bytes is None \
            else max(0, int(cap_bytes))
        self._disabled_reason: Optional[str] = None
        if not root:
            self._disabled_reason = "unconfigured"
            return
        try:
            os.makedirs(root, exist_ok=True)
            if not os.path.isdir(root):
                raise NotADirectoryError(root)
        except OSError as e:
            # The TPU_FAULT_SPEC rule: a typo'd TPU_HISTORY_DIR costs
            # the history, never the run.
            counters.inc("history.disabled")
            log.error("history recording disabled: %s is unusable "
                      "(%s)", root, e)
            self._disabled_reason = f"unusable dir: {e}"

    @property
    def enabled(self) -> bool:
        return self._disabled_reason is None

    @property
    def path(self) -> Optional[str]:
        if not self.root:
            return None
        return os.path.join(self.root, LEDGER_NAME)

    # -- append ----------------------------------------------------------

    def record(self, kind: str, cfg_key: str,
               metrics: Dict[str, float], *,
               run_id: Optional[str] = None,
               seed: Optional[int] = None,
               cpu_attr: Optional[Dict[str, float]] = None,
               dominant_phase: Optional[str] = None,
               sentinels: Optional[dict] = None,
               slo: Optional[dict] = None,
               version: Optional[str] = None,
               ts: Optional[float] = None) -> Optional[dict]:
        """Append one run record; returns it (or None when recording
        is off).  Never raises: an IO failure mid-append disables
        recording for this ledger with a counted ``history.disabled``
        — history is evidence, not a dependency."""
        if not self.enabled:
            return None
        rec = {
            "schema": SCHEMA_VERSION,
            "run_id": run_id or new_run_id(),
            "version": repo_version() if version is None else version,
            "ts": time.time() if ts is None else float(ts),
            "kind": str(kind),
            "config_key": str(cfg_key),
            "seed": seed,
            "metrics": {str(k): float(v)
                        for k, v in (metrics or {}).items()},
        }
        if cpu_attr:
            rec["cpu_attr"] = {str(k): round(float(v), 4)
                               for k, v in cpu_attr.items()}
        if dominant_phase is not None:
            rec["dominant_phase"] = str(dominant_phase)
        if sentinels is not None:
            rec["sentinels"] = sentinels
        if slo is not None:
            rec["slo"] = slo
        line = (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8")
        try:
            # One O_APPEND write per record: concurrent recorders
            # interleave whole lines, no lock needed (and a torn
            # final line from a killed writer is a counted skip on
            # the read side, never a crash).
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                         0o644)
            try:
                os.write(fd, line)
                self._maybe_rotate(fd)
            finally:
                os.close(fd)
        except OSError as e:
            counters.inc("history.disabled")
            log.error("history append to %s failed (%s); recording "
                      "disabled", self.path, e)
            self._disabled_reason = f"append failed: {e}"
            return None
        counters.inc("history.records")
        return rec

    def _maybe_rotate(self, fd: int) -> None:
        """Size-capped rotation, the trace-sink discipline: past the
        cap the live file becomes ``<path>.1`` (previous generation
        dropped) — but only when this writer's fd still IS the live
        path (another recorder may have rotated between our append
        and this check; renaming the fresh file would throw away a
        generation).  A failed rotation turns rotation off for this
        ledger, never the sink."""
        cap = self.cap_bytes
        if not cap:
            return
        try:
            if os.fstat(fd).st_size < cap:
                return
            if os.stat(self.path).st_ino != os.fstat(fd).st_ino:
                return  # someone else already rotated under us
            os.replace(self.path, self.path + ".1")
        except OSError as e:
            log.error("history rotation of %s failed (%s); rotation "
                      "disabled", self.path, e)
            self.cap_bytes = 0
            return
        counters.inc("history.rotated")

    # -- read ------------------------------------------------------------

    def records(self, kind: Optional[str] = None,
                cfg_key: Optional[str] = None,
                metric: Optional[str] = None) -> List[dict]:
        """Every readable record, oldest first (rotated generation
        before the live file), filtered.  Corrupt/torn lines are
        counted (``history.skipped``) and skipped.  Raises
        :class:`LedgerError` only when a ledger file EXISTS but
        cannot be read — a missing one is an empty history."""
        if not self.path:
            return []
        out: List[dict] = []
        for path in (self.path + ".1", self.path):
            if not os.path.exists(path):
                continue
            try:
                with open(path, "rb") as fh:
                    raw = fh.read()
            except OSError as e:
                raise LedgerError(
                    f"ledger {path} unreadable: {e}") from e
            for line in raw.split(b"\n"):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line.decode("utf-8"))
                    if not isinstance(rec, dict) \
                            or "metrics" not in rec:
                        raise ValueError("not a run record")
                except (ValueError, UnicodeDecodeError):
                    counters.inc("history.skipped")
                    continue
                if kind is not None and rec.get("kind") != kind:
                    continue
                if cfg_key is not None \
                        and rec.get("config_key") != cfg_key:
                    continue
                if metric is not None \
                        and metric not in (rec.get("metrics") or {}):
                    continue
                out.append(rec)
        return out


def fleet_report_evidence(report: dict):
    """Pull one fleet report's ledger evidence: ``(metrics,
    cpu_attr, dominant_phase)`` — the SLO measurements as headline
    metrics, the fleet-wide profiler subsystem sample counts
    normalized to busy shares (idle excluded, like
    profiler.subsystem_shares), and the critical-path dominant
    phase.  Absent sections attribute nothing rather than raising —
    works on fleet_sim, soak, and serving reports alike."""
    metrics: Dict[str, float] = {}
    measured = (report.get("slo") or {}).get("measured") or {}
    for key, val in measured.items():
        if key in ("elapsed_s", "stale_entries_skipped"):
            continue
        try:
            metrics[key] = float(val)
        except (TypeError, ValueError):
            continue
    cpu_attr = None
    subs = ((report.get("profile") or {}).get("fleet") or {}) \
        .get("subsystems") or {}
    busy = {k: float(v) for k, v in subs.items()
            if k != "idle" and isinstance(v, (int, float)) and v > 0}
    total = sum(busy.values())
    if total > 0:
        cpu_attr = {k: v / total for k, v in busy.items()}
    phase = (report.get("critical_path") or {}).get("dominant_phase")
    return metrics, cpu_attr, phase


# ---------------------------------------------------------------------------
# robust baseline math
# ---------------------------------------------------------------------------


def median(values: Iterable[float]) -> float:
    xs = sorted(float(v) for v in values)
    if not xs:
        return 0.0
    n = len(xs)
    mid = n // 2
    if n % 2:
        return xs[mid]
    return (xs[mid - 1] + xs[mid]) / 2.0


def mad(values: Iterable[float],
        med: Optional[float] = None) -> float:
    """Median absolute deviation — the spread estimator one outlier
    run cannot drag (unlike stddev)."""
    xs = [float(v) for v in values]
    if not xs:
        return 0.0
    if med is None:
        med = median(xs)
    return median(abs(x - med) for x in xs)


def baseline(values: Iterable[float]) -> dict:
    xs = [float(v) for v in values]
    med = median(xs)
    return {"n": len(xs), "median": med, "mad": mad(xs, med)}


def _band(med: float, spread: float) -> float:
    """The tolerance half-width: MAD floored at a fraction of the
    median so a perfectly flat history still tolerates noise."""
    return max(spread, MAD_FLOOR_FRAC * abs(med), 1e-12)


def learned_limit(values: Iterable[float], pinned: float, *,
                  k: float = DEFAULT_K,
                  min_runs: int = MIN_BASELINE_RUNS,
                  kind: str = "ceiling",
                  ceiling: Optional[float] = None) -> dict:
    """A sentinel threshold learned from prior runs' observations:
    ``median + k·MAD`` for a ceiling-shaped budget (``median -
    k·MAD`` for a floor), MAD floored, with a pinned-constant
    fallback when history is thinner than ``min_runs`` and a hard
    bound the learned value can never relax past — ``ceiling``
    defaults to the pinned constant itself, so history may *tighten*
    a budget but never loosen it (a ceiling never rises above it, a
    floor never sinks below it)."""
    xs = [float(v) for v in values]
    ceiling = float(pinned) if ceiling is None else float(ceiling)
    if len(xs) < max(1, int(min_runs)):
        return {"limit": float(pinned), "source": "pinned",
                "n": len(xs), "median": None, "mad": None,
                "ceiling": ceiling}
    b = baseline(xs)
    band = k * _band(b["median"], b["mad"])
    if kind == "floor":
        limit = max(b["median"] - band, ceiling)
    else:
        limit = min(b["median"] + band, ceiling)
    return {"limit": limit, "source": "learned",
            "n": b["n"], "median": b["median"], "mad": b["mad"],
            "ceiling": ceiling}


# ---------------------------------------------------------------------------
# trend verdicts with attribution
# ---------------------------------------------------------------------------


def attribute(current_cpu_attr: Optional[Dict[str, float]],
              current_phase: Optional[str],
              prior: List[dict]) -> dict:
    """The *why* behind a regression: which ``cpu_attr`` subsystem
    share moved (points vs the baseline median share) and whether the
    critical-path dominant phase changed.  Works from whatever
    evidence the records carry — a bench with no profiler attributes
    nothing rather than failing."""
    out: dict = {"subsystems": [], "flat": [],
                 "dominant_phase": current_phase,
                 "prior_dominant_phase": None}
    phases = [r.get("dominant_phase") for r in prior
              if r.get("dominant_phase")]
    if phases:
        # Modal prior phase (ties break to the most recent).
        tally: Dict[str, int] = {}
        for p in phases:
            tally[p] = tally.get(p, 0) + 1
        out["prior_dominant_phase"] = max(
            reversed(phases), key=lambda p: tally[p])
    if current_cpu_attr:
        subs = set(current_cpu_attr)
        prior_attrs = [r.get("cpu_attr") for r in prior
                       if r.get("cpu_attr")]
        for attr in prior_attrs:
            subs.update(attr)
        movers: List[Tuple[float, str, float, float]] = []
        for sub in sorted(subs):
            cur = float(current_cpu_attr.get(sub, 0.0)) * 100.0
            base = median(float(a.get(sub, 0.0)) * 100.0
                          for a in prior_attrs) if prior_attrs else 0.0
            delta = cur - base
            movers.append((delta, sub, cur, base))
        movers.sort(key=lambda m: -abs(m[0]))
        for delta, sub, cur, base in movers:
            entry = {"subsystem": sub, "share_pts": round(cur, 1),
                     "baseline_pts": round(base, 1),
                     "delta_pts": round(delta, 1)}
            if abs(delta) >= ATTR_FLAT_PTS:
                out["subsystems"].append(entry)
            else:
                out["flat"].append(sub)
    return out


def format_attribution(attr: dict) -> str:
    """One human-readable clause list: movers first, flats named, the
    dominant phase last — the "+9pts shm-staging" sentence."""
    bits: List[str] = []
    for m in attr.get("subsystems", []):
        sign = "+" if m["delta_pts"] >= 0 else ""
        bits.append(f"{m['subsystem']} share "
                    f"{sign}{m['delta_pts']}pts")
    flat = attr.get("flat") or []
    if flat:
        bits.append(", ".join(flat[:3]) + " share flat")
    phase = attr.get("dominant_phase")
    prior = attr.get("prior_dominant_phase")
    if phase and prior and phase != prior:
        bits.append(f"dominant phase {phase} (was {prior})")
    elif phase:
        bits.append(f"dominant phase {phase}")
    return ", ".join(bits)


def trend_verdict(prior: List[dict], metric: str, value: float, *,
                  k: float = DEFAULT_K,
                  min_runs: int = MIN_BASELINE_RUNS,
                  n: int = BASELINE_N,
                  cpu_attr: Optional[Dict[str, float]] = None,
                  dominant_phase: Optional[str] = None) -> dict:
    """Judge ``value`` against the last ``n`` comparable prior
    records' ``metric``: OK inside ``median ± k·MAD`` (regression
    side only — an *improvement* past the band reports ``improved``,
    which never gates), ``no_baseline`` when history is thinner than
    ``min_runs``.  A regression carries the attribution."""
    window = [r for r in prior
              if metric in (r.get("metrics") or {})][-int(n):]
    values = [float(r["metrics"][metric]) for r in window]
    verdict = {
        "metric": metric, "value": float(value),
        "direction": metric_direction(metric),
        "n": len(values), "ok": True, "status": "no_baseline",
        "median": None, "mad": None, "delta_pct": None,
        "attribution": None,
    }
    if len(values) < max(1, int(min_runs)):
        return verdict
    b = baseline(values)
    band = k * _band(b["median"], b["mad"])
    verdict["median"] = b["median"]
    verdict["mad"] = b["mad"]
    if b["median"]:
        verdict["delta_pct"] = round(
            (float(value) - b["median"]) / abs(b["median"]) * 100, 1)
    worse = (float(value) > b["median"] + band
             if verdict["direction"] == "lower"
             else float(value) < b["median"] - band)
    better = (float(value) < b["median"] - band
              if verdict["direction"] == "lower"
              else float(value) > b["median"] + band)
    if worse:
        verdict["ok"] = False
        verdict["status"] = "regressed"
        verdict["attribution"] = attribute(
            cpu_attr, dominant_phase, window)
    else:
        verdict["status"] = "improved" if better else "ok"
    return verdict


def format_verdict(v: dict) -> str:
    """The one-line rendering agent_top and the trend gates print:
    ``p99_e2e_ms REGRESSED +18.2% vs median 41.0 (n=8): shm-staging
    share +9pts, serving share flat, dominant phase
    dcn.chunk.stage``."""
    status = v["status"].upper()
    if v["status"] == "no_baseline":
        return (f"{v['metric']} NO-BASELINE "
                f"(history n={v['n']} too thin)")
    delta = v.get("delta_pct")
    sign = "+" if (delta or 0) >= 0 else ""
    line = (f"{v['metric']} {status} {sign}{delta}% vs median "
            f"{round(v['median'], 3)} (n={v['n']})")
    if v.get("attribution"):
        rendered = format_attribution(v["attribution"])
        if rendered:
            line += ": " + rendered
    return line
