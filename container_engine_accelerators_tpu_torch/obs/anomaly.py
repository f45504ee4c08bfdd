"""Grey-failure detection: peer-relative anomaly scoring with a
hysteresis verdict ladder.

The fleet's health machinery is crash-detector-shaped: a dead worker
misses its scrape, a partitioned link drops frames, a chip fault fires
an Xid — every one of them emits a SIGNAL.  The soak world's grey
faults are designed NOT to: ``grey:`` (shim latency + CPU burn),
``slow_ring`` (a crawling completer), ``slow_shm`` (a throttled shm
commit) keep every health check green while a node quietly costs the
fleet half its goodput.  Today nothing notices until a post-hoc
sentinel or SLO breach; this module is the live detector.

**Scoring is peer-relative**, the run-ledger discipline
(obs/history.py) applied across space instead of time: per metric per
window, each entity's value is scored as a robust z against its
same-tier peers —

    z = bad_direction_deviation / max(MAD, 5% * |median|, abs_floor)

so one sick node among N healthy peers scores enormous (the healthy
majority pins the median and the MAD collapses to the floor), while a
GLOBAL slowdown — every node slower because the host is loaded —
scores ~0 for everyone: the median moves with the fleet.  Windows
where the peers carry no signal at all (an idle fleet: median ~0 and
MAD ~0 against an absolute floor of 0 evidence) contribute nothing —
degenerate dispersion is not evidence, exactly like the ledger's
``no_baseline`` verdict.

**Verdicts step, never flap**: per-window instantaneous scores fold
into an EWMA suspicion score per entity, and the verdict ladder is
hysteretic —

    healthy --(window z >= suspect_z)--> suspect
    suspect --(confirm_windows consecutive hot windows)--> confirmed
    {suspect,confirmed} --(clear_windows consecutive EWMA < clear_z)--> healthy

Hot windows are judged on the instantaneous per-window z (the EWMA
lags by design, and a spike's decay tail must not impersonate
sustained evidence); quiet windows on the EWMA (one calm window must
not clear a deep suspicion).  A single-window spike suspects; only
sustained deviation confirms; a heal must hold quiet for
``clear_windows`` before the verdict clears.
An entity that was absent from a window (down, stale scrape) HOLDS its
state — no observation is not evidence of health.

Confirmation is observation-first (``TPU_ANOMALY=0`` kill switch): it
fires a flight-recorder dump and an ``anomaly.confirmed`` trace
marker, publishes ``anomaly.score.<entity>`` / ``anomaly.state.<entity>``
gauges and ``anomaly.{suspect,confirmed,cleared}`` counters, and can
feed the placement search a :meth:`AnomalyDetector.scheduler_penalty`
surcharge — evidence for the schedulers, never a veto.

The headline gate is closed-loop: the soak world knows its seeded
:class:`~container_engine_accelerators_tpu_torch.fleet.soak.SoakSchedule`,
so :func:`detection_report` judges the detector against ground truth —
recall over the seeded grey windows (each must be flagged within K
windows of onset), false positives only on CLEAN windows (collateral
suspicion while chaos is in flight is the fleet being honest, not the
detector being wrong), and the ``max_grey_detection_windows`` SLO /
``anomaly.detect_windows_max`` ledger metric carrying the latency.

Stdlib-only, like the rest of obs/.
"""

import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Set

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries, trace

log = logging.getLogger(__name__)

# Kill switch: TPU_ANOMALY=0 disables scoring and every side effect
# (gauges, counters, dumps, penalties) — the standard observation-first
# rollout contract (TPU_DCN_TUNE's first life).
KILL_SWITCH_ENV = "TPU_ANOMALY"

# Verdict states, published as the anomaly.state.<entity> gauge.
HEALTHY, SUSPECT, CONFIRMED = 0, 1, 2
STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect",
               CONFIRMED: "confirmed-grey"}

# Default detection-latency allowance (windows from fault onset to
# first flag) the closed-loop judge and the soak SLO use.
DETECT_WINDOWS_K = 2


def enabled() -> bool:
    """The kill switch verdict (default ON; ``TPU_ANOMALY=0`` off)."""
    return os.environ.get(KILL_SWITCH_ENV, "1") != "0"


@dataclass
class AnomalyConfig:
    """Detector knobs.  The defaults are deliberately conservative:
    suspicion needs a 3-sigma-equivalent robust deviation, confirmation
    needs it sustained, and clearing needs sustained quiet."""

    suspect_z: float = 3.0       # EWMA score that steps healthy->suspect
    clear_z: float = 1.5         # EWMA score below which quiet windows count
    confirm_windows: int = 2     # consecutive hot windows to confirm
    clear_windows: int = 2       # consecutive quiet windows to clear
    ewma_alpha: float = 0.5      # fold weight of the newest window
    score_cap: float = 12.0      # per-window clip: one absurd sample
    # must not take ages to decay
    rel_mad_floor: float = 0.05  # MAD floor as a fraction of |median|
    min_peers: int = 3           # fewer entities than this = no verdict
    # Observed windows to swallow before scoring: boot windows carry
    # cold-start transients (first-connection legs, half-warmed
    # histograms) with no meaningful peer baseline behind them.
    warmup_windows: int = 0


@dataclass
class Evidence:
    """One metric's per-entity values for one window.

    ``direction`` names which deviation is SICK: ``"high"`` (latency,
    RTT, busy share — bigger is worse) or ``"low"`` (goodput — smaller
    is worse).  ``abs_floor`` is the metric's absolute dispersion
    floor, in its own units: deviations under it are measurement
    noise, and a window whose every value sits under it is
    degenerate — an idle fleet, not evidence.  ``rel_floor``, when
    set, overrides the config's ``rel_mad_floor`` for THIS stream —
    the knob for streams whose healthy per-window dispersion is a
    large fraction of their magnitude (windowed byte counts quantize
    on payload boundaries: a node can honestly read half its peers'
    bytes one window and double the next).  At 0.5 such a stream can
    sustain suspicion in the EWMA but never convict on its own."""

    metric: str
    values: Dict[str, float]
    direction: str = "high"
    abs_floor: float = 0.0
    rel_floor: Optional[float] = None


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def robust_zscores(values: Dict[str, float], *, direction: str = "high",
                   abs_floor: float = 0.0, rel_mad_floor: float = 0.05,
                   min_peers: int = 3) -> Dict[str, float]:
    """Peer-relative robust z per entity: bad-direction deviation from
    the peer median over ``max(MAD, rel_mad_floor*|median|,
    abs_floor)``.  Only bad-direction deviations score (a node FASTER
    than its peers is not sick); degenerate windows — fewer than
    ``min_peers`` entities, or an idle fleet whose EVERY value sits
    under the absolute floor — score everyone 0.0: no dispersion
    baseline means no evidence, never a conviction.  Idleness is
    judged on every value, not the median: a 65ms outlier among
    sub-floor peers is the textbook one-sick-of-N, and a median test
    would wave it through as idle."""
    if len(values) < max(2, int(min_peers)):
        return {k: 0.0 for k in values}
    xs = list(values.values())
    med = _median(xs)
    mad = _median([abs(x - med) for x in xs])
    if all(abs(x) <= abs_floor for x in xs):
        return {k: 0.0 for k in values}  # idle fleet: not evidence
    denom = max(mad, rel_mad_floor * abs(med), abs_floor)
    if denom <= 0.0:
        return {k: 0.0 for k in values}
    out = {}
    for k, v in values.items():
        dev = (v - med) if direction == "high" else (med - v)
        out[k] = max(0.0, dev) / denom
    return out


class AnomalyDetector:
    """The fleet's grey-failure verdict machine: feed it one window of
    :class:`Evidence` per scrape round, read per-entity EWMA scores and
    ladder states back.  All side effects (gauges, counters, the
    confirm dump/marker) honor the kill switch; with it off,
    :meth:`observe` is inert and every entity stays healthy."""

    def __init__(self, cfg: Optional[AnomalyConfig] = None, *,
                 dump_on_confirm: bool = True):
        self.cfg = cfg or AnomalyConfig()
        self.enabled = enabled()
        self.dump_on_confirm = bool(dump_on_confirm)
        self.score: Dict[str, float] = {}
        self.state: Dict[str, int] = {}
        self._hot: Dict[str, int] = {}    # consecutive windows >= suspect_z
        self._quiet: Dict[str, int] = {}  # consecutive windows < clear_z
        # Every window in which an entity was flagged (suspect or
        # worse) — the closed-loop judge's input.
        self.flagged: Dict[str, List[int]] = {}
        self.confirmations: List[dict] = []
        self.windows_observed = 0

    # -- the per-window fold -------------------------------------------------

    def observe(self, window: int, evidence: Iterable[Evidence],
                absent: Optional[Set[str]] = None) -> Dict[str, float]:
        """Fold one window of evidence.  Each entity's instantaneous
        score is its WORST robust z across the window's metrics
        (clipped at ``score_cap``); absent entities hold their state
        and score untouched — a stale scrape is not health."""
        if not self.enabled:
            return {}
        cfg = self.cfg
        absent = absent or set()
        self.windows_observed += 1
        if self.windows_observed <= cfg.warmup_windows:
            return {}
        inst: Dict[str, float] = {}
        for ev in evidence:
            present = {k: v for k, v in ev.values.items()
                       if k not in absent}
            zs = robust_zscores(present, direction=ev.direction,
                                abs_floor=ev.abs_floor,
                                rel_mad_floor=(
                                    ev.rel_floor
                                    if ev.rel_floor is not None
                                    else cfg.rel_mad_floor),
                                min_peers=cfg.min_peers)
            for k, z in zs.items():
                inst[k] = max(inst.get(k, 0.0), min(z, cfg.score_cap))
        for entity, z in inst.items():
            prev = self.score.get(entity, 0.0)
            score = (1 - cfg.ewma_alpha) * prev + cfg.ewma_alpha * z
            self.score[entity] = score
            self._step(window, entity, score, z)
        for entity in inst:
            timeseries.gauge(f"anomaly.score.{entity}",
                             round(self.score[entity], 3))
            timeseries.gauge(f"anomaly.state.{entity}",
                             float(self.state.get(entity, HEALTHY)))
        return inst

    def _step(self, window: int, entity: str, score: float,
              inst: float) -> None:
        # Hotness is judged on the INSTANTANEOUS z: the EWMA lags by
        # design (a 12-cap spike reads 6 then 3 on the two windows
        # after), so counting consecutive hot windows on the EWMA
        # would let one spike's decay tail impersonate sustained
        # evidence and confirm.  Quiet is judged on the EWMA — the
        # slow side of the hysteresis — so clearing still demands the
        # whole suspicion to have drained, not one calm window.
        cfg = self.cfg
        state = self.state.get(entity, HEALTHY)
        hot = inst >= cfg.suspect_z
        quiet = score < cfg.clear_z
        self._hot[entity] = self._hot.get(entity, 0) + 1 if hot else 0
        self._quiet[entity] = (self._quiet.get(entity, 0) + 1
                               if quiet else 0)
        if state == HEALTHY and hot:
            state = SUSPECT
            counters.inc("anomaly.suspect")
            log.warning("anomaly: %s SUSPECT (score %.2f, window %d)",
                        entity, score, window)
        elif state == SUSPECT \
                and self._hot[entity] >= cfg.confirm_windows:
            state = CONFIRMED
            counters.inc("anomaly.confirmed")
            log.warning("anomaly: %s CONFIRMED grey (score %.2f, "
                        "window %d)", entity, score, window)
            self.confirmations.append(
                {"entity": entity, "window": window,
                 "score": round(score, 3)})
            trace.event("anomaly.confirmed", entity=entity,
                        window=window, score=round(score, 3))
            if self.dump_on_confirm:
                # Lazy import: flight pulls profiler/trace machinery
                # this module must not cost its importers.
                from container_engine_accelerators_tpu_torch.obs import flight
                flight.dump(f"anomaly confirmed: {entity}")
        elif state in (SUSPECT, CONFIRMED) \
                and self._quiet[entity] >= cfg.clear_windows:
            state = HEALTHY
            counters.inc("anomaly.cleared")
            log.info("anomaly: %s cleared (score %.2f, window %d)",
                     entity, score, window)
        self.state[entity] = state
        if state != HEALTHY:
            self.flagged.setdefault(entity, []).append(window)

    # -- read-side -----------------------------------------------------------

    def verdicts(self) -> Dict[str, dict]:
        return {
            entity: {"state": STATE_NAMES[self.state.get(entity,
                                                         HEALTHY)],
                     "score": round(self.score.get(entity, 0.0), 3)}
            for entity in sorted(self.score)
        }

    def report(self) -> dict:
        """The ``report.anomaly`` section: per-entity verdicts, every
        confirmation with its window, and the flagged-window history
        the closed-loop judge consumes."""
        return {
            "enabled": self.enabled,
            "windows": self.windows_observed,
            "verdicts": self.verdicts(),
            "confirmations": list(self.confirmations),
            "flagged_windows": {k: list(v)
                                for k, v in sorted(self.flagged.items())},
        }

    # -- the placement feed --------------------------------------------------

    def scheduler_penalty(self, *, suspect_surcharge: float = 50.0,
                          confirmed_surcharge: float = 500.0,
                          ) -> Callable[[dict, dict], float]:
        """A distance-penalty callable for
        ``calculate_pods_assignment(link_penalty=)``, the CommGraph
        idiom (collectives/topo.py): candidate nodes map back to fleet
        nodes by the HOST label, a pair touching a suspect entity pays
        ``suspect_surcharge`` (confirmed pays more), unknown hosts pay
        nothing, and the surcharge is always finite — suspicion adds
        evidence, it never vetoes a placement."""
        from container_engine_accelerators_tpu_torch.scheduler import (
            topology as sched_topo,
        )

        def penalty(node_a: dict, node_b: dict) -> float:
            if not self.enabled:
                return 0.0
            cost = 0.0
            for cand in (node_a, node_b):
                host = (cand.get("node_labels") or {}).get(
                    sched_topo.HOST_LABEL)
                state = self.state.get(host, HEALTHY) \
                    if host is not None else HEALTHY
                if state == CONFIRMED:
                    cost += confirmed_surcharge
                elif state == SUSPECT:
                    cost += suspect_surcharge
            return cost

        return penalty


# ---------------------------------------------------------------------------
# scraped-histogram evidence: per-window p99 from cumulative le buckets
# ---------------------------------------------------------------------------


def bucket_delta_p99_us(buckets: Dict[str, float],
                        baseline: Dict[str, float],
                        q: float = 0.99) -> Optional[float]:
    """Upper-bound q-quantile (µs) of the observations BETWEEN two
    scrapes of one ``agent_latency{op,bucket}`` family: cumulative le
    buckets (``+Inf`` = total) deltaed against the previous scrape.
    The scrape exports cumulative-per-bucket counts, so the delta is
    de-accumulated back to per-bucket before walking.  None when
    nothing was observed in the window (or a respawn made the delta
    nonsensical — callers reset baselines on generation change)."""
    def finite(b: Dict[str, float]) -> List[tuple]:
        out = []
        for le, n in b.items():
            if str(le) in ("+Inf", "inf"):
                continue
            try:
                out.append((float(le), float(n)))
            except (TypeError, ValueError):
                continue
        out.sort()
        return out

    cur = finite(buckets)
    base = finite(baseline)

    def base_cum_at(le: float) -> float:
        cum = 0.0
        for ble, bcum in base:
            if ble <= le:
                cum = bcum
            else:
                break
        return cum

    per_bucket: List[tuple] = []
    prev_delta_cum = 0.0
    for le, cum in cur:
        delta_cum = cum - base_cum_at(le)
        d = delta_cum - prev_delta_cum
        if d < -1e-9:
            return None  # counter went backwards: respawn, not evidence
        per_bucket.append((le, max(0.0, d)))
        prev_delta_cum = delta_cum
    total = sum(n for _, n in per_bucket)
    if total <= 0:
        return None
    target = q * total
    seen = 0.0
    for le, n in per_bucket:
        seen += n
        if seen >= target:
            return le
    return per_bucket[-1][0]


# ---------------------------------------------------------------------------
# the closed-loop judge: detector verdicts vs the seeded ground truth
# ---------------------------------------------------------------------------


@dataclass
class TruthWindow:
    """One seeded grey fault as ground truth: ``node`` was made grey
    at ``window`` for ``lifetime`` windows by fault ``kind``."""

    node: str
    window: int
    lifetime: int = 1
    kind: str = "grey"

    @property
    def end(self) -> int:
        return self.window + max(1, int(self.lifetime))


def detection_report(truth: List[TruthWindow],
                     flagged: Dict[str, List[int]],
                     windows: int, *,
                     k: int = DETECT_WINDOWS_K,
                     settle_windows: int = 4,
                     chaos_windows: Optional[Set[int]] = None,
                     ) -> dict:
    """Judge the detector against the seeded schedule.

    **Recall**: every truth entry must see its node flagged within
    ``k`` windows of onset (a flag at ``window + k`` still counts —
    evidence needs a window to accumulate).  **False positives** count
    only on CLEAN windows: a window with NO scheduled fault of any
    kind in flight fleet-wide (``chaos_windows`` — the full schedule's
    footprint, each entry padded by ``settle_windows`` of decay
    allowance after its end).  A healthy peer scored up while a grey
    node drags the whole ring is the fleet being honest about shared
    fate, not a detector bug — only a flag in a quiet fleet is.  And
    only a PERSISTENT one: a clean-window flag counts only when it is
    part of a run of consecutive flagged clean windows — the same
    persistence bar the verdict ladder demands before convicting.  A
    single hot window on a loaded host that self-clears next window
    is the hysteresis working, not a page.

    No truth at all is vacuous: recall 1.0, detect latency 0.0 — a
    clean run must never fail its own gate."""
    chaos: Set[int] = set(chaos_windows or set())
    for t in truth:
        for w in range(t.window, t.end + max(0, int(settle_windows))
                       + 1):
            chaos.add(w)
    detections = []
    missed = []
    latencies = []
    for t in truth:
        hit = None
        for w in flagged.get(t.node, []):
            if t.window <= w <= t.window + k:
                hit = w
                break
        entry = {"node": t.node, "kind": t.kind, "window": t.window,
                 "detected_window": hit,
                 "detect_windows": (hit - t.window
                                    if hit is not None else None)}
        detections.append(entry)
        if hit is None:
            missed.append(entry)
        else:
            latencies.append(hit - t.window)
    false_positives = []
    for node, ws in sorted(flagged.items()):
        clean = sorted({w for w in ws if w < windows
                        and w not in chaos})
        for i, w in enumerate(clean):
            persistent = ((i > 0 and clean[i - 1] == w - 1)
                          or (i + 1 < len(clean)
                              and clean[i + 1] == w + 1))
            if persistent:
                false_positives.append({"node": node, "window": w})
    recall = (1.0 if not truth
              else (len(truth) - len(missed)) / len(truth))
    return {
        "truth": len(truth),
        "recall": round(recall, 3),
        "k": int(k),
        "detections": detections,
        "missed": missed,
        "detect_windows_max": float(max(latencies) if latencies
                                    else 0.0),
        "false_positives": false_positives,
        "false_positive_count": len(false_positives),
        "clean_windows": max(0, windows - len(
            [w for w in chaos if 0 <= w < windows])),
    }
