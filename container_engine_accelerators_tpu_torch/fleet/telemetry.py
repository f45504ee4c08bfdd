"""Fleet telemetry: per-round scrapes + declarative SLO verdicts.

The port's copy of ``container_engine_accelerators_tpu/fleet/telemetry.py``
(host code: no torch): the same names, counters and spans byte for byte.

The fleet report (fleet/controller.py) already says whether a scenario
*converged* — every surviving node's final legs completed.  That is a
liveness verdict, and liveness is a low bar: a fleet that re-sends
every chunk three times through a lossy link still converges while
delivering a third of the bandwidth anyone provisioned for.  This
module adds the quality verdict:

- **scrape**: each round the aggregator reads every emulated node's
  telemetry into a round-indexed history.  In the one-process rig the
  series registry IS the fleet's (windowed goodput per ``{node,
  link}`` from obs/timeseries.py, keyed by the ``goodput.node.<n>`` /
  ``goodput.link.<a>-><b>`` naming convention, plus each daemon's flow
  accounting).  In **process mode** (``proc: true`` scenarios) there
  is no shared registry: the aggregator scrapes each node worker's
  MetricServer over HTTP — per-node timeout, one retry, and a
  ``stale: true`` verdict on the round entry when a node cannot be
  scraped (down, killed, or just slow), so one dead node degrades the
  report instead of hanging the round;

- **SLOs**: the scenario spec's ``slo:`` mapping declares ceilings and
  floors, evaluated over the whole run::

      slo:
        p99_leg_ms: 250            # ceiling: p99 of fleet.leg latency
        min_goodput_bps: 4096      # floor: delivered link bytes/s
        max_retransmit_ratio: 0.5  # cap: (drops + dups) / frames
        max_dedup_ratio: 0.25      # cap: dups / frames

  Unknown keys are logged and skipped — the TPU_FAULT_SPEC rule: a
  typo'd scenario must degrade, not crash the rig.  Each check also
  lands in the gauge registry as ``slo.<key>.ok`` / ``slo.<key>.value``
  so the MetricServer scrape (``agent_gauge``), ``cmd/agent_top.py``,
  and the flight recorder all show SLO state live.

  In scrape mode the measurements come from the HTTP history instead
  of the link table (process workers see no link fabric): the goodput
  floor is judged over the per-round scraped ``goodput.node.*`` sums
  with **stale windows skipped** (a round where a node was down must
  not count as zero goodput against the floor — the kill is the
  scenario's point), and the retransmit/dedup ratios come from each
  worker's scraped ``dcn.frames.deduped`` / ``xferd.frames.landed``
  counters, accumulated restart-aware (a respawned worker's counters
  restart at zero; the aggregator sums increments, not raw values).

- **spans**: each round the aggregator also pages the span evidence
  the report's ``critical_path`` section (obs/critpath.py) is built
  from — the coordinator's own ring by cursor (``trace.tail_since``;
  the transfer clients and the serving frontend live coordinator-side
  in both modes), plus, in scrape mode, every worker's ``/spans``
  endpoint under the same timeout/stale discipline as the metric
  scrape (``fleet.scrape.spans_stale``).  Collection is bounded
  (``MAX_COLLECTED_SPANS``); overflow drops oldest and is counted,
  never hidden.

- **profile**: each round the aggregator also pages every worker's
  ``/profile`` endpoint (the continuous profiler, obs/profiler.py)
  under the same timeout/one-retry/stale rules
  (``fleet.scrape.profile_stale``), merging cumulative folded-stack
  counts restart-aware — a respawned worker's samples restart at
  zero, so the merge sums increments keyed by incarnation, exactly
  like the counter accumulator.  :meth:`FleetTelemetry.profile_report`
  renders the merged result (per-node and fleet-wide top-N stacks +
  subsystem rollups) into the report's ``profile`` section.

The controller folds :meth:`FleetTelemetry.evaluate`'s result into the
report's ``slo`` section and ``cmd/fleet_sim.py`` exits non-zero on
breach — a fleet that converges while violating its goodput floor
fails CI, not just a dashboard.
"""

import json
import logging
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import (
    anomaly,
    histo,
    profiler,
    promtext,
    timeseries,
    trace,
)

log = logging.getLogger(__name__)

# Per-node HTTP scrape budget (scrape mode): one attempt + one retry,
# each under this timeout — a dead node costs the round at most
# 2 * timeout and a `stale` entry, never a hang.
DEFAULT_SCRAPE_TIMEOUT_S = 1.0

# Span-collection bounds: per-GET page size against each worker's
# /spans endpoint, and the retained fleet-wide span cap (oldest spans
# drop first; the count dropped is reported, never hidden).
SPANS_SCRAPE_LIMIT = 2048
MAX_COLLECTED_SPANS = 20000

# Profile scrape page size: the worker registry is LRU-bounded at
# profiler.MAX_STACKS, so one page at this limit is always complete.
PROFILE_SCRAPE_LIMIT = profiler.SCRAPE_MAX_LIMIT
# Top-N folded stacks the report's profile section keeps per node and
# fleet-wide (agent_prof renders more detail from a live scrape).
PROFILE_REPORT_TOP_N = 20

# SLO key -> (kind, description).  Ceilings fail when value > limit,
# floors when value < limit.
SLO_KEYS = {
    "p99_leg_ms": ("ceiling", "p99 of fleet.leg latency (ms)"),
    "min_goodput_bps": ("floor", "delivered link bytes per second"),
    # The recovery floor (the self-tuning data plane's acceptance
    # gate): goodput over the LAST sampled round with live telemetry —
    # a scenario that degrades a link mid-run and heals it passes only
    # if the fleet is back above this floor by the end, with no
    # operator knob change.  Judged from the same per-round node
    # goodput history in both fleet modes; stale entries are skipped
    # exactly like the whole-run floor.
    "min_final_goodput_bps": ("floor",
                              "delivered bytes per second over the "
                              "final sampled round (post-heal "
                              "recovery floor)"),
    "max_retransmit_ratio": ("ceiling",
                             "(link drops + deduped replays) / frames"),
    "max_dedup_ratio": ("ceiling", "deduped replays / frames"),
    # Serving SLOs (workload: serving — serving/frontend.py).  The
    # frontend lives in the COORDINATOR process in both fleet modes,
    # so these are judged from this process's registries either way;
    # only the byte-level goodput/ratio inputs flip to HTTP scrapes.
    "p99_e2e_ms": ("ceiling",
                   "p99 of serving end-to-end request latency (ms)"),
    "min_qps": ("floor", "completed (ok) serving requests per second"),
    "max_error_ratio": ("ceiling",
                        "errored serving requests / terminated"),
    # Collective SLOs (workload: collective — collectives/runner.py).
    # The engine runs in the COORDINATOR process in both fleet modes,
    # so these are judged from the controller-fed round history either
    # way: bus bandwidth follows bench.py's nccl-tests conventions
    # (busbw = algbw * bus_factor(op, n)), and only rounds that
    # completed AND verified count — a failed round contributes no
    # bandwidth rather than a flattering zero-time sample.
    "min_busbw_bps": ("floor",
                      "mean collective bus bandwidth over completed "
                      "rounds (bytes/s)"),
    "min_final_busbw_bps": ("floor",
                            "bus bandwidth of the final completed "
                            "collective round (bytes/s) — the "
                            "post-heal recovery floor"),
    # Routed-mode lane accounting (collective: {routed: true}): the
    # forwarding-plane proof as SLOs.  The floor demands the daemons
    # actually moved payload daemon->daemon; the ceiling (0 in the
    # pinned scenarios) is the pure-control-plane claim — any leg
    # payload crossing a coordinator client (a downgraded leg) is
    # counted against it.
    "min_forward_bytes": ("floor",
                          "daemon-forwarded payload bytes over "
                          "completed routed collective rounds"),
    "max_coordinator_leg_bytes": ("ceiling",
                                  "routed-leg payload bytes that "
                                  "crossed coordinator clients "
                                  "(downgraded legs; 0 = pure "
                                  "control plane)"),
    # Exposed-communication ceiling (obs/critpath.py): DCN time not
    # hidden behind staging, over the run's pipelined transfers.  The
    # inputs (`dcn.exposed` / `dcn.comm` histogram sums) are recorded
    # by the transfer CLIENTS, which live in the coordinator process
    # in BOTH fleet modes — so this is judged coordinator-side, no
    # scrape needed.  A run with no pipelined transfers measures 0.0
    # (vacuously inside any ceiling).
    "max_exposed_comm_ratio": ("ceiling",
                               "exposed DCN time / total DCN time "
                               "(pipelined transfers, this run)"),
    # Grey-failure detection latency (obs/anomaly.py): worst
    # windows-from-onset over the run's seeded grey faults, judged
    # closed-loop against the soak schedule's ground truth.  A run
    # with no seeded grey truth measures 0.0 (vacuous); a seeded grey
    # window the detector never flagged measures the whole run length
    # — honestly past any sane ceiling.
    "max_grey_detection_windows": ("ceiling",
                                   "worst windows-to-flag over the "
                                   "seeded grey faults (0 = none "
                                   "seeded; a miss measures the run "
                                   "length)"),
}

# Windows an idle node's last histogram p99 stands in as peer
# baseline before aging out (see _anom_hold_fill).
ANOMALY_HOLD_WINDOWS = 3

# The per-node attribution histograms the anomaly detector compares
# across peers, scraped as cumulative agent_latency{op,bucket} families
# and deltaed per window: the ring completer's per-descriptor drive and
# the shm lane's per-frame commit — one op per grey-fault modality.
ANOMALY_HISTO_OPS = ("xferd.ring.drive", "xferd.shm.commit")

# The latency histogram the p99 ceiling reads; one fleet-sim leg with
# its retries included (fleet/controller.py stamps it).
LEG_OP = "fleet.leg"
# The serving end-to-end histogram (submit -> delivery, per request).
E2E_OP = "serving.e2e"
# Coordinator-side serving counters the qps/error SLOs read (delta
# against the boot baseline, like the leg histogram).
SERVING_COUNTERS = ("serving.ok", "serving.errors")


def parse_slo_spec(raw: Optional[dict]) -> Dict[str, float]:
    """Validate a scenario's ``slo:`` mapping: known keys with numeric
    values survive, everything else is logged and dropped — including
    a section that is not a mapping at all (a YAML authoring typo must
    cost the SLOs, not the run)."""
    if raw is None:
        return {}
    if not isinstance(raw, dict):
        log.error("ignoring slo section of type %s (want a mapping)",
                  type(raw).__name__)
        return {}
    spec: Dict[str, float] = {}
    for key, value in raw.items():
        if key not in SLO_KEYS:
            log.error("ignoring unknown SLO key %r (known: %s)",
                      key, ", ".join(sorted(SLO_KEYS)))
            continue
        try:
            spec[key] = float(value)
        except (TypeError, ValueError):
            log.error("ignoring SLO %r with non-numeric limit %r",
                      key, value)
    return spec


class ScrapeError(OSError):
    """One node's /metrics endpoint could not be read (connection
    refused, timeout, bad body) — the per-node degradation signal."""


class NodeScrape:
    """One parsed Prometheus exposition: labeled samples per family."""

    def __init__(self, families: Dict[str, List[Tuple[dict, float]]]):
        self._families = families

    def value(self, family: str, default: float = 0.0,
              **labels: str) -> float:
        """First sample of ``family`` whose labels include ``labels``
        (absent family/labels -> ``default`` — an idle node and a
        never-active one scrape the same, like timeseries.rate)."""
        for lab, v in self._families.get(family, []):
            if all(lab.get(k) == want for k, want in labels.items()):
                return v
        return default

    def buckets(self, family: str, **labels: str) -> Dict[str, float]:
        """Every sample of ``family`` matching ``labels``, keyed by
        its ``bucket`` label — the ``agent_latency{op,bucket}``
        cumulative-histogram reader (empty dict when the op never
        observed anything on this node)."""
        out: Dict[str, float] = {}
        for lab, v in self._families.get(family, []):
            if all(lab.get(k) == want for k, want in labels.items()) \
                    and lab.get("bucket") is not None:
                out[lab["bucket"]] = v
        return out


def parse_prometheus_text(body: str) -> NodeScrape:
    return NodeScrape(promtext.parse_samples(body))


def scrape_metric_server(port: int,
                         timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
                         host: str = "127.0.0.1") -> NodeScrape:
    """One GET of a node's /metrics, parsed.  Raises
    :class:`ScrapeError` on any transport or parse trouble."""
    url = f"http://{host}:{int(port)}/metrics"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            body = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise ScrapeError(f"scrape of {url} failed: {e}") from e
    return parse_prometheus_text(body)


def scrape_spans(port: int, since: int,
                 timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
                 host: str = "127.0.0.1",
                 limit: int = SPANS_SCRAPE_LIMIT):
    """One GET of a node's ``/spans?since=<cursor>``: returns
    ``(spans, next_cursor, dropped)``.  Raises :class:`ScrapeError` on
    transport/parse trouble — callers apply the same stale discipline
    as metric scrapes."""
    url = (f"http://{host}:{int(port)}/spans?since={int(since)}"
           f"&limit={int(limit)}")
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            obj = json.loads(resp.read().decode("utf-8", "replace"))
        spans = obj.get("spans")
        cursor = int(obj.get("cursor", since))
        dropped = int(obj.get("dropped") or 0)
        if not isinstance(spans, list):
            raise ValueError("spans is not a list")
    except (urllib.error.URLError, OSError, ValueError, TypeError) as e:
        raise ScrapeError(f"span scrape of {url} failed: {e}") from e
    return spans, cursor, dropped


def scrape_profile(port: int, since: int,
                   timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
                   host: str = "127.0.0.1",
                   limit: int = PROFILE_SCRAPE_LIMIT):
    """One GET of a node's ``/profile?since=<cursor>``: returns
    ``(stacks, next_cursor, samples, dropped, subsystems)``.  Raises
    :class:`ScrapeError` on transport/parse trouble — callers apply
    the same stale discipline as metric and span scrapes."""
    url = (f"http://{host}:{int(port)}/profile?since={int(since)}"
           f"&limit={int(limit)}")
    try:
        obj = profiler.fetch(url, timeout_s)
        stacks_raw = obj.get("stacks")
        subs_raw = obj.get("subsystems") or {}
        if not isinstance(stacks_raw, list) \
                or not isinstance(subs_raw, dict):
            raise ValueError("malformed /profile body")
        # Normalize every numeric field HERE, inside the degradation
        # boundary: a port reused by some other process (a SIGKILLed
        # worker's successor) can answer JSON that passes the shape
        # check with garbage counts — that must cost a counted stale
        # miss, never an exception out of the round loop.
        stacks = [{"stack": str(e["stack"]),
                   "subsystem": str(e.get("subsystem", "other")),
                   "count": float(e.get("count") or 0)}
                  for e in stacks_raw
                  if isinstance(e, dict) and "stack" in e]
        subsystems = {str(k): float(v or 0)
                      for k, v in subs_raw.items()}
        cursor = int(obj.get("cursor", since))
        samples = float(obj.get("samples") or 0)
        dropped = float(obj.get("dropped") or 0)
    except (urllib.error.URLError, OSError, ValueError,
            TypeError, KeyError) as e:
        raise ScrapeError(f"profile scrape of {url} failed: {e}") from e
    return stacks, cursor, samples, dropped, subsystems


class FleetTelemetry:
    """Scrapes the fleet's telemetry each round and renders the SLO
    verdict at the end of the run.

    ``scrape=True`` (process-mode fleets) aggregates over HTTP from
    each node's MetricServer instead of reading this process's
    registries — the in-process registry reads are gone from that
    path entirely; a node that cannot be scraped degrades to a
    ``stale`` round entry instead of raising.
    """

    def __init__(self, nodes: dict, links, slo: Optional[dict] = None,
                 *, scrape: bool = False,
                 scrape_timeout_s: float = DEFAULT_SCRAPE_TIMEOUT_S,
                 learned_slo: Optional[dict] = None):
        self.nodes = nodes
        self.links = links
        self.slo = parse_slo_spec(slo)
        # History-learned SLO limits (obs/history.learned_limit
        # shapes: {key: {"limit", "source", "n", ...}}), applied on
        # top of the scenario's pinned limits in evaluate() — a
        # learned limit may TIGHTEN a check, never relax it past the
        # pinned constant (fleet/soak.py feeds this from prior runs'
        # measured values under TPU_HISTORY_DIR).
        self.learned_slo: Dict[str, dict] = dict(learned_slo or {})
        self.scrape = bool(scrape)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.history: List[dict] = []
        # Restart-aware counter accumulation per node: worker counters
        # reset to zero on respawn, so the fleet totals sum increments
        # between scrapes, treating a decrease as a fresh process.
        self._accum: Dict[str, Dict[str, float]] = {}
        # Same-generation counter DECREASES — dropped from the totals
        # (see _accumulate) but recorded here, because a worker whose
        # cumulative counters go backwards without a respawn is a
        # monotonicity violation the soak sentinel must see, not just
        # a sample to silently skip.
        self.misreads: List[dict] = []
        self._t0 = time.monotonic()
        # Histograms are process-global and cumulative; the p99 SLOs
        # must judge THIS run only, so snapshot their buckets at boot
        # and evaluate the delta (the same baseline discipline
        # FleetController applies to counters).
        self._leg0: Dict[str, int] = dict(
            histo.snapshot().get(LEG_OP, {}).get("buckets", {}))
        self._e2e0: Dict[str, int] = dict(
            histo.snapshot().get(E2E_OP, {}).get("buckets", {}))
        self._serving0 = {k: counters.get(k) for k in SERVING_COUNTERS}
        # Exposed-comm SLO inputs: run-delta of the dcn.exposed /
        # dcn.comm histogram SUMS (coordinator-side in both modes —
        # the transfer clients live here).
        self._exposed_sum0 = histo.snapshot().get(
            "dcn.exposed", {}).get("sum_us", 0.0)
        self._comm_sum0 = histo.snapshot().get(
            "dcn.comm", {}).get("sum_us", 0.0)
        # Span collection for the report's critical_path section: the
        # coordinator's own ring is paged by cursor each round (the
        # clients' pipeline/serving spans live here); scrape-mode
        # fleets ALSO page each worker's /spans endpoint, so the
        # daemon-side halves of the same traces merge in.
        self._spans: List[dict] = []
        self._spans_dropped = 0
        self._local_cursor = 0
        self._span_cursors: Dict[str, int] = {}
        # Continuous-profiler collection (the report's ``profile``
        # section): per-node merged folded stacks, accumulated
        # restart-aware like the counters — a worker's cumulative
        # stack counts restart at zero on respawn, so the merge sums
        # increments keyed by incarnation.  Scraped per round so a
        # SIGKILL costs at most one round of samples, never the run's.
        self._prof: Dict[str, dict] = {}
        self._prof_cursors: Dict[str, int] = {}
        # The coordinator's own profiler registry is cumulative for
        # the process (like the histograms), so the report's
        # coordinator entry judges THIS run only: snapshot at boot,
        # delta at report time.
        self._prof0 = profiler.snapshot()
        # Collective round history (workload: collective): the
        # controller appends one entry per round — the engine lives
        # coordinator-side in both modes, so the busbw SLOs never
        # need the scrape path.
        self.collective_rounds: List[dict] = []
        # Grey-failure detection (obs/anomaly.py): peer-relative
        # robust z-scores per window folded into hysteretic per-node
        # verdicts.  Evidence per round: per-node goodput, scrape RTT,
        # profiler busy-share deltas, per-window p99s of the
        # attribution histograms (ANOMALY_HISTO_OPS), and fleet.leg
        # span latency per source node.  TPU_ANOMALY=0 makes all of
        # it inert.  One warmup window: the boot round's cold-start
        # transients (first-connection legs, half-warmed histograms)
        # have no peer baseline worth judging against.
        self.anomaly = anomaly.AnomalyDetector(
            anomaly.AnomalyConfig(warmup_windows=1))
        # Ground truth, fed by the soak world DURING the run (the
        # report is assembled before the soak section exists): seeded
        # grey-family faults as TruthWindow dicts, plus the FULL
        # schedule's window footprint — false positives only count on
        # windows with no scheduled fault of any kind in flight.
        self.anomaly_truth: List[dict] = []
        self.anomaly_chaos: set = set()
        # Per-(node, op) cumulative-bucket baselines for the windowed
        # histogram deltas, reset on worker generation change (a
        # respawned worker's buckets restart at zero).
        self._anom_buckets: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._anom_bucket_gen: Dict[str, Optional[int]] = {}
        # Last-seen merged profiler totals per node, for the
        # per-window busy-share delta (the merge is already
        # restart-aware, so these totals are monotone).
        self._anom_prof_last: Dict[str, Tuple[float, float]] = {}
        # The window under assembly: {metric_op: {node: value}},
        # rebuilt each sample_round by the scrape path.
        self._anom_window: Dict[str, Dict[str, float]] = {}
        # Last-observation-carried-forward state for the sparse
        # histogram streams: {(node, stream): (p99, windows_held)}.
        self._anom_histo_hold: Dict[
            Tuple[str, str], Tuple[float, int]] = {}
        # Last (generation, cumulative transferred) per node, for the
        # WINDOWED goodput evidence.  The workers' own goodput gauge
        # is a lifetime average, and a lifetime average poisons the
        # peer comparison after a respawn: the fresh process's reset
        # counters read as roughly half its peers' goodput for the
        # remainder of the run — a systematic false conviction.
        self._anom_goodput_last: Dict[
            str, Tuple[Optional[int], float]] = {}

    # -- per-round scrape ----------------------------------------------------

    def sample_round(self, rnd: int) -> dict:
        """One scrape across every node: windowed goodput per node and
        per link, plus each live daemon's flow accounting.  The entry
        schema is identical in both modes; scrape mode adds HTTP as
        the transport and ``stale`` as the degradation verdict."""
        per_node = {}
        self._anom_window = {}
        for name, node in self.nodes.items():
            if self.scrape:
                per_node[name] = self._scrape_entry(name, node)
                continue
            entry = {
                "goodput_bps": round(
                    timeseries.rate(f"goodput.node.{name}"), 1),
                "down": node.down,
                "stale": False,
            }
            if not node.down:
                stats = node.daemon._stats()
                entry["active_flows"] = stats["active_flows"]
                entry["transferred"] = stats["total_transferred"]
            per_node[name] = entry
        per_link = {
            key: round(timeseries.rate(f"goodput.link.{key}"), 1)
            for key in self.links.report()
        } if not self.scrape else {}
        sample = {"round": rnd, "nodes": per_node,
                  "links_goodput_bps": per_link}
        if not self.scrape:
            # Lane evidence, fleet-wide: in-process daemons share one
            # gauge registry, so the split is global here; proc mode
            # carries it per node inside each scraped entry instead.
            gauges = timeseries.gauges()
            lanes = {
                lane: int(gauges.get(f"dcn.lane.{lane}.total_bytes",
                                     0.0))
                for lane in ("shm_direct", "shm", "socket")
            }
            if any(lanes.values()):
                sample["lanes_total_bytes"] = lanes
        self.history.append(sample)
        before = len(self._spans)
        self._drain_local_spans()
        if self.anomaly.enabled:
            # This round's coordinator spans (the drain may trim from
            # the front at the cap; then the whole tail stands in —
            # blurrier evidence, never an index error).
            fresh = (self._spans[before:]
                     if len(self._spans) >= before
                     else list(self._spans))
            self._anomaly_observe(rnd, per_node, fresh)
        return sample

    # -- grey-failure evidence (obs/anomaly.py) ------------------------------

    def _anomaly_observe(self, rnd: int, per_node: Dict[str, dict],
                         fresh_spans: List[dict]) -> None:
        """Fold one window of peer-comparable evidence into the
        detector.  Every stream is optional — a window where a stream
        carries no signal (idle lane, degenerate dispersion, too few
        peers) contributes nothing, and a stale/down node holds its
        verdict instead of scoring."""
        absent = {n for n, e in per_node.items()
                  if e.get("stale") or e.get("down")}
        evidence = [anomaly.Evidence(
            "goodput_win_bytes", self._anom_goodput(per_node),
            direction="low", abs_floor=4096.0, rel_floor=0.5)]
        rtts = {n: float(e["scrape_rtt_s"])
                for n, e in per_node.items() if "scrape_rtt_s" in e}
        if rtts:
            evidence.append(anomaly.Evidence(
                "scrape_rtt_s", rtts, direction="high",
                abs_floor=0.02))
        # Worst fleet.leg latency per SOURCE node this round — the
        # legs live coordinator-side in both fleet modes, so this
        # stream needs no scrape.
        legs: Dict[str, float] = {}
        for sp in fresh_spans:
            if sp.get("name") != LEG_OP:
                continue
            src = (sp.get("attrs") or {}).get("src")
            if src in per_node:
                legs[src] = max(legs.get(src, 0.0),
                                float(sp.get("dur_us") or 0.0))
        if legs:
            # Worst-leg latency is heavy-tailed even on a healthy
            # fleet (burst alignment, connection reuse), and a slow
            # DESTINATION drags its sources' legs too — corroborating
            # evidence, so the wide rel_floor keeps it from convicting
            # alone the way the node-local histograms may.
            evidence.append(anomaly.Evidence(
                "leg_dur_us", legs, direction="high",
                abs_floor=4096.0, rel_floor=0.5))
        for op, vals in self._anom_window.items():
            floor = 0.15 if op == "busy_share" else 4096.0
            if op != "busy_share":
                vals = self._anom_hold_fill(op, vals, per_node,
                                            absent)
            evidence.append(anomaly.Evidence(
                op, vals, direction="high", abs_floor=floor))
        self.anomaly.observe(rnd, evidence, absent=absent)

    def _anom_hold_fill(self, op: str, vals: Dict[str, float],
                        per_node: Dict[str, dict],
                        absent: Set[str]) -> Dict[str, float]:
        """Last-observation-carried-forward for the sparse histogram
        streams: a node that performed no ops this window contributes
        its last measured p99 (for up to ANOMALY_HOLD_WINDOWS) as the
        peer baseline.  Without it, one quiet node silences the whole
        stream under min_peers — exactly when a peer's throttle
        spikes and the conviction matters most."""
        out = dict(vals)
        for n in per_node:
            if n in out:
                self._anom_histo_hold[(n, op)] = (out[n], 0)
                continue
            if n in absent:
                continue
            held = self._anom_histo_hold.get((n, op))
            if held and held[1] < ANOMALY_HOLD_WINDOWS:
                out[n] = held[0]
                self._anom_histo_hold[(n, op)] = (held[0],
                                                  held[1] + 1)
        return out

    def _anom_goodput(self, per_node: Dict[str, dict]
                      ) -> Dict[str, float]:
        """Windowed goodput per node: the delta of each node's
        cumulative transferred total since the last window, keyed by
        worker incarnation.  A respawned node is judged on what its
        NEW process moved this window — its reset lifetime average
        would read grey for the rest of the run.  Sharper, too: a
        grey window's stall shows whole in its own delta instead of
        diluted into the run-long mean."""
        out: Dict[str, float] = {}
        for n, e in per_node.items():
            tot = e.get("transferred")
            if tot is None:
                # Down/stale entries carry no total (and sit in the
                # absent set); anything else falls back to the gauge.
                out[n] = float(e.get("goodput_bps") or 0.0)
                continue
            gen = getattr(getattr(self.nodes.get(n), "daemon", None),
                          "generation", None)
            last_gen, last_tot = self._anom_goodput_last.get(
                n, (gen, 0.0))
            if gen != last_gen:
                last_tot = 0.0
            self._anom_goodput_last[n] = (gen, float(tot))
            out[n] = max(0.0, float(tot) - last_tot)
        return out

    def _anom_fold_node(self, name: str, s: NodeScrape,
                        gen: Optional[int]) -> None:
        """One scraped node's contribution to the window under
        assembly: per-window p99s of the attribution histograms
        (cumulative le buckets deltaed against the last scrape,
        baselines reset on respawn) and the profiler busy-share delta
        (the merged profile totals are already restart-aware)."""
        if gen is not None and self._anom_bucket_gen.get(name) != gen:
            for op in ANOMALY_HISTO_OPS:
                self._anom_buckets.pop((name, op), None)
                self._anom_histo_hold.pop(
                    (name, f"{op}.p99_us"), None)
            self._anom_bucket_gen[name] = gen
            self._anom_prof_last.pop(name, None)
        for op in ANOMALY_HISTO_OPS:
            cur = s.buckets("agent_latency", op=op)
            base = self._anom_buckets.get((name, op), {})
            self._anom_buckets[(name, op)] = cur
            if not cur:
                continue
            p99 = anomaly.bucket_delta_p99_us(cur, base)
            if p99 is not None:
                self._anom_window.setdefault(
                    f"{op}.p99_us", {})[name] = p99
        st = self._prof.get(name)
        if st:
            samples = float(st["samples"])
            idle = float(st["subsystems"].get("idle", 0.0))
            last_s, last_i = self._anom_prof_last.get(name,
                                                     (0.0, 0.0))
            self._anom_prof_last[name] = (samples, idle)
            ds, di = samples - last_s, idle - last_i
            if ds > 0:
                busy = max(0.0, ds - max(0.0, di)) / ds
                self._anom_window.setdefault("busy_share",
                                             {})[name] = busy

    def anomaly_report(self) -> dict:
        """The report's ``anomaly`` section: the detector's verdicts
        plus — when the soak world fed seeded ground truth — the
        closed-loop precision/recall judgment."""
        rep = self.anomaly.report()
        if self.anomaly_truth:
            rep["detection"] = self.detection_summary()
        return rep

    def detection_summary(self,
                          k: int = anomaly.DETECT_WINDOWS_K) -> dict:
        truth = [anomaly.TruthWindow(**t) for t in self.anomaly_truth]
        return anomaly.detection_report(
            truth, self.anomaly.flagged,
            self.anomaly.windows_observed, k=k,
            chaos_windows=self.anomaly_chaos)

    def _grey_detection_windows(self) -> float:
        """The max_grey_detection_windows SLO input: 0.0 with no
        seeded truth (vacuous), the worst windows-to-flag otherwise —
        and a MISS measures the whole run length, honestly outside
        any sane ceiling."""
        if not self.anomaly_truth:
            return 0.0
        det = self.detection_summary()
        if det["missed"]:
            return float(max(self.anomaly.windows_observed,
                             det["k"] + 1))
        return det["detect_windows_max"]

    # -- span collection (the critical_path section's evidence) --------------

    def _keep_spans(self, spans: List[dict]) -> None:
        self._spans.extend(spans)
        over = len(self._spans) - MAX_COLLECTED_SPANS
        if over > 0:
            del self._spans[:over]
            self._spans_dropped += over

    def _drain_local_spans(self) -> None:
        """Page the COORDINATOR's span ring by cursor — per round, so
        a long scenario outrunning the ring loses (and counts) spans
        instead of silently keeping only the tail."""
        spans, self._local_cursor, dropped = trace.tail_since(
            self._local_cursor)
        self._spans_dropped += dropped
        self._keep_spans(spans)

    def _scrape_node_spans(self, name: str, node) -> bool:
        """One worker's /spans page, same timeout/stale discipline as
        the metric scrape (one attempt + one retry, degrade to a
        counted miss — never a hang, never an exception).  The cursor
        is respawn-aware, like the counter accumulator: a new worker
        incarnation's ring restarts at sequence 0, so carrying the
        dead incarnation's cursor would silently skip everything the
        fresh process recorded — reset to 0 on a generation change."""
        gen = getattr(getattr(node, "daemon", None), "generation",
                      None)
        key = "_gen_" + name
        if gen is not None and self._span_cursors.get(key) != gen:
            self._span_cursors[name] = 0
            self._span_cursors[key] = gen
        last: Optional[ScrapeError] = None
        for _attempt in range(2):
            try:
                spans, cursor, dropped = scrape_spans(
                    node.metrics_port,
                    self._span_cursors.get(name, 0),
                    self.scrape_timeout_s)
                self._span_cursors[name] = cursor
                self._spans_dropped += dropped
                self._keep_spans(spans)
                return True
            except ScrapeError as e:
                last = e
        counters.inc("fleet.scrape.spans_stale")
        log.warning("node %s span scrape degraded to stale: %s",
                    name, last)
        return False

    def spans(self) -> List[dict]:
        """Every span collected so far (coordinator ring + scraped
        workers), with a final local drain so the report sees the last
        round's tail — the critical_path section's input."""
        self._drain_local_spans()
        return list(self._spans)

    @property
    def spans_dropped(self) -> int:
        return self._spans_dropped

    # -- profile collection (the report's ``profile`` section) ---------------

    def _scrape_node_profile(self, name: str, node) -> bool:
        """One worker's /profile page, same timeout/stale discipline
        as the metric and span scrapes (one attempt + one retry,
        degrade to a counted miss — never a hang, never a raise).
        The cursor is respawn-aware like the span cursor: a fresh
        incarnation's sample sequence restarts at 0, so a generation
        change resets the cursor instead of silently skipping
        everything the new process sampled."""
        gen = getattr(getattr(node, "daemon", None), "generation",
                      None)
        key = "_gen_" + name
        if gen is not None and self._prof_cursors.get(key) != gen:
            self._prof_cursors[name] = 0
            self._prof_cursors[key] = gen
        last: Optional[ScrapeError] = None
        for _attempt in range(2):
            try:
                stacks, cursor, samples, dropped, subsystems = \
                    scrape_profile(node.metrics_port,
                                   self._prof_cursors.get(name, 0),
                                   self.scrape_timeout_s)
                self._prof_cursors[name] = cursor
                self._merge_profile(name, stacks, samples, dropped,
                                    subsystems, gen)
                return True
            except ScrapeError as e:
                last = e
        counters.inc("fleet.scrape.profile_stale")
        log.warning("node %s profile scrape degraded to stale: %s",
                    name, last)
        return False

    def _merge_profile(self, name: str, stacks: List[dict],
                       samples: float, dropped: float,
                       subsystems: Dict[str, float],
                       gen: Optional[int] = None) -> None:
        """Fold one scraped /profile page into ``name``'s merged
        profile, restart-aware: every scraped count is cumulative for
        the worker's life, so the merge adds increments against the
        last-seen value — a generation change means a fresh process
        (everything it shows is new increment), and a same-incarnation
        decrease is a misread to drop, exactly like `_accumulate`."""
        st = self._prof.setdefault(name, {
            "stacks": {}, "subsystems": {}, "samples": 0.0,
            "dropped": 0.0, "_last": {}, "_gen": None,
        })
        if gen is not None and gen != st["_gen"]:
            st["_last"] = {}
            st["_gen"] = gen

        def fold(key, current, bump, decrease="drop"):
            current = float(current)
            last = st["_last"].get(key, 0.0)
            if current < last:
                if gen is not None and decrease == "drop":
                    return  # same incarnation: a misread, drop it
                # Fresh accumulation: no gen evidence means a fresh
                # process; decrease="fresh" means the worker's LRU
                # legitimately evicted and re-admitted this stack
                # (its pre-eviction samples are already merged, and
                # the evicted remainder was counted in `dropped`).
                delta = current
            else:
                delta = current - last
            st["_last"][key] = current
            bump(delta)

        fold(("total", "samples"), samples,
             lambda d: st.__setitem__("samples", st["samples"] + d))
        fold(("total", "dropped"), dropped,
             lambda d: st.__setitem__("dropped", st["dropped"] + d))
        for sub, count in subsystems.items():
            fold(("sub", sub), count,
                 lambda d, s=sub: st["subsystems"].__setitem__(
                     s, st["subsystems"].get(s, 0.0) + d))
        for entry in stacks:
            stack = entry.get("stack")
            if not isinstance(stack, str):
                continue
            sub = str(entry.get("subsystem", "other"))
            # decrease="fresh": the worker profiler never resets its
            # registry mid-life, so a same-incarnation PER-STACK
            # decrease can only be LRU eviction + re-admission — the
            # new count is new accumulation, not a misread.  (The
            # totals and subsystem counters above are monotonic for
            # the worker's life, so a decrease there stays a misread.)
            fold(("stack", stack), entry.get("count", 0),
                 lambda d, s=stack, m=sub: st["stacks"].__setitem__(
                     s, {"subsystem": m,
                         "count": st["stacks"].get(
                             s, {"count": 0.0})["count"] + d}),
                 decrease="fresh")

    def profile_report(self,
                       top_n: int = PROFILE_REPORT_TOP_N) -> dict:
        """The report's ``profile`` section: per-node merged folded
        stacks (scraped workers plus this process's own profiler when
        it sampled anything — the coordinator runs the transfer
        clients in both fleet modes) and the fleet-wide aggregate,
        each with a subsystem rollup and the top-N stacks."""

        def top(stacks: Dict[str, dict], n: int) -> List[dict]:
            rows = sorted(stacks.items(),
                          key=lambda kv: (-kv[1]["count"], kv[0]))
            return [{"stack": s, "subsystem": m["subsystem"],
                     "count": int(m["count"])}
                    for s, m in rows[:n] if m["count"] > 0]

        merged = {
            name: {"stacks": dict(st["stacks"]),
                   "subsystems": dict(st["subsystems"]),
                   "samples": st["samples"], "dropped": st["dropped"]}
            for name, st in self._prof.items()
        }
        local = profiler.snapshot()
        base_stacks = {e["stack"]: e["count"]
                       for e in self._prof0["stacks"]}
        base_subs = self._prof0["subsystems"]
        local_samples = local["samples"] - self._prof0["samples"]
        if local_samples > 0:
            stacks = {}
            for e in local["stacks"]:
                d = e["count"] - base_stacks.get(e["stack"], 0)
                if d > 0:
                    stacks[e["stack"]] = {"subsystem": e["subsystem"],
                                          "count": float(d)}
            merged["coordinator"] = {
                "stacks": stacks,
                "subsystems": {
                    k: float(v - base_subs.get(k, 0))
                    for k, v in local["subsystems"].items()
                    if v - base_subs.get(k, 0) > 0},
                "samples": float(local_samples),
                "dropped": float(max(0, local["dropped"]
                                     - self._prof0["dropped"])),
            }
        nodes = {}
        fleet_stacks: Dict[str, dict] = {}
        fleet_subs: Dict[str, float] = {}
        total = dropped = 0.0
        for name, st in merged.items():
            nodes[name] = {
                "samples": int(st["samples"]),
                "dropped": int(st["dropped"]),
                "subsystems": {k: int(v)
                               for k, v in st["subsystems"].items()
                               if v > 0},
                "top": top(st["stacks"], top_n),
            }
            for stack, m in st["stacks"].items():
                f = fleet_stacks.setdefault(
                    stack, {"subsystem": m["subsystem"], "count": 0.0})
                f["count"] += m["count"]
            for sub, v in st["subsystems"].items():
                fleet_subs[sub] = fleet_subs.get(sub, 0.0) + v
            total += st["samples"]
            dropped += st["dropped"]
        return {
            "nodes": nodes,
            "fleet": {
                "samples": int(total),
                "dropped": int(dropped),
                "subsystems": {k: int(v) for k, v in fleet_subs.items()
                               if v > 0},
                "top": top(fleet_stacks, top_n),
            },
        }

    # -- HTTP scrape path (process-mode fleets) ------------------------------

    def _scrape_entry(self, name: str, node) -> dict:
        """One node's round entry, from its /metrics endpoint.  A down
        or unreachable node yields ``stale: true`` — never an
        exception, never a hang past the per-node budget."""
        if node.down:
            return {"goodput_bps": 0.0, "down": True, "stale": True}
        last: Optional[ScrapeError] = None
        for _attempt in range(2):  # one retry, same budget each
            try:
                rtt_t0 = time.monotonic()
                s = scrape_metric_server(node.metrics_port,
                                         self.scrape_timeout_s)
                scrape_rtt_s = time.monotonic() - rtt_t0
                break
            except ScrapeError as e:
                last = e
        else:
            counters.inc("fleet.scrape.stale")
            log.warning("node %s metrics scrape degraded to stale: %s",
                        name, last)
            return {"goodput_bps": 0.0, "down": False, "stale": True}
        # Fleet ratio inputs are cumulative worker counters; fold them
        # into the restart-aware totals while the scrape is fresh,
        # keyed by the worker's incarnation (the coordinator-side
        # spawn count) so a respawn is detected even when the new
        # process has already climbed past the dead one's last value.
        gen = getattr(getattr(node, "daemon", None), "generation", None)
        self._accumulate(name, "deduped",
                         s.value("agent_events",
                                 event="dcn.frames.deduped"), gen=gen)
        self._accumulate(name, "frames",
                         s.value("agent_events",
                                 event="xferd.frames.landed"), gen=gen)
        entry = {
            "goodput_bps": round(
                s.value("agent_goodput", scope="node", name=name), 1),
            "down": False,
            "stale": False,
            # Scrape round-trip time doubles as grey-failure evidence:
            # a worker whose GIL a CPU burn is holding answers its
            # /metrics GET late, and only THAT worker does.
            "scrape_rtt_s": round(scrape_rtt_s, 4),
            "spans_stale": not self._scrape_node_spans(name, node),
            "profile_stale": not self._scrape_node_profile(name, node),
            "active_flows": int(s.value("agent_gauge",
                                        name="xferd.active_flows")),
            "transferred": int(s.value("agent_gauge",
                                       name="xferd.total_transferred")),
        }
        if self.anomaly.enabled:
            self._anom_fold_node(name, s, gen)
        # Per-node lane evidence (the memcpy-speed same-host plane):
        # a worker whose shm_direct total grows while its socket
        # total stays flat is provably skipping the peer TCP stream.
        lanes = {
            lane: int(s.value("agent_gauge",
                              name=f"dcn.lane.{lane}.total_bytes"))
            for lane in ("shm_direct", "shm", "socket")
        }
        if any(lanes.values()):
            entry["lanes_total_bytes"] = lanes
        return entry

    def _accumulate(self, node: str, key: str, current: float,
                    gen: Optional[int] = None) -> None:
        st = self._accum.setdefault(node, {})
        last = st.get("_last_" + key, 0.0)
        if gen is not None and gen != st.get("_gen_" + key):
            # A new worker incarnation: its counters started at zero,
            # so everything it shows is new increment — even when it
            # has already climbed PAST the dead incarnation's last
            # scraped value (the decrease heuristic alone misses that).
            delta = current
        elif gen is not None and current < last:
            # Same incarnation but the counter went DOWN: a worker
            # cannot decrement its own cumulative counters and the
            # supervisor bumps the generation on every respawn, so
            # this can only be a misread (e.g. the scrape raced the
            # exporter's periodic registry reset).  Folding it in
            # would double-count the pre-reset total on the next
            # scrape — drop the sample and keep the last-known state,
            # but RECORD the event: the soak monotonicity sentinel
            # treats a same-generation decrease as a verdict input.
            self.misreads.append({
                "node": node, "key": key,
                "last": last, "current": current, "gen": gen,
            })
            return
        elif current < last:
            # No incarnation evidence but the counter went DOWN:
            # still unmistakably a fresh process.
            delta = current
        else:
            delta = current - last
        st[key] = st.get(key, 0.0) + delta
        st["_last_" + key] = current
        if gen is not None:
            st["_gen_" + key] = gen

    def _accum_total(self, key: str) -> float:
        return sum(st.get(key, 0.0) for st in self._accum.values())

    # -- SLO evaluation ------------------------------------------------------

    def _histo_p99_ms(self, op: str, baseline: Dict[str, int]) -> float:
        """p99 of THIS run's observations of ``op``: current buckets
        minus the boot baseline (histo.delta_percentile_us)."""
        p_us = histo.delta_percentile_us(op, baseline, 0.99)
        return 0.0 if p_us is None else p_us / 1e3

    def _leg_p99_ms(self) -> float:
        return self._histo_p99_ms(LEG_OP, self._leg0)

    def _exposed_comm_ratio(self) -> float:
        """THIS run's exposed-communication ratio: the dcn.exposed /
        dcn.comm histogram-sum deltas since boot.  0.0 when the run
        moved no pipelined bytes (nothing to judge)."""
        snap = histo.snapshot()
        exp = snap.get("dcn.exposed", {}).get("sum_us", 0.0) \
            - self._exposed_sum0
        comm = snap.get("dcn.comm", {}).get("sum_us", 0.0) \
            - self._comm_sum0
        if comm <= 0:
            return 0.0
        return max(0.0, exp) / comm

    def _final_round_goodput(self) -> float:
        """Goodput of the last sampled round with any live (non-stale)
        node entry — the post-heal recovery floor's input.  Rounds
        where every node was stale are walked past (a node mid-respawn
        at the final sample must not zero the verdict); no history at
        all measures 0.0."""
        for sample in reversed(self.history):
            live = [e["goodput_bps"] for e in sample["nodes"].values()
                    if not e.get("stale")]
            if live:
                return sum(live)
        return 0.0

    def _collective_measurements(self) -> dict:
        """The collective busbw SLO inputs, from the controller-fed
        round history.  Only completed (ok) rounds carry bandwidth; a
        run with no collective rounds measures 0.0 — vacuous only if
        no busbw SLO was configured, honestly breached otherwise (a
        floor on a workload that never ran must fail, not pass)."""
        done = [r.get("busbw_bps", 0.0)
                for r in self.collective_rounds if r.get("ok")]
        routed = [r["routed"] for r in self.collective_rounds
                  if r.get("ok") and r.get("routed")]
        return {
            "min_busbw_bps": (sum(done) / len(done)) if done else 0.0,
            "min_final_busbw_bps": done[-1] if done else 0.0,
            # No routed rounds: the floor honestly breaches (a
            # forwarding proof on a workload that never forwarded must
            # fail), the ceiling is vacuously inside 0.
            "min_forward_bytes": float(sum(
                r.get("forward_bytes", 0) for r in routed)),
            "max_coordinator_leg_bytes": float(sum(
                r.get("coordinator_payload_bytes", 0)
                for r in routed)),
        }

    def _serving_measurements(self, elapsed_s: float) -> dict:
        """The serving SLO inputs — coordinator-side in BOTH modes:
        the ServingFrontend runs in the controller process, so its
        counters and the e2e histogram never need the scrape path."""
        ok = counters.get("serving.ok") - self._serving0["serving.ok"]
        errors = (counters.get("serving.errors")
                  - self._serving0["serving.errors"])
        return {
            "p99_e2e_ms": self._histo_p99_ms(E2E_OP, self._e2e0),
            "min_qps": ok / elapsed_s,
            "max_error_ratio": errors / max(1, ok + errors),
        }

    def _measurements(self, links_report: Dict[str, dict]) -> dict:
        elapsed_s = max(time.monotonic() - self._t0, 1e-9)
        delivered_bytes = sum(l["bytes"] for l in links_report.values())
        frames = sum(l["frames"] for l in links_report.values())
        drops = sum(l["drops"] for l in links_report.values())
        dups = sum(l["dups"] for l in links_report.values())
        return {
            "elapsed_s": round(elapsed_s, 3),
            "p99_leg_ms": self._leg_p99_ms(),
            "min_goodput_bps": delivered_bytes / elapsed_s,
            "max_retransmit_ratio": (drops + dups) / max(1, frames),
            "max_dedup_ratio": dups / max(1, frames),
            "max_exposed_comm_ratio": self._exposed_comm_ratio(),
            "min_final_goodput_bps": self._final_round_goodput(),
            "max_grey_detection_windows":
                self._grey_detection_windows(),
            **self._collective_measurements(),
            **self._serving_measurements(elapsed_s),
        }

    def _measurements_scraped(self) -> dict:
        """Scrape-mode measurements, from the HTTP history.  Stale
        windows are SKIPPED, not zeroed: a round where a node was down
        must not be averaged in as zero goodput — the kill is the
        scenario's point, and the floor judges the fleet while it was
        observable.  Node entries that were stale are excluded from
        their round's sum; rounds with no live entry at all are
        dropped outright."""
        elapsed_s = max(time.monotonic() - self._t0, 1e-9)
        round_sums = []
        stale_entries = 0
        for sample in self.history:
            live = [e["goodput_bps"] for e in sample["nodes"].values()
                    if not e.get("stale")]
            stale_entries += sum(1 for e in sample["nodes"].values()
                                 if e.get("stale"))
            if live:
                round_sums.append(sum(live))
        goodput = (sum(round_sums) / len(round_sums)
                   if round_sums else 0.0)
        # No link fabric between processes: drops are invisible here,
        # so both ratio caps judge the receiver-side dedup evidence
        # (replays that actually re-landed) over frames that landed.
        deduped = self._accum_total("deduped")
        frames = self._accum_total("frames")
        ratio = deduped / max(1.0, frames)
        return {
            "elapsed_s": round(elapsed_s, 3),
            "p99_leg_ms": self._leg_p99_ms(),
            "min_goodput_bps": goodput,
            "max_retransmit_ratio": ratio,
            "max_dedup_ratio": ratio,
            "max_exposed_comm_ratio": self._exposed_comm_ratio(),
            "min_final_goodput_bps": self._final_round_goodput(),
            "max_grey_detection_windows":
                self._grey_detection_windows(),
            "stale_entries_skipped": stale_entries,
            **self._collective_measurements(),
            **self._serving_measurements(elapsed_s),
        }

    def evaluate(self, links_report: Dict[str, dict]) -> dict:
        """The report's ``slo`` section: every configured check with
        its measured value, the limit, and pass/fail; ``ok`` is the
        conjunction (vacuously true with no SLOs configured).  Each
        verdict is also published as ``slo.<key>.ok`` /
        ``slo.<key>.value`` gauges for the live scrape surface."""
        measured = (self._measurements_scraped() if self.scrape
                    else self._measurements(links_report))
        checks = []
        for key, limit in self.slo.items():
            kind, what = SLO_KEYS[key]
            value = measured[key]
            source = "pinned"
            learned = self.learned_slo.get(key)
            if learned and learned.get("source") == "learned":
                # Tighten-only: a ceiling may come DOWN toward the
                # fleet's demonstrated baseline, a floor may come UP
                # — neither ever relaxes past the scenario's pinned
                # limit (the hard bound the learner cannot cross).
                lv = float(learned["limit"])
                tightened = (min(limit, lv) if kind == "ceiling"
                             else max(limit, lv))
                if tightened != limit:
                    limit = tightened
                    source = "learned"
            ok = value >= limit if kind == "floor" else value <= limit
            check = {
                "slo": key, "kind": kind, "what": what,
                "limit": limit, "value": round(value, 3),
                "ok": bool(ok),
            }
            if source == "learned":
                check["limit_source"] = "learned"
                check["pinned_limit"] = self.slo[key]
                check["history_n"] = learned.get("n")
            checks.append(check)
            timeseries.gauge(f"slo.{key}.ok", 1.0 if ok else 0.0)
            timeseries.gauge(f"slo.{key}.value", value)
        ok = all(c["ok"] for c in checks)
        if checks and not ok:
            breached = [c["slo"] for c in checks if not c["ok"]]
            log.warning("SLO breach: %s", ", ".join(breached))
        return {
            "spec": dict(self.slo),
            "measured": {k: round(v, 3) for k, v in measured.items()},
            "checks": checks,
            "ok": ok,
        }
