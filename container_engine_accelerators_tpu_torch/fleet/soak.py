"""Continuous soak world: composed workloads, seeded chaos, invariant
sentinels.

The port's copy of ``container_engine_accelerators_tpu/fleet/soak.py``
(host code: no torch): the same schedule, sentinels, verdicts and
report keys, over the port's GPU fleet (``fleet/controller.py``).

Every fleet gate so far is an *episode*: one workload, a handful of
rounds, a scripted fault, a verdict.  Episodes are how you prove a
mechanism; they are structurally blind to the failures that define
node infrastructure in production — the fd that leaks one per respawn,
the counter that quietly regresses across a worker generation, the
AIMD controller that never settles after the fifth heal.  This module
is the repo's long-horizon gate (ROADMAP "one continuous soak world"),
and the standing evidence behind the ``TPU_DCN_TUNE`` default flip:
the closed loop ships ON because this world proves, on every
presubmit, that it converges and never limit-cycles under sustained
mixed load.

The composition model (one proc-mode fleet, everything at once):

- **serving** — a ServingFrontend spraying batched/hedged requests
  (its own client pool, per-node breakers);
- **collective** — the topology-aware engine synthesizing and
  executing schedules against the live comm graph (its own pool);
- **pipelined exchange** — the classic ring legs on each node's
  control client, chunked/striped through the same daemons;

all three run CONCURRENTLY each window (safe by construction: the
frontend and the engine own their pooled clients, the exchange thread
is the only user of ``node.client``), with the per-destination tuner
(parallel/dcn_tune.py) and the continuous profiler on — the exact
contention mix an episodic gate can never produce.

Faults come from a **seeded, reproducible schedule**
(:class:`SoakSchedule`): a pure function of ``(seed, window)``, so the
same seed replays the same chaos byte-for-byte — the property that
turns "it failed at 3am after six hours" into a one-line repro.  The
grammar is the scenario fault grammar (kill/restart, link
latency/drop/partition with ``for:`` lifetimes) plus one new literal:

    {"grey": "<node>", "for": K}

a **grey failure** — slow, not dead: the node's links to every peer
(both directions) get shim latency and the worker spins a CPU-burn
thread, but nothing crashes, no port changes, no health check fires.
Grey nodes are the classic blind spot of crash-detector-shaped
chaos, and the tuner/SLO machinery has to ride them out.

The verdict layer is the point: **invariant sentinels** judged over
the whole run, not per round —

- :class:`MonotonicitySentinel` — cumulative worker counters may
  never decrease within one worker generation (respawns are
  generation-aware, riding telemetry's ``_accumulate`` misread log);
- :class:`LeakSentinel` — per-window resource censuses (fds,
  threads, shm segments, rss via the workers' ``resources`` RPC) are
  fitted with a least-squares slope per generation segment, after a
  short per-generation warm-up allowance (a freshly respawned
  worker's boot ramp is not a leak); a slope past its per-window
  budget is a leak, whatever its wobble;
- :func:`judge_tuner_convergence` — after the last heal (plus a
  settle allowance) the tuner's reactive move rate must decay to
  zero; a grid still being corrected every window is a limit cycle;
- the windowed SLO verdict — the same telemetry SLO table, evaluated
  over the full soak history.

Exit contract (``python -m container_engine_accelerators_tpu_torch.cmd.
fleet_soak``): 0 clean, 2 non-convergence, 3 invariant-or-SLO breach.
"""

import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.fleet.controller import (
    FleetController,
)
from container_engine_accelerators_tpu_torch.fleet.telemetry import (
    SLO_KEYS,
    parse_slo_spec,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import (
    history,
    timeseries,
    trace,
)
from container_engine_accelerators_tpu_torch.parallel import dcn_tune
from container_engine_accelerators_tpu_torch.serving.frontend import (
    ServingConfig,
    ServingFrontend,
)

log = logging.getLogger(__name__)

# Grey-failure shim latency, per frame, both directions: well under
# the 0.25 s shim cap, well over loopback RTT — slow enough to stretch
# every leg through the grey node, never enough to trip a timeout by
# itself.
GREY_LATENCY_S = 0.05

# Slow-ring-completer grey fault, per posted descriptor: the ring
# completer sleeps this long before driving each descriptor — a round
# crawls (the cursor keeps advancing) without ever tripping the 5 s
# stage-wait budget, which is exactly the slow-not-dead shape the
# sentinels must catch without a transfer wedging.
RING_DELAY_S = 0.08

# Slow-shm-commit grey fault, per staged frame: every shm commit pays
# this before landing — a throttled staging memcpy on the zero-copy
# lane.  Commits still land and account, so only the xferd.shm.commit
# latency histogram (and the anomaly detector reading it) sees it.
SHM_DELAY_S = 0.06

# The deterministic coverage prologue: window 1 SIGKILL (+respawn),
# window 2 grey (+ungrey), window 3 link degrade (+heal), window 4
# slow ring completer (+unslow), and — on shm-lane scenarios — window
# 5 slow shm commit (+unslow) — every soak run exercises every fault
# family and its heal even at the shortest CI duration; later windows
# draw from the seeded RNG.
LAST_DETERMINISTIC_WINDOW = 4

# Post-fault settle allowance, in windows, the closed-loop detection
# judge grants after every scheduled fault's lifetime before a flag on
# that window counts as a false positive: the anomaly EWMA decays over
# several windows by design (hysteresis is the anti-flap contract —
# from the score cap it takes ~4 windows to fall under clear_z plus
# clear_windows more to step down), and the goodput rate windows smear
# the evidence one further — decay after chaos is the detector
# working, not a false alarm.
ANOMALY_SETTLE_WINDOWS = 5

# Tuner decisions that count as REACTIVE moves for the convergence
# sentinel: the loss-response axis (and its recovery).  Exploration
# probes (grow/narrow/keep/revert) are the controller's steady-state
# behavior on a clean link and judging them would fail every healthy
# run.
REACTIVE_DECISIONS = ("shrink_chunk", "backoff_stripe", "grow_chunk")

# Leak-slope budgets, per metric per window — deliberately generous:
# a clean run must never flake on scheduling noise, and the planted
# tests use slopes an order of magnitude past these.
DEFAULT_LEAK_LIMITS = {
    "fds": 2.0,
    "threads": 1.5,
    "shm_segments": 1.5,
    "rss_bytes": float(8 << 20),
}

DEFAULT_SOAK_SCENARIO = {
    "name": "soak",
    "workload": "soak",
    "proc": True,
    "pipelined": True,
    "tuned": True,
    # Socket lane pinned on BOTH tiers: the link shim (grey latency,
    # scheduled drops) interposes on the TCP send path, so the soak's
    # chaos must not be bypassed by the same-host segment lanes.
    "shm": False,
    "shm_direct": False,
    "nodes": 3,
    "payload_bytes": 32768,
    "chunk_bytes": 8192,
    "stripes": 2,
    # Soak kills repeatedly by design: the restart budget models
    # permanent hardware loss, which is not this world's question.
    "restart_budget": 1000,
    "leg_attempts": 4,
    "serving": {"requests_per_round": 6, "round_deadline_s": 20.0},
    "collective": {"op": "all_reduce", "bytes": 16384},
    "slo": {
        "min_final_goodput_bps": 1024,
        "max_dedup_ratio": 0.9,
    },
}


# ---------------------------------------------------------------------------
# seeded schedule
# ---------------------------------------------------------------------------


class SoakSchedule:
    """The seeded fault schedule: a PURE function of ``(seed,
    window)`` over a fixed node list — no shared RNG state between
    windows, so any window's draw can be recomputed in isolation and
    the whole schedule replays from the seed alone."""

    def __init__(self, seed: int, node_names: List[str],
                 shm: bool = False):
        self.seed = int(seed)
        self.names = list(node_names)
        # shm-lane scenarios (scenario "shm": true) extend the grammar
        # with the slow_shm grey fault: a throttled per-frame commit
        # on the staging lane.  Gated on the flag because a socket-
        # only scenario never commits — the fault would be a no-op and
        # the detection judge would count an undetectable truth.
        self.shm = bool(shm)
        # The last window of the deterministic coverage prologue —
        # shm scenarios add the window-5 slow_shm leg.
        self.last_deterministic = (5 if self.shm
                                   else LAST_DETERMINISTIC_WINDOW)

    def _rng(self, window: int) -> random.Random:
        return random.Random(f"{self.seed}:{window}")

    def faults_for(self, window: int) -> List[dict]:
        """Schedule entries to inject at ``window`` (scenario fault
        grammar plus the ``grey:`` literal).  Window 0 is always a
        clean baseline; windows 1-3 are the deterministic coverage
        prologue; later windows draw probabilistically."""
        if not self.names or window <= 0:
            return []
        rng = self._rng(window)
        if window == 1:
            return [{"action": "kill", "node": rng.choice(self.names),
                     "for": 1}]
        if window == 2:
            return [{"grey": rng.choice(self.names), "for": 1}]
        if window == 3 and len(self.names) > 1:
            a, b = rng.sample(self.names, 2)
            return [{"link": f"node:{a}<->node:{b}:latency:20",
                     "for": 1}]
        if window == 4:
            return [{"slow_ring": rng.choice(self.names), "for": 1}]
        if window == 5 and self.shm:
            return [{"slow_shm": rng.choice(self.names), "for": 1}]
        draws: List[dict] = []
        r = rng.random()
        if r < 0.15:
            draws.append({"action": "kill",
                          "node": rng.choice(self.names), "for": 1})
        elif r < 0.30:
            draws.append({"grey": rng.choice(self.names), "for": 1})
        elif r < 0.50 and len(self.names) > 1:
            a, b = rng.sample(self.names, 2)
            action = rng.choice(["latency:20", "drop:2"])
            draws.append({"link": f"node:{a}<->node:{b}:{action}",
                          "for": rng.randint(1, 2)})
        elif r < 0.60:
            # The ring lane's grey fault: a slow completer on one
            # node's universal ring — every descriptor costs a sleep,
            # no descriptor is lost.
            draws.append({"slow_ring": rng.choice(self.names),
                          "for": 1})
        elif r < 0.65 and self.shm:
            # The staging lane's grey fault: a throttled shm commit —
            # drawn from the band the non-shm grammar leaves clean, so
            # flipping shm on never perturbs an existing seed's other
            # draws.
            draws.append({"slow_shm": rng.choice(self.names),
                          "for": 1})
        return draws


# ---------------------------------------------------------------------------
# sentinels (pure — unit-tested with synthetic inputs)
# ---------------------------------------------------------------------------


class MonotonicitySentinel:
    """Cumulative counters may never decrease within one worker
    generation.  A respawn (generation bump) legitimately restarts a
    counter at zero; a same-generation decrease is a correctness
    violation, full stop — exactly the event telemetry's
    ``_accumulate`` records into its misread log."""

    def __init__(self):
        self.violations: List[dict] = []
        self._last: Dict[Tuple[str, str], Tuple[Optional[int],
                                                float]] = {}

    def observe(self, node: str, key: str, value: float,
                gen: Optional[int] = None) -> None:
        prev = self._last.get((node, key))
        if prev is not None:
            pgen, pval = prev
            if gen == pgen and value < pval:
                self.violations.append({
                    "node": node, "key": key,
                    "last": pval, "current": value, "gen": gen,
                })
        self._last[(node, key)] = (gen, float(value))

    def fold(self, misreads: List[dict]) -> None:
        """Adopt telemetry's ``_accumulate`` misread log — the scrape
        path's same-generation decreases, recorded where they were
        detected."""
        self.violations.extend(dict(m) for m in misreads)

    def report(self) -> dict:
        return {"ok": not self.violations,
                "violations": list(self.violations)}


class LeakSentinel:
    """Per-window resource censuses, judged by fitted slope.  Series
    are segmented by worker generation — a respawn resets fds/threads/
    rss legitimately, and stitching across it would either hide a leak
    or invent one.  Each segment's first ``warmup_samples`` censuses
    are discarded: a freshly (re)spawned worker legitimately ramps
    fds/threads/rss while its stagers and handlers spin up, and that
    boot ramp fitted as a slope reads exactly like a leak.  Only
    segments with ``min_samples`` post-warm-up points judge (two
    points fit any line); the budgets are per window."""

    def __init__(self, limits: Optional[dict] = None,
                 min_samples: int = 4, warmup_samples: int = 2,
                 learned: Optional[Dict[str, dict]] = None):
        self.limits = dict(DEFAULT_LEAK_LIMITS)
        if limits:
            self.limits.update(limits)
        # History-learned slope budgets (obs/history.learned_limit
        # shapes, keyed by metric): a learned limit replaces the
        # pinned one — by construction it can only TIGHTEN it (the
        # learner's hard ceiling is the pinned constant), so a fleet
        # whose demonstrated slopes sit near zero flags a creep the
        # generous pinned budget alone would wave through.
        self.limit_sources: Dict[str, dict] = {}
        for metric, ll in (learned or {}).items():
            if metric in self.limits \
                    and ll.get("source") == "learned":
                self.limits[metric] = min(self.limits[metric],
                                          float(ll["limit"]))
                self.limit_sources[metric] = {
                    "source": "learned", "n": ll.get("n"),
                    "median": ll.get("median"),
                    "pinned": DEFAULT_LEAK_LIMITS.get(metric)}
        self.min_samples = max(2, int(min_samples))
        self.warmup_samples = max(0, int(warmup_samples))
        self._series: Dict[Tuple[str, str, Optional[int]],
                           List[Tuple[int, float]]] = {}
        self._seen: Dict[Tuple[str, str, Optional[int]], int] = {}

    def observe(self, window: int, node: str, resources: dict,
                gen: Optional[int] = None) -> None:
        for metric in self.limits:
            if metric not in resources:
                continue
            key = (node, metric, gen)
            seen = self._seen.get(key, 0)
            self._seen[key] = seen + 1
            if seen < self.warmup_samples:
                continue  # boot ramp, not evidence
            self._series.setdefault(key, []).append(
                (int(window), float(resources[metric])))

    def report(self) -> dict:
        breaches: List[dict] = []
        series: Dict[str, dict] = {}
        # Worst judged slope per metric across every node/generation
        # segment — what the history ledger persists, and what the
        # NEXT run's learned thresholds are fitted over.
        max_slopes: Dict[str, float] = {}
        for (node, metric, gen), pts in sorted(self._series.items(),
                                               key=lambda kv: str(kv[0])):
            slope = timeseries.least_squares_slope(pts)
            limit = self.limits[metric]
            if len(pts) >= self.min_samples:
                max_slopes[metric] = max(
                    max_slopes.get(metric, slope), slope)
            entry = {
                "node": node, "metric": metric, "gen": gen,
                "samples": len(pts),
                "slope_per_window": round(slope, 4),
                "limit_per_window": limit,
            }
            if metric in self.limit_sources:
                entry["limit_source"] = "learned"
            series[f"{node}.{metric}.gen{gen}"] = entry
            if len(pts) >= self.min_samples and slope > limit:
                breaches.append(entry)
        return {"ok": not breaches, "breaches": breaches,
                "series": series,
                "max_slopes": {m: round(s, 4)
                               for m, s in max_slopes.items()},
                "learned_limits": dict(self.limit_sources)}


def judge_tuner_convergence(moves_per_window: List[int],
                            heal_windows: List[int], *,
                            settle_windows: int = 3,
                            max_tail_moves: int = 1) -> dict:
    """The oscillation sentinel: after the LAST heal plus a settle
    allowance, the tuner's reactive move rate must decay — a bounded
    straggler move is tolerated (``max_tail_moves``), but any tail
    window past it, or a tail that never goes quiet at all, is a limit
    cycle.  No heals observed judges nothing (vacuously ok): decay is
    only defined relative to a disturbance."""
    heals = sorted({int(h) for h in heal_windows})
    out = {"ok": True, "heal_windows": heals, "tail_start": None,
           "tail_moves": [], "reason": "no heals observed"}
    if not heals:
        return out
    tail_start = heals[-1] + max(0, int(settle_windows))
    out["tail_start"] = tail_start
    tail = [int(m) for m in moves_per_window[tail_start:]]
    out["tail_moves"] = tail
    if not tail:
        out["reason"] = "run ended inside the settle window"
        return out
    if any(m > max_tail_moves for m in tail):
        out["ok"] = False
        out["reason"] = (
            f"reactive move rate did not decay after the last heal "
            f"(window {heals[-1]}): tail {tail} exceeds "
            f"{max_tail_moves}/window")
        return out
    if len(tail) >= 3 and all(m > 0 for m in tail):
        out["ok"] = False
        out["reason"] = (
            f"limit cycle: every post-settle window kept correcting "
            f"the grid (tail {tail})")
        return out
    out["reason"] = "converged"
    return out


def history_learned_limits(cfg_key: str,
                           slo_spec: Optional[dict] = None,
                           ledger: Optional["history.RunLedger"]
                           = None) -> Tuple[Dict[str, dict],
                                            Dict[str, dict]]:
    """Fit this config's sentinel thresholds from prior soak runs in
    the history ledger (``TPU_HISTORY_DIR``): per-metric leak-slope
    budgets from the runs' recorded ``max_slopes`` and per-key SLO
    limits from their measured values — each ``median + k·MAD``
    (floors mirrored), pinned-constant fallback when history is
    thinner than ``MIN_BASELINE_RUNS``, and the pinned constant as
    the hard bound the learned value can never relax past.  No
    ledger, an unreadable one, or thin history all degrade to empty
    mappings: the pinned constants judge alone, exactly as before
    this layer existed."""
    ledger = history.RunLedger() if ledger is None else ledger
    leak: Dict[str, dict] = {}
    slo: Dict[str, dict] = {}
    if not ledger.enabled:
        return leak, slo
    try:
        prior = ledger.records(kind="fleet_soak", cfg_key=cfg_key)
    except history.LedgerError as e:
        log.error("history ledger unreadable (%s); soak thresholds "
                  "stay pinned", e)
        return leak, slo
    for metric, pinned in DEFAULT_LEAK_LIMITS.items():
        slopes = [
            float(r["sentinels"]["leak_slopes"][metric])
            for r in prior
            if isinstance((r.get("sentinels") or {})
                          .get("leak_slopes"), dict)
            and metric in r["sentinels"]["leak_slopes"]
        ][-history.BASELINE_N:]
        ll = history.learned_limit(slopes, pinned)
        if ll["source"] == "learned":
            leak[metric] = ll
    for key, pinned in parse_slo_spec(slo_spec).items():
        kind = SLO_KEYS[key][0]
        values = [
            float(r["slo"]["measured"][key]) for r in prior
            if isinstance((r.get("slo") or {}).get("measured"), dict)
            and key in r["slo"]["measured"]
        ][-history.BASELINE_N:]
        ll = history.learned_limit(values, pinned, kind=kind)
        if ll["source"] == "learned":
            slo[key] = ll
    return leak, slo


def exit_code_for(report: dict) -> int:
    """The soak exit contract: 0 clean, 2 non-convergence, 3
    invariant-or-SLO breach — shared by the CLI and the planted-fault
    tests so the verdict→exit mapping is pinned in one place."""
    if not report.get("converged"):
        return 2
    sentinels = (report.get("soak") or {}).get("sentinels") or {}
    slo = report.get("slo") or {}
    if not sentinels.get("ok", True) or not slo.get("ok", True):
        return 3
    return 0


# ---------------------------------------------------------------------------
# the soak world
# ---------------------------------------------------------------------------


class SoakWorld(FleetController):
    """A FleetController whose run is wall-clock-bounded and whose
    three workloads run concurrently each window, with the seeded
    schedule injecting faults and the sentinel layer judging the whole
    run.  Everything episodic is inherited: fault application,
    deferred ``for:`` inverses, leg mechanics, telemetry, the
    convergence report."""

    def __init__(self, scenario: Optional[dict] = None,
                 workdir: Optional[str] = None, *,
                 duration_s: Optional[float] = None,
                 window_s: Optional[float] = None,
                 seed: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        merged = dict(DEFAULT_SOAK_SCENARIO)
        if scenario:
            merged.update(scenario)
        merged["workload"] = "soak"  # neither serving nor collective:
        # the base boot() must not claim either — this world composes
        # both itself, on top of the ring substrate.
        super().__init__(merged, workdir=workdir)
        self.duration_s = float(
            duration_s if duration_s is not None
            else merged.get("duration_s", 45.0))
        self.window_s = float(
            window_s if window_s is not None
            else merged.get("window_s", 2.0))
        self.seed = int(seed if seed is not None
                        else merged.get("seed", 1234))
        # The quiet tail: no NEW faults inside the final cooldown
        # (pending heals still fire), so convergence and the tuner
        # sentinel always get an undisturbed run-out.
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else merged.get("cooldown_s", 3 * self.window_s))
        self.min_windows = int(merged.get("min_windows", 6))
        self.settle_windows = int(merged.get("settle_windows", 3))
        self.max_tail_moves = int(merged.get("max_tail_moves", 1))
        self.grey_latency_s = float(
            merged.get("grey_latency_s", GREY_LATENCY_S))
        self.ring_delay_s = float(
            merged.get("ring_delay_s", RING_DELAY_S))
        self.shm_delay_s = float(
            merged.get("shm_delay_s", SHM_DELAY_S))
        self.schedule = SoakSchedule(
            self.seed, [s.name for s in self.topology.specs.values()],
            shm=bool(merged.get("shm")))
        self.mono = MonotonicitySentinel()
        # History-learned thresholds: prior soak runs of this SAME
        # config (ledger under TPU_HISTORY_DIR) tighten the leak
        # budgets and SLO limits toward the fleet's demonstrated
        # baseline — pinned constants stay the fallback AND the hard
        # bound, so no history and thin history behave exactly as
        # before this layer existed.
        self.history_key = history.config_key(
            "soak", merged.get("name", "soak"),
            f"n{merged.get('nodes')}")
        self._learned_leak, self._learned_slo = \
            history_learned_limits(self.history_key,
                                   merged.get("slo"))
        self.leak = LeakSentinel(merged.get("leak_limits"),
                                 learned=self._learned_leak)
        self._moves_per_window: List[int] = []
        self._last_moves = 0
        self._heal_windows: set = set()
        self._schedule_log: List[dict] = []
        self._kills = 0
        self._greys = 0
        self._heals = 0

    # -- lifecycle -----------------------------------------------------------

    def boot(self) -> "SoakWorld":
        if self._booted:
            return self
        super().boot()
        # The SLO sentinel judges with the history-learned limits
        # (tighten-only; telemetry clamps them to the pinned spec).
        self.telemetry.learned_slo.update(self._learned_slo)
        # Compose ALL the workloads on the booted substrate.  The
        # frontend and the engine keep their own pooled clients, so
        # they are safe to drive concurrently with the exchange legs
        # (the only user of node.client); close() tears both down.
        try:
            self.frontend = ServingFrontend(
                self.nodes,
                ServingConfig.from_scenario(
                    self.scenario.get("serving")),
            ).start()
            from container_engine_accelerators_tpu_torch.collectives.runner \
                import CollectiveConfig, CollectiveEngine

            self.collective = CollectiveEngine(
                self.nodes, self.topology, links=self.links,
                cfg=CollectiveConfig.from_scenario(
                    self.scenario.get("collective")),
                pipe_cfg=self.pipe_cfg if self.pipelined else None,
            )
        except Exception:
            self.close()  # no orphan workers behind a half boot
            raise
        return self

    # -- grey faults ---------------------------------------------------------

    def _apply_fault(self, rnd: int, entry: dict) -> dict:
        if "grey" in entry or "ungrey" in entry:
            return self._apply_grey(rnd, entry)
        if "slow_ring" in entry or "unslow_ring" in entry:
            return self._apply_slow_ring(rnd, entry)
        if "slow_shm" in entry or "unslow_shm" in entry:
            return self._apply_slow_shm(rnd, entry)
        return super()._apply_fault(rnd, entry)

    def _apply_slow_shm(self, rnd: int, entry: dict) -> dict:
        """Arm (or heal) the staging lane's grey fault: every shm
        commit on the node pays a per-frame throttle before landing —
        a slow memcpy, not a slow completer.  Commits still land and
        account, so nothing but the xferd.shm.commit latency histogram
        (the anomaly detector's attribution stream) carries the
        evidence."""
        healing = "unslow_shm" in entry
        name = entry["unslow_shm"] if healing else entry["slow_shm"]
        record = dict(entry)
        record["round"] = rnd
        record["applied"] = 0
        node = self.nodes.get(name)
        if node is None:
            log.error("slow_shm fault names unknown node: %r", entry)
            record["skipped"] = f"unknown node {name!r}"
            return record
        try:
            node.shm_delay(0.0 if healing else self.shm_delay_s)
            record["applied"] = 1
        except (OSError, AttributeError) as e:
            record["skipped"] = f"shm_delay {name}: {e}"
        if not healing and record["applied"]:
            counters.inc("soak.fault.slow_shm")
            lifetime = int(entry.get("for", 0))
            if lifetime > 0:
                self._deferred.setdefault(rnd + lifetime, []).append(
                    {"unslow_shm": name})
        return record

    def _apply_slow_ring(self, rnd: int, entry: dict) -> dict:
        """Arm (or heal) the ring lane's grey fault: the node's ring
        completer sleeps per posted descriptor — rounds crawl with a
        visibly advancing cursor, no descriptor is dropped, no
        stage-wait budget trips.  The sentinels (latency histograms,
        exposed-comm ratio, SLO round deadlines) must catch the
        degradation without any transfer wedging."""
        healing = "unslow_ring" in entry
        name = entry["unslow_ring"] if healing else entry["slow_ring"]
        record = dict(entry)
        record["round"] = rnd
        record["applied"] = 0
        node = self.nodes.get(name)
        if node is None:
            log.error("slow_ring fault names unknown node: %r", entry)
            record["skipped"] = f"unknown node {name!r}"
            return record
        try:
            node.ring_delay(0.0 if healing else self.ring_delay_s)
            record["applied"] = 1
        except (OSError, AttributeError) as e:
            record["skipped"] = f"ring_delay {name}: {e}"
        if not healing and record["applied"]:
            counters.inc("soak.fault.slow_ring")
            lifetime = int(entry.get("for", 0))
            if lifetime > 0:
                self._deferred.setdefault(rnd + lifetime, []).append(
                    {"unslow_ring": name})
        return record

    def _apply_grey(self, rnd: int, entry: dict) -> dict:
        """Arm (or heal) a grey failure: shim latency on every link
        touching the node, both directions, plus a worker-side CPU
        burn — slow, not dead.  A dark node degrades the record, never
        the schedule (the standard fault rule)."""
        healing = "ungrey" in entry
        name = entry["ungrey"] if healing else entry["grey"]
        record = dict(entry)
        record["round"] = rnd
        record["applied"] = 0
        node = self.nodes.get(name)
        if node is None:
            log.error("grey fault names unknown node: %r", entry)
            record["skipped"] = f"unknown node {name!r}"
            return record
        action = "heal" if healing else "latency"
        param = 0.0 if healing else self.grey_latency_s
        applied = 0
        errs = []
        for peer in self.nodes.values():
            if peer.name == name:
                continue
            for src, dst in ((node, peer), (peer, node)):
                try:
                    applied += src.apply_link_fault(
                        dst.daemon.data_port, action, param)
                except (OSError, AttributeError) as e:
                    errs.append(f"{src.name}->{dst.name}: {e}")
        try:
            if healing:
                node.stop_burn()
            else:
                lifetime = max(1, int(entry.get("for", 1)))
                node.burn_cpu(lifetime * self.window_s * 2.0)
        except (OSError, AttributeError) as e:
            errs.append(f"burn {name}: {e}")
        record["applied"] = applied
        if errs:
            record["skipped"] = "; ".join(errs)
        if not healing:
            counters.inc("soak.fault.grey")
            lifetime = int(entry.get("for", 0))
            if lifetime > 0:
                self._deferred.setdefault(rnd + lifetime, []).append(
                    {"ungrey": name})
        return record

    @staticmethod
    def _is_heal(record: dict) -> bool:
        if record.get("skipped") and not record.get("applied"):
            return False
        if "ungrey" in record or "unslow_ring" in record \
                or "unslow_shm" in record:
            return True
        if record.get("action") == "restart":
            return True
        link = record.get("link")
        return bool(link) and ":heal" in str(link)

    # -- the windowed run ----------------------------------------------------

    def run(self) -> dict:
        self.boot()
        per_node_ok: Dict[str, int] = {n: 0 for n in self.nodes}
        per_node_failed: Dict[str, int] = {n: 0 for n in self.nodes}
        round_log: List[dict] = []
        start = time.monotonic()
        deadline = start + self.duration_s
        w = 0
        with trace.span("fleet.scenario",
                        scenario=self.scenario.get("name", "soak"),
                        nodes=len(self.nodes), rounds=0):
            while w < self.min_windows \
                    or time.monotonic() < deadline:
                t0 = time.monotonic()
                fired = []
                for entry in self._deferred.pop(w, []):
                    rec = self._apply_fault(w, entry)
                    fired.append(rec)
                    if self._is_heal(rec):
                        self._heal_windows.add(w)
                        self._heals += 1
                        counters.inc("soak.fault.heal")
                # The quiet tail: inside the final cooldown no NEW
                # fault is drawn — the deterministic prologue is
                # exempt so even the shortest run keeps its coverage
                # guarantee (its heals land by window 4, well before
                # any sane cooldown).
                injecting = (w <= getattr(self.schedule,
                                          "last_deterministic",
                                          LAST_DETERMINISTIC_WINDOW)
                             or (deadline - time.monotonic())
                             > self.cooldown_s)
                if injecting:
                    for entry in self.schedule.faults_for(w):
                        rec = self._apply_fault(w, entry)
                        fired.append(rec)
                        self._schedule_log.append(
                            {"window": w,
                             **{k: v for k, v in rec.items()
                                if k != "round"}})
                        if rec.get("action") == "kill" \
                                and rec.get("applied"):
                            self._kills += 1
                        if "grey" in rec and rec.get("applied"):
                            self._greys += 1
                        self._record_truth(w, rec)
                legs = self._window_workloads(w, per_node_ok,
                                              per_node_failed)
                for node in self.nodes.values():
                    node.recover()
                self.telemetry.sample_round(w)
                self._sample_resources(w)
                moves = self._reactive_moves()
                self._moves_per_window.append(
                    max(0, moves - self._last_moves))
                self._last_moves = moves
                counters.inc("soak.windows")
                round_log.append(
                    {"round": w, "faults": fired, "legs": legs})
                # Pace to the window cadence (never past the
                # deadline): the leak series' x axis is the window
                # index, so windows should tick at comparable
                # wall-clock spacing.
                pace = self.window_s - (time.monotonic() - t0)
                if w + 1 >= self.min_windows:
                    pace = min(pace, deadline - time.monotonic())
                if pace > 0:
                    time.sleep(pace)
                w += 1
        return self._soak_report(round_log, per_node_ok,
                                 per_node_failed, windows=w,
                                 start=start)

    def _window_workloads(self, w: int,
                          per_node_ok: Dict[str, int],
                          per_node_failed: Dict[str, int]) -> list:
        """One window's composed traffic: serving + collective +
        pipelined exchange, concurrently.  Each thread folds into its
        OWN per-node dicts (merged after the join) and appends its leg
        entries under the lock — the inherited round helpers are
        single-thread code and stay that way."""
        legs: List[dict] = []
        folds: List[Tuple[Dict[str, int], Dict[str, int]]] = []
        lock = threading.Lock()

        def _serving(ok, failed):
            return [self._serving_round(w, ok, failed)]

        def _collective(ok, failed):
            return [self._collective_round(w, ok, failed)]

        def _exchange(ok, failed):
            out = []
            for src, dst in self._ring():
                if src.down or dst.down:
                    out.append({"src": src.name, "dst": dst.name,
                                "skipped": "node down"})
                    continue
                leg = self._leg(w, src, dst)
                out.append(leg)
                if leg["ok"]:
                    ok[src.name] += 1
                else:
                    failed[src.name] += 1
            return out

        def _drive(kind, fn):
            ok = {n: 0 for n in self.nodes}
            failed = {n: 0 for n in self.nodes}
            try:
                entries = fn(ok, failed)
            except Exception as e:  # noqa: BLE001 — a workload crash
                # is a failed window entry, never a wedged soak
                log.error("soak %s workload failed in window %d: %s",
                          kind, w, e)
                entries = [{"workload": kind, "ok": False,
                            "error": str(e)}]
            with lock:
                legs.extend(entries)
                folds.append((ok, failed))

        threads = [
            # daemon=True: joined before this window returns; the flag
            # only matters if a workload wedges, and then it must not
            # pin interpreter shutdown.
            threading.Thread(target=_drive, args=(kind, fn),
                             name=f"soak-{kind}", daemon=True)
            for kind, fn in (("serving", _serving),
                             ("collective", _collective),
                             ("exchange", _exchange))
        ]
        with trace.span("fleet.round", round=w):
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for ok, failed in folds:
            for n, v in ok.items():
                per_node_ok[n] += v
            for n, v in failed.items():
                per_node_failed[n] += v
        return legs

    # -- sentinel feeds ------------------------------------------------------

    def _record_truth(self, w: int, rec: dict) -> None:
        """Feed the anomaly detector's closed-loop judge DURING the
        run (telemetry.evaluate runs inside _report, before the soak
        section exists): every APPLIED grey-family fault becomes a
        ground-truth entry the detection recall is judged over, and
        every scheduled fault of ANY kind marks its window footprint
        (lifetime + the hysteresis settle allowance) so decay after
        chaos never counts as a false positive."""
        if not rec.get("applied"):
            return
        lifetime = max(1, int(rec.get("for", 1)))
        for wx in range(w, w + lifetime + ANOMALY_SETTLE_WINDOWS + 1):
            self.telemetry.anomaly_chaos.add(wx)
        for kind in ("grey", "slow_ring", "slow_shm"):
            if kind in rec:
                self.telemetry.anomaly_truth.append(
                    {"node": rec[kind], "window": w,
                     "lifetime": lifetime, "kind": kind})
                return

    def _sample_resources(self, w: int) -> None:
        """One resource census per live node per window — the leak
        sentinel's series.  A dark worker contributes NOTHING (no
        cached fallback: a stale census fakes a flat series), counted
        so the report can say how observable the run actually was."""
        for name, node in self.nodes.items():
            if getattr(node, "down", False):
                counters.inc("soak.resources.stale")
                continue
            try:
                res = node.resources()
            except (OSError, AttributeError):
                counters.inc("soak.resources.stale")
                continue
            gen = getattr(getattr(node, "daemon", None),
                          "generation", None)
            self.leak.observe(w, name, res, gen)

    def _reactive_moves(self) -> int:
        return sum(counters.get(f"dcn.tune.{d}")
                   for d in REACTIVE_DECISIONS)

    # -- verdict -------------------------------------------------------------

    def _soak_report(self, round_log, per_node_ok, per_node_failed,
                     *, windows: int, start: float) -> dict:
        report = self._report(round_log, per_node_ok, per_node_failed)
        self.mono.fold(self.telemetry.misreads)
        sentinels = {
            "monotonicity": self.mono.report(),
            "leaks": self.leak.report(),
            "tuner": judge_tuner_convergence(
                self._moves_per_window, sorted(self._heal_windows),
                settle_windows=self.settle_windows,
                max_tail_moves=self.max_tail_moves),
        }
        sentinels["ok"] = all(
            sentinels[k]["ok"]
            for k in ("monotonicity", "leaks", "tuner"))
        if not sentinels["ok"]:
            counters.inc("soak.sentinel.breach")
        report["soak"] = {
            "seed": self.seed,
            "history": {
                "config_key": self.history_key,
                "learned_leak": self._learned_leak,
                "learned_slo": self._learned_slo,
            },
            "windows": windows,
            "window_s": self.window_s,
            "duration_s": round(time.monotonic() - start, 3),
            "schedule": self._schedule_log,
            "kills": self._kills,
            "greys": self._greys,
            "heals": self._heals,
            "heal_windows": sorted(self._heal_windows),
            "moves_per_window": self._moves_per_window,
            "sentinels": sentinels,
            # Bounded per-destination decision tail: the evidence
            # behind the tuner verdict, small enough for the JSON
            # report line.
            "tuner_history": {
                key: hist[-64:]
                for key, hist in dcn_tune.decision_history().items()
            },
        }
        return report


def run_soak(scenario: Optional[dict] = None,
             workdir: Optional[str] = None, **kw) -> dict:
    """One-shot convenience: boot, soak, close, return the report."""
    world = SoakWorld(scenario, workdir=workdir, **kw)
    try:
        return world.run()
    finally:
        world.close()
