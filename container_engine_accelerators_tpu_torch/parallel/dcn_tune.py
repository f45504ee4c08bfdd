"""Closed-loop pipeline control: the data plane tunes its own grid.

The pipelined data plane (parallel/dcn_pipeline.py) runs a fixed
``TPU_DCN_CHUNK_BYTES``/``TPU_DCN_STRIPES`` grid, so a link that
degrades mid-run — loss, latency, partition-and-heal — either
collapses goodput or burns retry rounds until an operator retunes.
Yet every signal a controller needs is already live: the per-round
retransmit ratio, confirmed-bytes goodput, stripe utilization, and
the exposed-communication ratio (obs/critpath.py math recorded by
``send_pipelined`` itself).  This module closes the loop — the
robustness analog of FlexLink's dynamic multi-path traffic
distribution, with the exposed ratio as the objective in the spirit
of T3's overlap accounting (PAPERS.md).

One :class:`FlowTuner` per *destination daemon* (``host:port`` — the
link identity the signals describe; fleet flow NAMES are unique per
round, so per-name state would never learn).  The control law is
AIMD-shaped, one move per observation, strictly ordered so reactions
to trouble always outrank optimism:

- **shrink-on-retransmit** (multiplicative decrease): a round whose
  retransmit ratio reaches ``shrink_retx`` halves the chunk size
  (floor ``min_chunk_bytes``) — smaller chunks mean a lossy link
  re-pays less per loss;
- **back-off-on-loss**: at ``backoff_retx`` the stripe count also
  drops by one (floor ``min_stripes``) — heavy loss means the fan-out
  is feeding a link that cannot carry it;
- **grow-while-goodput-scales** (additive increase, probe/evaluate):
  after ``grow_clean_rounds`` consecutive clean observations the
  tuner probes one more stripe and keeps it only if total goodput
  improved by ``grow_margin`` AND the exposed-communication ratio did
  not get worse than ``exposed_slack`` — per-stripe goodput that
  stopped scaling, or overlap that got worse, reverts the probe and
  remembers the ceiling until the link's conditions change (the next
  loss event clears it);
- **recover-to-base**: ``recover_clean_rounds`` clean observations
  double a shrunken chunk back toward the configured grid — the
  post-heal half of "survives degradation without operator knobs";
- **hysteresis**: at most one adaptation per observation, a cooldown
  of ``cooldown_obs`` observations between moves, and growth streaks
  that any retransmit resets — a noisy signal hovering around a
  threshold ratchets gently in one direction instead of flapping.

Chunk decisions LATCH AT TRANSFER BOUNDARIES: a transfer's chunk grid
pins its client-assigned seq block, and retransmit rounds must re-send
under the SAME seqs for the receiver's dedup window to referee
exactly-once — so mid-transfer the tuner adapts only the stripe
count (re-striping pending chunk indices is seq-safe), and the chunk
move it decided applies to the destination's next transfer.  Zero-copy
shm rounds have no stripe fan-out at all: they bypass stripe
adaptation and keep chunk adaptation, exactly as the lane bypasses the
stager threads.

``TPU_DCN_TUNE`` is the kill switch — and the loop is ON by default
now that the continuous soak world (fleet/soak.py) gates every
presubmit on its convergence: ``TPU_DCN_TUNE=0`` still pins today's
static grid byte-for-byte.  Learned state never survives a daemon
respawn by construction — a restarted daemon binds a fresh data port,
which is a fresh controller key; the stale key ages out of the
bounded registry.

Decisions are observable like everything else in this stack:
``dcn.tune.*`` counters per decision kind, ``dcn.tune.chunk_bytes`` /
``dcn.tune.stripes`` gauges carrying the latest plan, an ``agent_top``
tuner line, and a bounded per-tuner decision HISTORY
(:func:`decision_history`) that the soak world's oscillation sentinel
replays.  The profiler bridge is observation-only: each observation
records the ``shm-staging`` subsystem share next to goodput, and the
``dcn.tune.cpu_bound`` gauge flips to 1.0 when staging share grows
while goodput stalls — the host is the bottleneck, so no grid move
can help and the tuner (deliberately) takes none.

The port's own copy of the JAX package's ``parallel/dcn_tune.py`` (host
code: no torch): ``TPU_DCN_TUNE*``, the control law and the ``dcn.tune.*``
series are the same, so one trace of observations gives the same
decisions in both.
"""

import logging
import os
import statistics
import threading
from typing import Dict, Optional, Tuple

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries, trace

log = logging.getLogger(__name__)

TUNE_ENV = "TPU_DCN_TUNE"
MIN_CHUNK_ENV = "TPU_DCN_TUNE_MIN_CHUNK"
MAX_STRIPES_ENV = "TPU_DCN_TUNE_MAX_STRIPES"

DEFAULT_MIN_CHUNK_BYTES = 64 << 10
DEFAULT_MAX_STRIPES = 8

# Bounded registry of per-destination tuners: a long-lived process
# talking to churning fleets must not leak controller state — past the
# cap the least-recently-planned destination is evicted (its daemon is
# gone or idle; a fresh key relearns from the static grid).
MAX_TUNERS = 64

# Bounded per-tuner decision history: every observation appends one
# entry (decision or None), the soak world's oscillation sentinel
# replays the tail, and the cap keeps a days-long soak from turning
# the controller into a leak of its own.
MAX_HISTORY = 512

# The profiler bridge verdict (observation-only): ``cpu_bound`` means
# staging share grew at least this much while goodput failed to beat
# the last observation by more than scheduling slack — evidence the
# HOST, not the link, is the bottleneck, so no grid move can help.
CPU_BOUND_SHARE_STEP = 0.05
CPU_BOUND_GOODPUT_SLACK = 1.02


def _profiler_staging_share() -> Optional[float]:
    """The ``shm-staging`` subsystem share from the in-process
    profiler, or None when the profiler is not running — the default
    observation source for the tuner's cpu-bound verdict.  Injectable
    per tuner for tests (and for the soak's synthetic rigs)."""
    from container_engine_accelerators_tpu_torch.obs import profiler
    if not profiler.running():
        return None
    try:
        return float(profiler.subsystem_shares().get("shm-staging",
                                                     0.0))
    except Exception:  # pragma: no cover - defensive: never block a plan
        return None


def tune_enabled(env=None) -> bool:
    """The kill switch.  Default ON: the JAX package's continuous soak
    world (``fleet/soak.py``) is the standing evidence the loop converges
    and never limit-cycles under mixed load, so absent the env var the
    closed loop runs.  ``TPU_DCN_TUNE=0`` (or any falsy
    spelling, including explicitly empty) pins the static grid."""
    env = env if env is not None else os.environ
    return env.get(TUNE_ENV, "1") not in ("0", "false", "off", "")


class TuneConfig:
    """Control-law constants, env-overridable floors/ceilings.  The
    *base* chunk/stripe grid comes per plan() call from the
    PipelineConfig, so one tuner serves callers with different
    configured grids without preferring the first it saw."""

    def __init__(self, env=None, *,
                 min_chunk_bytes: Optional[int] = None,
                 max_stripes: Optional[int] = None,
                 min_stripes: int = 1,
                 shrink_retx: float = 0.05,
                 backoff_retx: float = 0.25,
                 grow_margin: float = 1.10,
                 exposed_slack: float = 0.10,
                 grow_clean_rounds: int = 2,
                 recover_clean_rounds: int = 3,
                 cooldown_obs: int = 1,
                 probe_patience: int = 3,
                 bound_ttl_obs: int = 12):
        env = env if env is not None else os.environ
        if min_chunk_bytes is None:
            min_chunk_bytes = _env_int(env, MIN_CHUNK_ENV,
                                       DEFAULT_MIN_CHUNK_BYTES)
        if max_stripes is None:
            max_stripes = _env_int(env, MAX_STRIPES_ENV,
                                   DEFAULT_MAX_STRIPES)
        self.min_chunk_bytes = max(1, int(min_chunk_bytes))
        self.min_stripes = max(1, int(min_stripes))
        self.max_stripes = max(self.min_stripes, int(max_stripes))
        self.shrink_retx = float(shrink_retx)
        self.backoff_retx = max(float(backoff_retx), self.shrink_retx)
        self.grow_margin = float(grow_margin)
        self.exposed_slack = float(exposed_slack)
        self.grow_clean_rounds = max(1, int(grow_clean_rounds))
        self.recover_clean_rounds = max(1, int(recover_clean_rounds))
        self.cooldown_obs = max(0, int(cooldown_obs))
        # A probe is kept the first observation that qualifies and
        # reverted only after this many that do not: goodput samples
        # arrive under scheduling noise, and one slow draw must not
        # pin a wrong bound.
        self.probe_patience = max(1, int(probe_patience))
        # Reverted-probe bounds EXPIRE after this many observations:
        # on a loss-free link nothing else ever clears them, and both
        # "the measurement was a noise artifact" and "the competing
        # load went away" deserve a (bounded, infrequent) re-probe.
        self.bound_ttl_obs = max(1, int(bound_ttl_obs))


def _env_int(env, key: str, default: int) -> int:
    """Malformed values degrade to the default — the TPU_FAULT_SPEC
    rule: a typo'd knob must never take the data plane down."""
    raw = env.get(key)
    if raw is None:
        return default
    try:
        v = int(raw)
        if v <= 0:
            raise ValueError("must be > 0")
        return v
    except ValueError:
        log.error("ignoring malformed %s=%r (want a positive int)",
                  key, raw)
        return default


class FlowTuner:
    """The per-destination controller.  Pure decision logic — the
    pipeline feeds observations (:meth:`on_round`, :meth:`on_transfer`)
    and reads plans (:meth:`plan`, :meth:`stripes_now`); nothing here
    touches a socket, which is what makes the decision table unit-
    testable row by row."""

    def __init__(self, key: str, cfg: Optional[TuneConfig] = None,
                 staging_share=None):
        self.key = key
        self.cfg = cfg or TuneConfig()
        self._lock = threading.Lock()
        # Profiler bridge (observation-only): a zero-arg callable
        # returning the staging-memcpy subsystem share, or None when
        # unknown.  Injectable so the verdict is unit-testable without
        # a live profiler.
        self._staging_share = (staging_share if staging_share
                               is not None else _profiler_staging_share)
        self._last_share: Optional[float] = None
        self._last_goodput: Optional[float] = None
        self._cpu_bound = False
        # Bounded observation log for the oscillation sentinel.
        self._history: list = []
        self._decisions = 0
        # Learned grid deltas, applied to the caller's base grid:
        # chunk_scale is a power-of-two divisor (1 = the base grid),
        # stripe_delta an additive offset.  Keeping deltas instead of
        # absolutes means a caller that reconfigures its base mid-run
        # still gets the learned *adjustment*, not a stale absolute.
        self._chunk_scale = 1
        self._stripe_delta = 0
        self._base_chunk = 0  # last seen, for the gauges/logs only
        self._base_stripes = 0
        # Signal state.
        self._clean_streak = 0
        self._since_move = 10 ** 9  # observations since the last move
        self._last_exposed: Optional[float] = None
        # Recent clean-goodput window: probe baselines use its median.
        self._goodputs: list = []
        # Stripe probe in flight:
        # [baseline_goodput, baseline_exposed, direction, tries_left].
        # Every post-probe observation runs on the probed grid (plan()
        # at the next transfer, stripes_now() at the next retry
        # round): kept the first observation that qualifies, reverted
        # after ``probe_patience`` that do not.
        self._probe: Optional[list] = None
        # Remembered bounds from reverted probes — the values that
        # measurably did not help, in either direction; cleared by the
        # next loss event (conditions changed, worth re-probing).
        self._stripe_ceiling: Optional[int] = None
        self._stripe_floor: Optional[int] = None
        self._bound_set_obs = 0
        # True while the stripe count sits below base BECAUSE of a
        # loss backoff: only then does recovery toward base get the
        # lenient non-regression margin — a count the tuner chose to
        # narrow on a clean link must be beaten fair and square, or
        # borderline rigs would oscillate around it.
        self._loss_backed_off = False
        self.observations = 0

    # -- plans ---------------------------------------------------------------

    def plan(self, chunk_bytes: int, stripes: int) -> Tuple[int, int]:
        """The grid for a NEW transfer toward this destination:
        the caller's base grid with the learned adjustments applied,
        clamped to the floors/ceilings.  Publishes the plan gauges."""
        with self._lock:
            self._base_chunk = int(chunk_bytes)
            self._base_stripes = int(stripes)
            chunk, stripes_out = self._plan_locked()
        timeseries.gauge("dcn.tune.chunk_bytes", float(chunk))
        timeseries.gauge("dcn.tune.stripes", float(stripes_out))
        return chunk, stripes_out

    def _plan_locked(self) -> Tuple[int, int]:
        # The chunk floor bounds how far SHRINKING goes; a base grid
        # already below it is the operator's call and stays put —
        # clamping a small base UP would change static behavior the
        # moment the switch flips.
        floor = min(self.cfg.min_chunk_bytes, self._base_chunk)
        chunk = max(floor, self._base_chunk // self._chunk_scale)
        ceiling = self.cfg.max_stripes
        if self._stripe_ceiling is not None:
            ceiling = min(ceiling, self._stripe_ceiling)
        stripes = max(self.cfg.min_stripes,
                      min(self._base_stripes + self._stripe_delta,
                          ceiling))
        return chunk, stripes

    def stripes_now(self) -> int:
        """The stripe count for the NEXT retry round of an in-flight
        transfer — stripe moves apply mid-transfer (re-striping pending
        chunks is seq-safe); chunk moves wait for :meth:`plan`."""
        with self._lock:
            return self._plan_locked()[1]

    # -- observations --------------------------------------------------------

    def on_round(self, attempted: int, failed: int,
                 bytes_confirmed: int, elapsed_s: float,
                 lane: str = "socket",
                 full_round: bool = True) -> Optional[str]:
        """Feed one retry round's outcome; returns the decision taken
        (a ``dcn.tune.*`` counter suffix) or None.  ``lane == "shm"``
        rounds have no stripe fan-out: stripe decisions are bypassed,
        chunk decisions still apply.  ``full_round=False`` marks a
        partial retry round (a handful of re-sent chunks): its B/s is
        fixed-overhead-dominated and incomparable with full rounds, so
        it feeds the loss laws but never the capability window or a
        probe verdict."""
        if attempted <= 0:
            return None
        retx = failed / attempted
        goodput = (bytes_confirmed / elapsed_s if elapsed_s > 0
                   else 0.0)
        return self._observe(retx, goodput, exposed=None, lane=lane,
                             full=full_round)

    def on_transfer(self, ok: bool,
                    exposed_ratio: Optional[float] = None) -> None:
        """Transfer epilogue: a completed transfer contributes the
        exposed-communication ratio (only computable whole-transfer)
        to the NEXT decision's evidence; a failed transfer (round
        budget spent — the link is in real trouble) counts as a
        fully-lost observation so the decrease laws fire even when no
        round produced a verdict."""
        if ok:
            with self._lock:
                if exposed_ratio is not None:
                    self._last_exposed = float(exposed_ratio)
            return
        self._observe(1.0, 0.0, exposed=None, lane="socket",
                      full=True)

    def _observe(self, retx: float, goodput: float,
                 exposed: Optional[float], lane: str,
                 full: bool = True) -> Optional[str]:
        # Profiler read OUTSIDE the lock: the provider may sample
        # /proc or walk frames — never under the decision lock.
        try:
            share = self._staging_share()
        except Exception:
            share = None
        with self._lock:
            self.observations += 1
            self._since_move += 1
            exposed = exposed if exposed is not None \
                else self._last_exposed
            decision = self._decide_locked(retx, goodput, exposed,
                                           lane, full)
            chunk, stripes = self._plan_locked()
            # cpu-bound verdict (observation-only, never a decision
            # input): staging share grew while goodput stalled — the
            # host is the bottleneck, no grid move can help.
            if (share is not None and self._last_share is not None
                    and self._last_goodput is not None):
                self._cpu_bound = (
                    share > self._last_share + CPU_BOUND_SHARE_STEP
                    and goodput <= (self._last_goodput
                                    * CPU_BOUND_GOODPUT_SLACK))
            if share is not None:
                self._last_share = share
            self._last_goodput = goodput
            cpu_bound = self._cpu_bound
            if decision:
                self._decisions += 1
            self._history.append({
                "obs": self.observations,
                "decision": decision,
                "retx": round(retx, 4),
                "goodput_bps": round(goodput, 1),
                "staging_share": (round(share, 4)
                                  if share is not None else None),
                "chunk_bytes": chunk,
                "stripes": stripes,
            })
            del self._history[:-MAX_HISTORY]
        if decision:
            counters.inc(f"dcn.tune.{decision}")
            trace.event("dcn.tune.decision", key=self.key,
                        decision=decision, retx=round(retx, 4),
                        goodput_bps=round(goodput, 1),
                        chunk_bytes=chunk, stripes=stripes)
            log.info("dcn tuner %s: %s -> chunk=%d stripes=%d "
                     "(retx=%.3f, goodput=%.0f B/s)", self.key,
                     decision, chunk, stripes, retx, goodput)
        timeseries.gauge("dcn.tune.chunk_bytes", float(chunk))
        timeseries.gauge("dcn.tune.stripes", float(stripes))
        timeseries.gauge("dcn.tune.cpu_bound",
                         1.0 if cpu_bound else 0.0)
        return decision

    # -- the decision table (caller holds the lock) --------------------------

    def _decide_locked(self, retx: float, goodput: float,
                       exposed: Optional[float], lane: str,
                       full: bool = True) -> Optional[str]:
        cfg = self.cfg
        lossy = retx >= cfg.shrink_retx
        if lossy:
            self._clean_streak = 0
            # Conditions changed: remembered probe bounds and the
            # capability window from a clean-link era no longer
            # describe this link (stale pre-degrade highs would
            # sandbag every post-heal recovery probe).
            self._stripe_ceiling = None
            self._stripe_floor = None
            self._goodputs.clear()
        else:
            self._clean_streak += 1
            if (self._stripe_ceiling is not None
                    or self._stripe_floor is not None) \
                    and (self.observations - self._bound_set_obs
                         >= cfg.bound_ttl_obs):
                # Bounds age out on loss-free links: a bound pinned by
                # one noisy measurement (or by load that has since
                # moved on) must not freeze the grid forever —
                # re-exploration stays bounded and infrequent.
                self._stripe_ceiling = None
                self._stripe_floor = None

        if not lossy and full and lane != "shm":
            # Short capability window: probe baselines use its median
            # (the typical recent capability under scheduling noise).
            # Only FULL socket rounds are comparable samples: shm
            # rounds run at memcpy class, and a partial retry round's
            # B/s is fixed-overhead-dominated — either would skew
            # every later probe verdict.
            self._goodputs.append(goodput)
            del self._goodputs[:-4]

        # A probe's verdict: kept the FIRST post-probe observation
        # that qualifies, reverted only after ``probe_patience`` that
        # do not — judged before any other law moves.  Partial rounds
        # are not comparable evidence: they neither keep nor spend
        # patience (loss still judges immediately).
        if self._probe is not None and lane != "shm" \
                and (full or lossy):
            base_goodput, base_exposed, direction, tries = self._probe
            probed = self._base_stripes + self._stripe_delta
            if lossy and direction < 0:
                # A narrower fan-out that rode into loss: the loss is
                # its own verdict and it AGREES with the reduction —
                # keep it without marking a floor, and let the
                # decrease laws below respond to the loss itself.
                self._probe = None
            else:
                # Growth probes ABOVE the configured base must prove
                # the fan-out scales (+grow_margin); growth recovering
                # TOWARD base — known-good, operator-blessed territory
                # a loss backoff left — only has to not regress.  A
                # DOWNWARD probe must measurably pay (the same margin),
                # or flat noise would drift every clean link to one
                # stripe.
                if direction > 0 and probed <= self._base_stripes \
                        and self._loss_backed_off:
                    margin = 1.0
                else:
                    margin = cfg.grow_margin
                qualifies = (not lossy
                             and goodput >= base_goodput * margin
                             and not _exposed_worse(
                                 exposed, base_exposed,
                                 cfg.exposed_slack))
                if qualifies:
                    self._probe = None
                    self._since_move = 0
                    if direction > 0 and probed >= self._base_stripes:
                        self._loss_backed_off = False
                    return "keep_stripe"
                if not lossy and tries > 1:
                    # One slow sample is scheduling noise, not a
                    # verdict: spend a patience try, keep watching.
                    self._probe[3] = tries - 1
                    return None
                # Out of patience (or loss failing a growth probe):
                # one move per observation — the revert IS this
                # observation's move.  The remembered bound is the
                # last KNOWN-GOOD count (one step back from the
                # probe), so the failed value is never re-probed until
                # a loss event says conditions changed — that re-probe
                # loop would be the flap the hysteresis exists to
                # prevent.
                self._probe = None
                self._since_move = 0
                self._bound_set_obs = self.observations
                if direction > 0:
                    self._stripe_ceiling = max(
                        self.cfg.min_stripes, probed - 1)
                else:
                    self._stripe_floor = min(
                        self.cfg.max_stripes, probed + 1)
                self._stripe_delta -= direction
                return "revert_stripe"

        # Decrease laws: reactions to trouble outrank optimism AND
        # hysteresis — the cooldown exists to stop flapping between
        # opposing moves, never to delay a loss response.  Repeated
        # lossy observations keep decreasing (the TCP-shaped
        # multiplicative half of AIMD).
        if lossy:
            if retx >= cfg.backoff_retx and lane != "shm":
                _, cur_stripes = self._plan_locked()
                if cur_stripes > cfg.min_stripes:
                    self._stripe_delta -= 1
                    self._since_move = 0
                    self._loss_backed_off = True
                    return "backoff_stripe"
                # At the floor: fall through to the chunk shrink —
                # the one remaining lever.
            cur_chunk, _ = self._plan_locked()
            if cur_chunk > cfg.min_chunk_bytes:
                self._chunk_scale *= 2
                self._since_move = 0
                return "shrink_chunk"
            counters.inc("dcn.tune.clamped")
            return None

        if self._since_move <= cfg.cooldown_obs:
            return None  # hysteresis: let the last move settle

        # Increase laws, clean observations only.
        if self._chunk_scale > 1 \
                and self._clean_streak >= cfg.recover_clean_rounds:
            self._chunk_scale //= 2
            self._clean_streak = 0
            self._since_move = 0
            return "grow_chunk"
        if lane != "shm" and full \
                and self._clean_streak >= cfg.grow_clean_rounds:
            if self._cpu_bound:
                # The profiler's verdict, acted on: staging share
                # is climbing while goodput is flat — the plane is
                # CPU-bound, not link-bound, a regime AIMD's loss/
                # goodput laws cannot see.  More stripes would add
                # thread fan-out to a saturated CPU, so both stripe
                # probes are held (not reverted — no move, no
                # hysteresis reset) until the latch clears.  The
                # latch this decision sees is the PREVIOUS
                # observation's (cpu_bound is recomputed after the
                # decision), one observation of lag by design.
                counters.inc("dcn.tune.cpu_hold")
                return None
            _, cur_stripes = self._plan_locked()
            ceiling = cfg.max_stripes
            if self._stripe_ceiling is not None:
                ceiling = min(ceiling, self._stripe_ceiling)
            floor = cfg.min_stripes
            if self._stripe_floor is not None:
                floor = max(floor, self._stripe_floor)
            # Median, not max: the baseline is the TYPICAL recent
            # capability — a probe judged against the luckiest recent
            # draw could never win on a noisy rig, and one judged
            # against the unluckiest would keep anything.
            base_goodput = (statistics.median(self._goodputs)
                            if self._goodputs else goodput)
            patience = cfg.probe_patience
            if cur_stripes + 1 <= ceiling:
                # Add stripes while per-stripe goodput still scales.
                self._probe = [base_goodput, exposed, +1, patience]
                self._stripe_delta += 1
                self._clean_streak = 0
                self._since_move = 0
                return "grow_stripe"
            if cur_stripes - 1 >= floor:
                # Growth is capped (reverted, or at the ceiling): try
                # the OTHER direction — on rigs where fan-out costs
                # more than it buys (loopback; a saturated NIC), fewer
                # stripes IS the optimum, and a controller that can
                # only match the operator's base can never beat the
                # best hand-tuned grid.  Kept only if it measurably
                # pays, so flat noise never drains stripes.
                self._probe = [base_goodput, exposed, -1, patience]
                self._stripe_delta -= 1
                self._clean_streak = 0
                self._since_move = 0
                return "narrow_stripe"
        return None

    # -- lifecycle -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            chunk, stripes = self._plan_locked()
            return {
                "key": self.key,
                "chunk_bytes": chunk,
                "stripes": stripes,
                "chunk_scale": self._chunk_scale,
                "stripe_delta": self._stripe_delta,
                "stripe_ceiling": self._stripe_ceiling,
                "clean_streak": self._clean_streak,
                "observations": self.observations,
                "probing": self._probe is not None,
                "decisions": self._decisions,
                "cpu_bound": self._cpu_bound,
            }

    def history(self) -> list:
        """The bounded observation log — one entry per observation
        (``decision`` is None when no law fired), newest last.  The
        soak world's convergence sentinel replays this to tell a
        settling controller from a limit cycle."""
        with self._lock:
            return [dict(e) for e in self._history]


def _exposed_worse(now: Optional[float], before: Optional[float],
                   slack: float) -> bool:
    """The objective check: did the overlap get worse?  Unknown on
    either side judges nothing (the goodput law still referees)."""
    if now is None or before is None:
        return False
    return now > before + slack


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_tuners: Dict[str, FlowTuner] = {}
_order: Dict[str, int] = {}  # key -> last-plan tick (LRU eviction)
_tick = 0


def tuner_for(key: str,
              cfg: Optional[TuneConfig] = None) -> FlowTuner:
    """The per-destination tuner.  The kill switch is the CALLER's
    decision (``PipelineConfig.tuned`` — env-resolved, per-config
    overridable): a disabled pipeline simply never asks.  A
    destination is a daemon address (``host:port``): a SIGKILLed
    worker respawns on a fresh port, so its learned state is reset
    cleanly by construction — the dead key just ages out."""
    global _tick
    with _lock:
        _tick += 1
        tuner = _tuners.get(key)
        if tuner is None:
            if len(_tuners) >= MAX_TUNERS:
                oldest = min(_order, key=_order.get)
                del _tuners[oldest]
                del _order[oldest]
            tuner = _tuners[key] = FlowTuner(key, cfg)
        _order[key] = _tick
        timeseries.gauge("dcn.tune.flows", float(len(_tuners)))
        return tuner


def snapshot() -> Dict[str, dict]:
    with _lock:
        items = list(_tuners.values())
    return {t.key: t.snapshot() for t in items}


def decision_history() -> Dict[str, list]:
    """Every live tuner's bounded observation log, keyed like
    :func:`snapshot` — the export the soak oscillation sentinel (and
    the soak report's tuner section) consumes."""
    with _lock:
        items = list(_tuners.values())
    return {t.key: t.history() for t in items}


def reset() -> None:
    """Drop every tuner — test isolation and scenario boots, same
    contract as counters.reset()."""
    with _lock:
        _tuners.clear()
        _order.clear()
