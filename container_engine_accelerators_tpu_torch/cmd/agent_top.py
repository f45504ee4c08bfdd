"""agent_top — htop for the node agent, over a plain Prometheus scrape.

The MetricServer already exports everything an operator needs
(`agent_rate`, `agent_goodput`, `agent_gauge`, `agent_latency`,
`agent_exemplar`); what was missing is a way to LOOK
at it without standing up a Prometheus + Grafana stack next to a
misbehaving node.  This tool is that way: it scrapes the HTTP endpoint
(stdlib urllib, no dependencies — it must run in the barest debug
container), digests the families into one screen, and refreshes in
place:

- **rates**: the busiest windowed counters (events/s), which is the
  "is it happening NOW" view the cumulative `agent_events` can't give;
- **goodput**: landed bytes/s per flow / link / node;
- **latency**: per-op p50/p99 computed from the cumulative le buckets,
  with each op's worst-sample trace exemplar — copy the id into
  ``cmd/agent_trace.py --trace <id>`` (or just run ``--exemplar <op>``
  on the JSONL) and the metric becomes a span tree;
- **gauges + SLO status**: in-flight chunks, stripe utilization,
  retransmit ratio, and every ``slo.<key>`` verdict the fleet
  aggregator published, rendered ok/BREACH;
- **phase breakdown**: where the data plane's time goes, by transfer
  phase (stage / send / wait / read, socket and shm lanes) — each
  phase op's share of the summed phase time estimated from the
  cumulative le buckets, next to the live ``dcn.exposed_ratio`` gauge
  (DCN time not hidden behind staging; 1.0 = serial-shaped);
- **hotspots**: where the CPU goes — top subsystems by sample share
  from the same server's ``/profile`` endpoint (the continuous
  profiler, obs/profiler.py), idle threads split out so a parked pool
  never drowns the busy share.  Absent when the endpoint is (an old
  agent, or ``TPU_PROF=0``);
- **suspicion**: the grey-failure detector's live verdicts
  (obs/anomaly.py) — one score bar + verdict per node from the
  scraped ``anomaly.score.<node>`` / ``anomaly.state.<node>`` gauges,
  with the cumulative suspect/confirmed/cleared event counts under
  it.  Present only when the scraped process runs the detector (the
  fleet coordinator).

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.agent_top                       # live, 2s refresh
  python -m container_engine_accelerators_tpu_torch.cmd.agent_top --port 2112 --once    # one snapshot (CI)
  python -m container_engine_accelerators_tpu_torch.cmd.agent_top --url http://node:2112/metrics
  python -m container_engine_accelerators_tpu_torch.cmd.agent_top --demo --once         # self-contained tour:
                                                # boots a MetricServer
                                                # with synthetic traffic

`--once` prints a single snapshot and exits 0 (1 when the scrape
fails) — the CI-able acceptance surface.
"""

import argparse
import sys
import time
import urllib.error
import urllib.request


from container_engine_accelerators_tpu_torch.obs import (
    anomaly,
    history,
    profiler,
    promtext,
)

FAMILIES = ("agent_rate", "agent_goodput", "agent_gauge",
            "agent_latency", "agent_exemplar", "agent_events")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--url", default=None,
                   help="full metrics URL (overrides --host/--port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2112)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in live mode (seconds)")
    p.add_argument("--top", type=int, default=10,
                   help="rows per section")
    p.add_argument("--demo", action="store_true",
                   help="boot a local MetricServer with synthetic "
                        "traffic and scrape it (self-contained tour / "
                        "CI smoke)")
    return p.parse_args(argv)


# -- scrape + parse ----------------------------------------------------------


def scrape(url: str, timeout_s: float = 10.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode()


def profile_url(metrics_url: str) -> str:
    """``…/metrics`` -> ``…/profile`` (same listener serves both)."""
    if metrics_url.endswith("/metrics"):
        return metrics_url[: -len("/metrics")] + "/profile"
    return metrics_url.rstrip("/") + "/profile"


def scrape_profile(url: str, timeout_s: float = 10.0):
    """The hotspot panel's input: the /profile body, or None when the
    endpoint is absent/unreachable — the panel degrades to absent,
    never takes down the screen."""
    try:
        return profiler.fetch(url, timeout_s)
    except (OSError, ValueError):
        return None


def parse_families(text: str) -> dict:
    """Prometheus text exposition -> {family: [(labels, value)]} for
    the agent families (everything else is skipped).  Parsing itself
    is the shared obs/promtext parser — one exposition grammar for
    every scrape surface."""
    samples = promtext.parse_samples(text)
    return {name: samples.get(name, []) for name in FAMILIES}


def percentile_from_buckets(buckets, total, q):
    """Smallest le bound whose cumulative count reaches q*total —
    same upper-bound contract as obs/histo.percentile, in µs."""
    if not total:
        return 0.0
    target = q * total
    for le in sorted(buckets):
        if buckets[le] >= target:
            return float(le)
    return float(max(buckets)) if buckets else 0.0


def total_us_from_buckets(buckets):
    """Upper-bound estimate of an op's summed duration from its
    cumulative le buckets (the scrape carries no sum): per-bucket
    count times the bucket bound.  Consistent across ops, so SHARES
    are honest even though absolutes are upper bounds."""
    prev = 0
    out = 0.0
    for le in sorted(buckets):
        n = buckets[le] - prev
        prev = buckets[le]
        if n > 0:
            out += n * le
    return out


# The transfer-phase ops the breakdown panel rolls up: one pipelined /
# serial / shm transfer decomposes into exactly these
# (parallel/dcn_pipeline.py, parallel/dcn.py).
PHASE_OPS = (
    "dcn.chunk.stage", "dcn.chunk.send", "dcn.chunk.wait",
    "dcn.chunk.read", "dcn.wait", "dcn.shm.stage", "dcn.shm.read",
    "dcn.exchange.stage", "dcn.exchange.send", "dcn.exchange.land",
)


def digest(fams: dict, prof: dict = None) -> dict:
    """Family samples (+ optional /profile body) -> the screen model."""
    rates = sorted(
        ((lb.get("event", "?"), v) for lb, v in fams["agent_rate"]),
        key=lambda kv: -kv[1])
    goodput = sorted(
        ((lb.get("scope", "?"), lb.get("name", "?"), v)
         for lb, v in fams["agent_goodput"]),
        key=lambda row: -row[2])

    per_op = {}
    for lb, v in fams["agent_latency"]:
        op, bucket = lb.get("op", "?"), lb.get("bucket", "")
        entry = per_op.setdefault(op, {"buckets": {}, "count": 0})
        if bucket == "+Inf":
            entry["count"] = int(v)
        else:
            try:
                entry["buckets"][int(bucket)] = v
            except ValueError:
                pass
    exemplars = {}
    for lb, v in fams["agent_exemplar"]:
        op = lb.get("op", "?")
        worst = exemplars.get(op)
        if worst is None or v > worst[1]:
            exemplars[op] = (lb.get("trace", ""), v)
    latency = []
    for op, entry in per_op.items():
        latency.append({
            "op": op,
            "count": entry["count"],
            "p50_us": percentile_from_buckets(
                entry["buckets"], entry["count"], 0.50),
            "p99_us": percentile_from_buckets(
                entry["buckets"], entry["count"], 0.99),
            "exemplar": exemplars.get(op, ("", 0.0))[0],
        })
    latency.sort(key=lambda r: -r["count"])

    # Phase-breakdown panel: the transfer-phase ops' estimated total
    # time, as shares — "where did the data plane's time go", straight
    # off the scrape (no JSONL needed for the first-order answer).
    phase_rows = []
    phase_total = 0.0
    for op in PHASE_OPS:
        entry = per_op.get(op)
        if not entry or not entry["count"]:
            continue
        est = total_us_from_buckets(entry["buckets"])
        phase_rows.append({"op": op, "count": entry["count"],
                           "total_us": est})
        phase_total += est
    for row in phase_rows:
        row["share"] = (row["total_us"] / phase_total
                        if phase_total else 0.0)
    phase_rows.sort(key=lambda r: -r["total_us"])

    gauges, slos, anom_gauges = [], {}, {}
    for lb, v in fams["agent_gauge"]:
        name = lb.get("name", "?")
        if name.startswith("slo."):
            key, _, field = name[4:].rpartition(".")
            if field in ("ok", "value") and key:
                slos.setdefault(key, {})[field] = v
                continue
        if name.startswith("anomaly."):
            anom_gauges[name] = v
            continue
        gauges.append((name, v))
    gauges.sort()

    # The serving workload's one-glance panel: live QPS/shed rates,
    # cumulative hedge/breaker evidence, queue depth — present only
    # when the scraped node actually serves.
    rate_by = dict(rates)
    gauge_by = dict(gauges)
    event_by = {lb.get("event", "?"): v
                for lb, v in fams["agent_events"]}
    serving = None
    if any(k.startswith("serving.")
           for k in (*rate_by, *gauge_by, *event_by)):
        serving = {
            "qps": rate_by.get("serving.ok", 0.0),
            "shed_per_s": rate_by.get("serving.shed", 0.0),
            "queue_depth": gauge_by.get("serving.queue.depth", 0.0),
            "inflight": gauge_by.get("serving.inflight", 0.0),
            "breaker_open": gauge_by.get("serving.breaker.open_nodes",
                                         0.0),
            "ok_total": event_by.get("serving.ok", 0.0),
            "errors_total": event_by.get("serving.errors", 0.0),
            "shed_total": event_by.get("serving.shed", 0.0),
            "hedge": {
                "fired": event_by.get("serving.hedge.fired", 0.0),
                "won": event_by.get("serving.hedge.won", 0.0),
                "wasted": event_by.get("serving.hedge.wasted", 0.0),
            },
        }
    # Suspicion panel: the grey-failure detector's per-node verdicts,
    # straight off the scraped anomaly.score.<node> /
    # anomaly.state.<node> gauges — present only when the scraped
    # process runs the detector (the fleet coordinator publishes
    # them; a plain node agent doesn't).
    suspicion = None
    score_rows = []
    for name, v in sorted(anom_gauges.items()):
        if not name.startswith("anomaly.score."):
            continue
        node = name[len("anomaly.score."):]
        state = int(anom_gauges.get(f"anomaly.state.{node}", 0.0))
        score_rows.append({"node": node, "score": v, "state": state})
    if score_rows:
        score_rows.sort(key=lambda r: (-r["score"], r["node"]))
        suspicion = {
            "rows": score_rows,
            "suspect": event_by.get("anomaly.suspect", 0.0),
            "confirmed": event_by.get("anomaly.confirmed", 0.0),
            "cleared": event_by.get("anomaly.cleared", 0.0),
        }
    # Lane split (the memcpy-speed same-host plane): where the data
    # plane's BYTES go — daemon↔daemon segments, client↔daemon shm
    # staging, or TCP — as live bytes/s next to cumulative totals.
    # The shm_direct row > 0 with a flat socket row is the one-glance
    # proof co-hosted transfers are skipping the peer TCP stream.
    lanes = {}
    for lane in ("shm_direct", "shm", "socket"):
        bps = rate_by.get(f"dcn.lane.{lane}.bytes", 0.0)
        total = gauge_by.get(f"dcn.lane.{lane}.total_bytes", 0.0)
        if bps or total:
            lanes[lane] = {"bps": bps, "total": total}
    # The self-tuning data plane's one-glance line: the controller's
    # current grid next to the phase panel it is steering.
    tuner = None
    if "dcn.tune.chunk_bytes" in gauge_by \
            or "dcn.tune.stripes" in gauge_by:
        tuner = {
            "chunk_bytes": gauge_by.get("dcn.tune.chunk_bytes", 0.0),
            "stripes": gauge_by.get("dcn.tune.stripes", 0.0),
            "flows": gauge_by.get("dcn.tune.flows", 0.0),
            # 'clamped' is documented as NO move taken (every lever at
            # its floor) — counting it would show a saturated
            # controller as an active one.
            "moves": sum(v for k, v in event_by.items()
                         if k.startswith("dcn.tune.")
                         and k != "dcn.tune.clamped"),
        }
    # Hotspot panel (the continuous profiler's /profile scrape):
    # subsystems by sample count, idle split out — "which code burns
    # the CPU" beside the phase panel's "which phase burns the time".
    # A malformed body (a reused port answering junk JSON) costs the
    # panel, never the screen — same rule as an unreachable endpoint.
    hotspots = None
    try:
        subs_raw = prof.get("subsystems") if prof else None
        if isinstance(subs_raw, dict) and subs_raw:
            subs = {str(k): int(float(v or 0))
                    for k, v in subs_raw.items()}
            idle = subs.get("idle", 0)
            busy = sorted(((s, n) for s, n in subs.items()
                           if s != "idle" and n > 0),
                          key=lambda kv: -kv[1])
            busy_total = sum(n for _, n in busy)
            ratio = prof.get("overhead_ratio")
            hotspots = {
                "samples": int(float(prof.get("samples") or 0)),
                "dropped": int(float(prof.get("dropped") or 0)),
                "idle": idle,
                "overhead_ratio": (float(ratio)
                                   if ratio is not None else None),
                "rows": [(s, n,
                          n / busy_total if busy_total else 0.0)
                         for s, n in busy],
            }
    except (TypeError, ValueError, AttributeError):
        hotspots = None
    return {"rates": rates, "goodput": goodput,
            "latency": latency, "gauges": gauges, "slos": slos,
            "serving": serving, "phases": phase_rows, "tuner": tuner,
            "lanes": lanes, "hotspots": hotspots,
            "suspicion": suspicion,
            "exposed_ratio": dict(gauges).get("dcn.exposed_ratio")}


def trend_lines(model: dict) -> list:
    """One trend verdict line per headline SLO metric, judged against
    the history ledger (obs/history.py) when ``TPU_HISTORY_DIR`` is
    set.  Each scraped ``slo.<key>.value`` is compared to the most
    recent ledger series carrying that metric (fleet reports record
    SLO measurements under the SLO key itself).  Any trouble — no
    history dir, unreadable ledger, thin baseline — costs the lines,
    never the screen."""
    try:
        ledger = history.RunLedger()
        if not ledger.enabled:
            return []
        lines = []
        for key in sorted(model.get("slos") or {}):
            entry = model["slos"][key]
            if "value" not in entry:
                continue
            recs = ledger.records(metric=key)
            if not recs:
                continue
            # Judge against the most recently recorded config's
            # series — the scrape carries no config key, and mixing
            # configs would compare apples to racks.
            cfg = recs[-1].get("config_key")
            series = [r for r in recs if r.get("config_key") == cfg]
            v = history.trend_verdict(series, key, entry["value"])
            if v["status"] != "no_baseline":
                lines.append("  " + history.format_verdict(v))
        return lines
    except Exception:  # noqa: BLE001 — the panel-degrade rule
        return []


# -- render ------------------------------------------------------------------


def human_bytes(v: float, suffix: str = "") -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.1f} {unit}{suffix}"
        v /= 1024
    return f"{v:.1f} GiB{suffix}"  # pragma: no cover — loop returns


def human_bps(v: float) -> str:
    return human_bytes(v, "/s")


def render(model: dict, source: str, top_n: int = 10) -> str:
    lines = [f"agent_top — {source} — {time.strftime('%H:%M:%S')}"]

    slos = model["slos"]
    if slos:
        lines.append("")
        lines.append("SLO status:")
        for key in sorted(slos):
            entry = slos[key]
            ok = entry.get("ok", 0.0) >= 1.0
            lines.append(f"  {key:<24} {entry.get('value', 0.0):>14.3f} "
                         f"{'ok' if ok else '** BREACH **'}")
        trends = model.get("trends") or []
        if trends:
            lines.append("")
            lines.append("trend vs history "
                         "(obs/history.py baseline):")
            lines.extend(trends)

    serving = model.get("serving")
    if serving:
        h = serving["hedge"]
        lines.append("")
        lines.append("serving:")
        lines.append(f"  {'qps (windowed)':<24} {serving['qps']:>14.1f}")
        lines.append(f"  {'shed/s':<24} "
                     f"{serving['shed_per_s']:>14.2f}")
        lines.append(f"  {'queue depth':<24} "
                     f"{serving['queue_depth']:>14.0f}")
        lines.append(f"  {'batches in flight':<24} "
                     f"{serving['inflight']:>14.0f}")
        lines.append(f"  {'breakers open':<24} "
                     f"{serving['breaker_open']:>14.0f}")
        lines.append(f"  {'ok / errors / shed':<24} "
                     f"{serving['ok_total']:>6.0f} / "
                     f"{serving['errors_total']:.0f} / "
                     f"{serving['shed_total']:.0f}")
        lines.append(f"  {'hedge fired/won/wasted':<24} "
                     f"{h['fired']:>6.0f} / {h['won']:.0f} / "
                     f"{h['wasted']:.0f}")

    phases = model.get("phases") or []
    if phases:
        lines.append("")
        lines.append(f"{'phase (where the time goes)':<28} "
                     f"{'count':>7} {'est_ms':>10} {'share':>7}")
        for row in phases[:top_n]:
            lines.append(f"{row['op']:<28} {row['count']:>7} "
                         f"{row['total_us'] / 1e3:>10.1f} "
                         f"{row['share'] * 100:>6.1f}%")
        exposed = model.get("exposed_ratio")
        if exposed is not None:
            lines.append(f"{'exposed comm ratio':<28} "
                         f"{'':>7} {'':>10} {exposed * 100:>6.1f}%")

    suspicion = model.get("suspicion")
    if suspicion:
        cap = anomaly.AnomalyConfig().score_cap
        lines.append("")
        lines.append(f"{'suspicion (grey-failure)':<16} "
                     f"{'score':>7}  {'':<{int(cap) + 2}} verdict")
        for r in suspicion["rows"][:top_n]:
            fill = int(round(min(max(r["score"], 0.0), cap)))
            bar = "#" * fill
            verdict = anomaly.STATE_NAMES.get(r["state"], "?")
            if r["state"] != anomaly.HEALTHY:
                verdict = verdict.upper()
            lines.append(f"{r['node']:<16} {r['score']:>7.2f}  "
                         f"[{bar:<{int(cap)}}] {verdict}")
        lines.append(f"{'(events)':<16} "
                     f"suspect={suspicion['suspect']:.0f} "
                     f"confirmed={suspicion['confirmed']:.0f} "
                     f"cleared={suspicion['cleared']:.0f}")

    hotspots = model.get("hotspots")
    if hotspots:
        lines.append("")
        lines.append(f"{'hotspot (cpu sample share)':<28} "
                     f"{'samples':>9} {'share':>7}")
        for sub, n, share in hotspots["rows"][:top_n]:
            lines.append(f"{sub:<28} {n:>9} {share * 100:>6.1f}%")
        extra = ""
        if hotspots.get("overhead_ratio") is not None:
            extra = (f", sampler overhead "
                     f"{hotspots['overhead_ratio'] * 100:.2f}%")
        lines.append(f"{'(idle threads)':<28} "
                     f"{hotspots['idle']:>9}  of "
                     f"{hotspots['samples']}{extra}")

    lanes = model.get("lanes") or {}
    if lanes:
        lines.append("")
        lines.append(f"{'lane split (same-host plane)':<28} "
                     f"{'bytes/s':>14} {'total':>14}")
        for lane in ("shm_direct", "shm", "socket"):
            entry = lanes.get(lane)
            if entry is None:
                continue
            lines.append(f"{lane:<28} "
                         f"{human_bps(entry['bps']):>14} "
                         f"{human_bytes(entry['total']):>14}")

    tuner = model.get("tuner")
    if tuner:
        chunk = tuner["chunk_bytes"]
        chunk_txt = (f"{chunk / 1024:.0f}K" if chunk < (1 << 20)
                     else f"{chunk / (1 << 20):.1f}M")
        lines.append("")
        lines.append(f"{'tuner (closed-loop grid)':<28} "
                     f"chunk={chunk_txt} "
                     f"stripes={tuner['stripes']:.0f} "
                     f"flows={tuner['flows']:.0f} "
                     f"moves={tuner['moves']:.0f}")

    goodput = [g for g in model["goodput"]][:top_n]
    if goodput:
        lines.append("")
        lines.append(f"{'goodput':<8} {'name':<32} {'landed':>14}")
        for scope, name, v in goodput:
            lines.append(f"{scope:<8} {name:<32} {human_bps(v):>14}")

    rates = [r for r in model["rates"] if r[1] > 0][:top_n]
    if rates:
        lines.append("")
        lines.append(f"{'rate (windowed)':<44} {'per second':>12}")
        for name, v in rates:
            unit = human_bps(v) if name.endswith(".bytes") else f"{v:.2f}"
            lines.append(f"{name:<44} {unit:>12}")

    latency = model["latency"][:top_n]
    if latency:
        lines.append("")
        lines.append(f"{'op':<26} {'count':>7} {'p50_us':>9} "
                     f"{'p99_us':>10}  exemplar")
        for r in latency:
            lines.append(f"{r['op']:<26} {r['count']:>7} "
                         f"{r['p50_us']:>9.0f} {r['p99_us']:>10.0f}  "
                         f"{r['exemplar']}")

    gauges = model["gauges"][:top_n]
    if gauges:
        lines.append("")
        lines.append(f"{'gauge':<44} {'value':>12}")
        for name, v in gauges:
            lines.append(f"{name:<44} {v:>12.3f}")

    if len(lines) == 1:
        lines.append("")
        lines.append("(no agent_* series yet — is anything running?)")
    return "\n".join(lines)


# -- demo mode ---------------------------------------------------------------


def _demo_server():
    """A throwaway MetricServer fed with synthetic traffic — the
    self-contained tour."""
    from prometheus_client import CollectorRegistry

    from container_engine_accelerators_tpu_torch.metrics import counters
    from container_engine_accelerators_tpu_torch.metrics.metrics import MetricServer
    from container_engine_accelerators_tpu_torch.obs import timeseries, trace
    from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

    class _NoGpus:
        def collect_gpu_device(self, name):  # pragma: no cover
            raise RuntimeError("no GPUs in demo")

        def devices(self):
            return []

        def model(self, name):  # pragma: no cover
            return "demo"

    for _ in range(40):
        with trace.span("dcn.send", histogram="dcn.send", op="demo"):
            pass
    with trace.span("dcn.replay", histogram="dcn.replay", flows=2):
        time.sleep(0.02)
    counters.inc("dcn.reconnect.success", 3)
    counters.inc("dcn.frames.deduped")
    timeseries.record("xferd.rx.bytes", 6 << 20)
    # Concrete demo instances of the documented goodput.<scope>.<name>
    # / slo.<key>.* families (README metrics tables) — the names here
    # are sample data, not new families.
    timeseries.record("goodput.link.n0->n1", 4 << 20)  # lint: disable=undocumented-metric
    timeseries.record("goodput.flow.demo.ring", 2 << 20)  # lint: disable=undocumented-metric
    timeseries.gauge("dcn.chunks.inflight", 3)
    timeseries.gauge("dcn.stripes.active", 2)
    timeseries.gauge("dcn.stripes.configured", 2)
    # The phase-breakdown panel's inputs: transfer-phase histogram ops
    # plus the live exposed-communication gauge.
    for _ in range(4):
        with trace.span("dcn.chunk.stage", histogram="dcn.chunk.stage"):
            pass
        with trace.span("dcn.chunk.send", histogram="dcn.chunk.send"):
            time.sleep(0.002)
    with trace.span("dcn.wait", histogram="dcn.wait"):
        time.sleep(0.001)
    timeseries.gauge("dcn.exposed_ratio", 0.42)
    # The lane-split panel's inputs (the memcpy-speed same-host
    # plane): per-lane byte series + cumulative totals.
    timeseries.record("dcn.lane.shm_direct.bytes", 5 << 20)
    timeseries.record("dcn.lane.shm.bytes", 5 << 20)
    timeseries.record("dcn.lane.socket.bytes", 1 << 20)
    timeseries.gauge_add("dcn.lane.shm_direct.total_bytes", 48 << 20)
    timeseries.gauge_add("dcn.lane.shm.total_bytes", 48 << 20)
    timeseries.gauge_add("dcn.lane.socket.total_bytes", 9 << 20)
    counters.inc("dcn.shm.ring.posts", 12)
    # The self-tuning data plane's line (parallel/dcn_tune.py).
    timeseries.gauge("dcn.tune.chunk_bytes", 262144)
    timeseries.gauge("dcn.tune.stripes", 2)
    timeseries.gauge("dcn.tune.flows", 1)
    # Concrete demo instances of the documented `dcn.tune.<decision>`
    # family — sample data, not new names.
    counters.inc("dcn.tune.shrink_chunk")  # lint: disable=undocumented-metric
    counters.inc("dcn.tune.grow_chunk")  # lint: disable=undocumented-metric
    timeseries.gauge("slo.min_goodput_bps.ok", 1)  # lint: disable=undocumented-metric
    timeseries.gauge("slo.min_goodput_bps.value", 4 << 20)  # lint: disable=undocumented-metric
    # The serving workload's panel (serving/frontend.py families).
    counters.inc("serving.requests", 40)
    counters.inc("serving.ok", 38)
    counters.inc("serving.errors", 1)
    counters.inc("serving.shed", 1)
    counters.inc("serving.hedge.fired", 3)
    counters.inc("serving.hedge.won", 1)
    counters.inc("serving.hedge.wasted", 2)
    timeseries.gauge("serving.queue.depth", 4)
    timeseries.gauge("serving.inflight", 2)
    timeseries.gauge("serving.breaker.open_nodes", 1)
    timeseries.gauge("slo.min_qps.ok", 1)  # lint: disable=undocumented-metric
    timeseries.gauge("slo.min_qps.value", 38.0)  # lint: disable=undocumented-metric
    # The suspicion panel's inputs: concrete demo instances of the
    # documented anomaly.score.<node> / anomaly.state.<node> gauges
    # (one healthy node, one suspect, one confirmed-grey) plus the
    # verdict-transition counters.
    timeseries.gauge("anomaly.score.n0", 0.3)  # lint: disable=undocumented-metric
    timeseries.gauge("anomaly.state.n0", 0)  # lint: disable=undocumented-metric
    timeseries.gauge("anomaly.score.n1", 2.1)  # lint: disable=undocumented-metric
    timeseries.gauge("anomaly.state.n1", 1)  # lint: disable=undocumented-metric
    timeseries.gauge("anomaly.score.n2", 7.4)  # lint: disable=undocumented-metric
    timeseries.gauge("anomaly.state.n2", 2)  # lint: disable=undocumented-metric
    counters.inc("anomaly.suspect", 2)
    counters.inc("anomaly.confirmed", 1)
    counters.inc("anomaly.cleared", 1)
    # The hotspot panel's input: seeded folded stacks in the process
    # profiler registry — the demo server's /profile serves them.
    profiler.ingest(
        "parallel.dcn_pipeline.send_pipelined;"
        "parallel.dcn_pipeline._shm_round;"
        "parallel.dcn_pipeline._shm_stage", "shm-staging", 46)
    profiler.ingest(
        "parallel.dcn_pipeline.send_pipelined;"
        "parallel.dcn_pipeline._send_worker", "dcn_pipeline", 21)
    profiler.ingest(
        "threading.run;fleet.xferd._serve_data_conn;"
        "fleet.xferd._recv_and_land", "xferd", 12)
    profiler.ingest("threading.run;threading.wait", "idle", 80)

    server = MetricServer(
        collector=_NoGpus(), registry=CollectorRegistry(), port=0,
        pod_resources_socket="/nonexistent-demo.sock",
        collection_interval_s=3600,
    )
    server.start(retry=RetryPolicy(max_attempts=4,
                                   initial_backoff_s=0.05))
    server.collect_once()
    return server


def main(argv=None):
    args = parse_args(argv)
    server = None
    if args.demo:
        server = _demo_server()
        url = f"http://127.0.0.1:{server.port}/metrics"
    else:
        url = args.url or f"http://{args.host}:{args.port}/metrics"
    screen = None
    try:
        while True:
            try:
                body = scrape(url)
                prof = scrape_profile(profile_url(url))
                model = digest(parse_families(body), prof)
                model["trends"] = trend_lines(model)
                screen = render(model, url, args.top)
                banner = ""
            except (urllib.error.URLError, OSError) as e:
                if args.once or screen is None:
                    # No snapshot to fall back on: hard-fail (the CI
                    # contract, and the very first live poll).
                    print(f"scrape of {url} failed: {e}",
                          file=sys.stderr)
                    return 1
                # Live mode keeps watching through a blip — a node
                # struggling enough to miss a scrape is exactly the
                # node the operator must not lose sight of.
                banner = (f"\n\n** scrape failed "
                          f"({time.strftime('%H:%M:%S')}): {e} — "
                          f"showing last snapshot **")
            if args.once:
                print(screen)
                return 0
            # Live mode: repaint in place (clear + home), like top.
            sys.stdout.write("\x1b[2J\x1b[H" + screen + banner + "\n")
            sys.stdout.flush()
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        return 0
    finally:
        if server is not None:
            server.stop()


if __name__ == "__main__":
    raise SystemExit(main())
