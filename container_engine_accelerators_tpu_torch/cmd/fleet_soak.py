#!/usr/bin/env python3
"""Run the continuous soak world and print the sentinel verdict.

The long-horizon companion of ``cmd/fleet_sim.py``: one proc-mode fleet,
serving + collective + pipelined-exchange traffic CONCURRENTLY every
window, the per-destination tuner and continuous profiler on, faults
drawn from a seeded reproducible schedule (SIGKILL/respawn, grey
slow-not-dead nodes, link latency/drop — each with a scheduled heal),
and the invariant sentinels judging the WHOLE run: counter
monotonicity across worker generations, leak slopes on
fds/threads/shm/rss, tuner convergence after each heal, and the
windowed SLO table.

The port's copy of the root ``cmd/fleet_soak.py``: the same flags,
exit codes and JSON report (host code: no torch).

Usage (``F=container_engine_accelerators_tpu_torch.cmd.fleet_soak``):
  python -m $F                                   # default world,
                                                 # ~45 s wall clock
  python -m $F --duration 20                     # CI-bounded
  python -m $F --duration 14400                  # the actual soak
  python -m $F --seed 99                         # a different chaos
                                                 # tape (same seed =
                                                 # same schedule)
  python -m $F --scenario scenarios/soak_ci.json # declarative spec
  python -m $F --slo max_dedup_ratio=0.5

Prints human-readable window/sentinel tables to stderr and one JSON
report line to stdout (the repo's CLI contract).  Exit code: 0 clean;
2 when the fleet never re-converged; 3 when it converged but an
invariant sentinel or SLO breached — a soak that "works" while
leaking fds must fail CI, not just dent a dashboard.
"""

import argparse
import json
import sys

from container_engine_accelerators_tpu_torch.fleet.controller import (
    load_scenario,
)
from container_engine_accelerators_tpu_torch.fleet.proc import (
    ProcHandshakeError,
)
from container_engine_accelerators_tpu_torch.fleet.soak import (
    exit_code_for,
    run_soak,
)
from container_engine_accelerators_tpu_torch.fleet.telemetry import (
    SLO_KEYS,
)
from container_engine_accelerators_tpu_torch.obs import (
    history,
    trace,
)

# Version stamp for the stdout JSON report line: bump when the report
# shape changes incompatibly (downstream joins records by run_id).
REPORT_SCHEMA_VERSION = 1


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenario", default=None,
                   help="scenario file (JSON, or YAML with .yaml/.yml) "
                        "merged over the built-in soak world")
    p.add_argument("--duration", type=float, default=None,
                   metavar="SECONDS",
                   help="wall-clock budget (default 45; hours for a "
                        "real soak)")
    p.add_argument("--window", type=float, default=None,
                   metavar="SECONDS",
                   help="window cadence: one fault draw + one composed "
                        "traffic burst + one sentinel sample per window "
                        "(default 2)")
    p.add_argument("--seed", type=int, default=None,
                   help="fault-schedule seed; the same seed replays "
                        "the same chaos (default 1234)")
    p.add_argument("--nodes", type=int, default=None,
                   help="override node count")
    p.add_argument("--slo", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="add/override one SLO (repeatable); breach "
                        "exits 3")
    p.add_argument("--trace-file", default=None,
                   help="write the run's span JSONL here "
                        "(summarize with the port's cmd.agent_trace)")
    p.add_argument("--trend-gate", action="store_true",
                   help="judge this run's SLO measurements and leak "
                        "slopes against the history ledger baseline "
                        "(TPU_HISTORY_DIR); a regression exits 1 "
                        "(sentinel/SLO breaches still exit 3 first)")
    p.add_argument("--anomaly-gate", action="store_true",
                   help="judge the grey-failure detector closed-loop "
                        "against the seeded schedule: every seeded "
                        "grey window must be flagged within K windows "
                        "(recall 1.0) with false positives on clean "
                        "windows <= the budget; a miss exits 1 "
                        "(sentinel/SLO breaches still exit 3 first)")
    p.add_argument("--anomaly-fp-budget", type=int, default=2,
                   metavar="N",
                   help="--anomaly-gate false-positive budget: flags "
                        "on windows with no scheduled fault in "
                        "flight (default 2)")
    return p.parse_args(argv)


def _print_report(report, file=None):
    file = file or sys.stderr
    soak = report.get("soak", {})
    sentinels = soak.get("sentinels", {})
    print(f"scenario: {report['scenario']}  seed: {soak.get('seed')}  "
          f"windows: {soak.get('windows')}  "
          f"duration: {soak.get('duration_s')}s  "
          f"converged: {report['converged']}", file=file)
    print(f"chaos: kills={soak.get('kills')} greys={soak.get('greys')} "
          f"heals={soak.get('heals')} "
          f"heal_windows={soak.get('heal_windows')}", file=file)
    anom = report.get("anomaly") or {}
    if anom.get("verdicts"):
        flagged = {e: v for e, v in anom["verdicts"].items()
                   if v["state"] != "healthy"
                   or anom.get("flagged_windows", {}).get(e)}
        print(f"anomaly: enabled={anom.get('enabled')} "
              f"confirmations={len(anom.get('confirmations') or [])} "
              f"flagged={sorted(flagged) or 'none'}", file=file)
    det = anom.get("detection")
    if det:
        print(f"anomaly detection: recall={det['recall']} "
              f"({len(det['detections']) - len(det['missed'])}"
              f"/{det['truth']} within k={det['k']}) "
              f"worst_latency={det['detect_windows_max']:g}w "
              f"false_positives={det['false_positive_count']} "
              f"clean_windows={det['clean_windows']}", file=file)
        for m in det.get("missed", [])[:8]:
            print(f"  missed: {m}", file=file)
        for fp in det.get("false_positives", [])[:8]:
            print(f"  false positive: {fp}", file=file)
    nodes = report["nodes"]
    width = max([len(n) for n in nodes] + [4])
    print(f"\n{'node':<{width}} {'rack':>6} {'healthy':>8} {'gen':>4} "
          f"{'legs_ok':>8} {'legs_failed':>12} {'down':>5}", file=file)
    for name, n in sorted(nodes.items()):
        print(f"{name:<{width}} {n['rack']:>6} "
              f"{n['healthy']}/{n['total']:>4} "
              f"{n['daemon_generation']:>4} {n['legs_ok']:>8} "
              f"{n['legs_failed']:>12} {str(n['down']):>5}", file=file)
    print(f"\n{'sentinel':<14} {'ok':>4}  detail", file=file)
    for key in ("monotonicity", "leaks", "tuner"):
        s = sentinels.get(key, {})
        if key == "monotonicity":
            detail = f"{len(s.get('violations', []))} violation(s)"
        elif key == "leaks":
            detail = f"{len(s.get('breaches', []))} breach(es) over " \
                     f"{len(s.get('series', {}))} series"
        else:
            detail = s.get("reason", "")
        print(f"{key:<14} {'ok' if s.get('ok') else 'FAIL':>4}  "
              f"{detail}", file=file)
    for key in ("monotonicity",):
        for v in sentinels.get(key, {}).get("violations", [])[:8]:
            print(f"  violation: {v}", file=file)
    for b in sentinels.get("leaks", {}).get("breaches", [])[:8]:
        print(f"  leak: {b}", file=file)
    slo = report.get("slo") or {}
    if slo.get("checks"):
        print(f"\n{'slo':<22} {'kind':>8} {'limit':>12} {'value':>12} "
              f"{'ok':>4}", file=file)
        for c in slo["checks"]:
            print(f"{c['slo']:<22} {c['kind']:>8} {c['limit']:>12g} "
                  f"{c['value']:>12g} {'ok' if c['ok'] else 'FAIL':>4}",
                  file=file)


def main(argv=None):
    args = parse_args(argv)
    scenario = {}
    if args.scenario:
        scenario = dict(load_scenario(args.scenario))
    if args.nodes is not None:
        scenario["nodes"] = args.nodes
    if args.slo:
        # An --slo the OPERATOR typed is an explicit CI gate: a typo'd
        # key must fail the invocation, not silently evaluate zero
        # checks and exit 0 (the fleet_sim rule).
        slo = scenario.get("slo")
        slo = dict(slo) if isinstance(slo, dict) else {}
        for entry in args.slo:
            key, sep, value = entry.partition("=")
            if not sep or key not in SLO_KEYS:
                print(f"bad --slo {entry!r}: want KEY=VALUE with KEY "
                      f"one of {', '.join(sorted(SLO_KEYS))}",
                      file=sys.stderr)
                return 2
            slo[key] = value
        scenario["slo"] = slo
    if args.trace_file:
        trace.configure(args.trace_file)

    run_id = history.new_run_id()
    try:
        report = run_soak(scenario or None,
                          duration_s=args.duration,
                          window_s=args.window,
                          seed=args.seed)
    except ProcHandshakeError as e:
        print(f"fleet boot failed: {e}", file=sys.stderr)
        if args.trace_file:
            trace.configure(None)
        return 2

    # Joinability stamps: the stdout report line and the ledger
    # record carry the same run_id.
    report["run_id"] = run_id
    report["version"] = history.repo_version()
    report["schema_version"] = REPORT_SCHEMA_VERSION
    trend_rc = _record_and_trend(report, args, run_id)
    anomaly_rc = _anomaly_gate(report, args)
    _print_report(report)
    print(json.dumps(report))
    if args.trace_file:
        trace.configure(None)  # flush/close the sink
    rc = exit_code_for(report)
    return rc if rc else (trend_rc or anomaly_rc)


def _anomaly_gate(report, args) -> int:
    """The --anomaly-gate verdict: the closed-loop detection judgment
    against the seeded schedule must show recall 1.0 (every seeded
    grey window flagged within K windows of onset) and at most
    --anomaly-fp-budget false positives on clean windows.  A run that
    produced no detection section at all (detector disabled, or no
    grey truth seeded) fails the gate too — a gate that can be
    silently vacuous is no gate."""
    if not args.anomaly_gate:
        return 0
    det = (report.get("anomaly") or {}).get("detection")
    if not det or not det.get("truth"):
        print("anomaly gate: no seeded grey truth was judged "
              "(detector disabled, or the schedule drew no grey "
              "fault) — FAIL", file=sys.stderr)
        return 1
    failures = []
    if det["recall"] < 1.0:
        failures.append(f"recall {det['recall']} < 1.0 "
                        f"(missed: {det['missed']})")
    if det["false_positive_count"] > args.anomaly_fp_budget:
        failures.append(
            f"{det['false_positive_count']} false positive(s) > "
            f"budget {args.anomaly_fp_budget}: "
            f"{det['false_positives']}")
    if failures:
        print("anomaly gate: FAIL — " + "; ".join(failures),
              file=sys.stderr)
        return 1
    print(f"anomaly gate: ok — recall 1.0 over {det['truth']} seeded "
          f"grey window(s), {det['false_positive_count']} false "
          f"positive(s) within budget {args.anomaly_fp_budget}",
          file=sys.stderr)
    return 0


def _record_and_trend(report, args, run_id) -> int:
    """Ledger recording + the --trend-gate verdict.  Verdicts are
    judged against PRIOR runs (this run is appended after), so one
    regressed run cannot poison its own baseline.  Returns the gate's
    exit contribution: 1 on a regression under --trend-gate, else 0.
    History trouble costs the trend layer, never the soak verdict."""
    ledger = history.RunLedger()
    if not ledger.enabled:
        return 0
    soak = report.get("soak") or {}
    cfg_key = (soak.get("history") or {}).get("config_key") \
        or history.config_key("soak", report.get("scenario"))
    metrics, cpu_attr, phase = history.fleet_report_evidence(report)
    slopes = ((soak.get("sentinels") or {}).get("leaks") or {}) \
        .get("max_slopes") or {}
    for metric, slope in slopes.items():
        metrics[f"leak_slope.{metric}"] = float(slope)
    det = (report.get("anomaly") or {}).get("detection")
    if det and det.get("truth"):
        metrics["anomaly.detect_windows_max"] = \
            float(det["detect_windows_max"])
        metrics["anomaly.false_positives"] = \
            float(det["false_positive_count"])
    try:
        prior = ledger.records(kind="fleet_soak", cfg_key=cfg_key)
    except history.LedgerError as e:
        print(f"history ledger unreadable ({e}); trend gate skipped",
              file=sys.stderr)
        return 0
    verdicts = [
        history.trend_verdict(prior, m, v, cpu_attr=cpu_attr,
                              dominant_phase=phase)
        for m, v in sorted(metrics.items())
    ]
    ledger.record("fleet_soak", cfg_key, metrics, run_id=run_id,
                  seed=soak.get("seed"), cpu_attr=cpu_attr,
                  dominant_phase=phase,
                  sentinels={"leak_slopes": slopes},
                  slo=report.get("slo"))
    regressed = [v for v in verdicts if v["status"] == "regressed"]
    for v in verdicts:
        if v["status"] != "no_baseline":
            print("trend: " + history.format_verdict(v),
                  file=sys.stderr)
    report["trend"] = {"config_key": cfg_key, "verdicts": verdicts,
                       "ok": not regressed}
    return 1 if (args.trend_gate and regressed) else 0


if __name__ == "__main__":
    raise SystemExit(main())
