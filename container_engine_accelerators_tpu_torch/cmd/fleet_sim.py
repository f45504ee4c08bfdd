#!/usr/bin/env python3
"""Run a fleet chaos scenario and print the per-node / per-link report.

The multi-node companion of the single-node chaos gate: boots N
emulated GPU nodes (GpuManager + health checker + PyXferd daemon + the
production resilient client each), wires every inter-node DCN frame
through the fleet link table, drives the scenario's fault schedule
(rack partitions, link loss/latency, chip faults, daemon kills), and
runs a ring-transfer workload per round until the fleet re-converges —
or doesn't, which is the exit code's job to say.

The port's copy of the root ``cmd/fleet_sim.py``: the same flags, exit
codes and JSON report (host code: no torch).

Usage (``F=container_engine_accelerators_tpu_torch.cmd.fleet_sim``):
  python -m $F                                     # built-in scenario:
                                                   # 4 nodes / 2 racks,
                                                   # rack partition +
                                                   # chip fault, heal,
                                                   # re-converge
  python -m $F --scenario fleet.yaml               # declarative spec
  python -m $F --nodes 6 --racks 3 --rounds 8
  python -m $F --proc                              # process mode: one
                                                   # OS process per
                                                   # node, real SIGKILL
                                                   # + supervised
                                                   # restart, HTTP-
                                                   # scraped telemetry
  python -m $F --trace-file /tmp/fleet.jsonl
                                                   # + the port's agent_trace

Prints human-readable per-node and per-link tables to stderr and one
JSON report line to stdout (the repo's CLI contract, like
agent_trace.py).  Exit code: 0 iff the fleet converged AND every
configured SLO held; 2 when it never re-converged; 3 when it converged
but breached an SLO (`slo:` in the scenario spec, or `--slo KEY=VALUE`
— a lossy fleet that still "works" while delivering a third of its
goodput floor must fail CI, not just dent a dashboard):

  python -m $F --slo min_goodput_bps=4096 \
               --slo p99_leg_ms=500
"""

import argparse
import json
import os
import sys

from container_engine_accelerators_tpu_torch.fleet.controller import (
    DEFAULT_COLLECTIVE_SCENARIO,
    DEFAULT_PROC_SCENARIO,
    DEFAULT_SCENARIO,
    DEFAULT_SERVING_SCENARIO,
    load_scenario,
    run_scenario,
)
from container_engine_accelerators_tpu_torch.fleet.proc import (
    ProcHandshakeError,
)
from container_engine_accelerators_tpu_torch.fleet.telemetry import (
    SLO_KEYS,
)
from container_engine_accelerators_tpu_torch.obs import (
    history,
    trace,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenario", default=None,
                   help="scenario file (JSON, or YAML with .yaml/.yml)")
    p.add_argument("--nodes", type=int, default=None,
                   help="override node count")
    p.add_argument("--racks", type=int, default=None,
                   help="override rack count")
    p.add_argument("--rounds", type=int, default=None,
                   help="override workload rounds")
    p.add_argument("--payload-bytes", type=int, default=None,
                   help="override per-leg payload size")
    p.add_argument("--pipelined", action="store_true",
                   help="run the ring workload over the chunked/striped "
                        "pipelined DCN path (see --chunk-bytes/--stripes)")
    p.add_argument("--chunk-bytes", type=int, default=None,
                   help="pipelined chunk size (default "
                        "TPU_DCN_CHUNK_BYTES or 1 MiB)")
    p.add_argument("--stripes", type=int, default=None,
                   help="pipelined stripe count (default TPU_DCN_STRIPES "
                        "or 2)")
    p.add_argument("--tuned", action="store_true",
                   help="close the loop: the chunk/stripe grid is only "
                        "the base — the per-destination controller "
                        "(parallel/dcn_tune.py) adapts it from the "
                        "legs' own telemetry (implies --pipelined)")
    p.add_argument("--no-shm", action="store_true",
                   help="pin the pipelined legs to the socket lane "
                        "(emulated nodes are same-host, so the "
                        "zero-copy shm lane engages by default; this "
                        "is the fault-parity leg)")
    p.add_argument("--proc", action="store_true",
                   help="process mode: one OS process per node, real "
                        "SIGKILL on scenario kills, supervised restart "
                        "under a bounded budget, telemetry aggregated "
                        "by HTTP scrape of each worker's MetricServer. "
                        "Without --scenario this runs the built-in "
                        "SIGKILL scenario; a worker that never "
                        "completes its handshake exits 2, not a hang")
    p.add_argument("--workload", choices=("ring", "serving",
                                          "collective"),
                   default=None,
                   help="round workload: 'ring' transfer legs "
                        "(default), 'serving' — a ServingFrontend "
                        "spraying batched/hedged requests across the "
                        "fleet (admission control, per-node breakers, "
                        "serving SLOs; without --scenario this runs "
                        "the built-in node-kill serving scenario), or "
                        "'collective' — the topology-aware engine "
                        "synthesizing ring/tree/hierarchical schedules "
                        "from the fleet's comm graph and executing "
                        "them over the DCN plane (without --scenario "
                        "this runs the built-in cross-rack "
                        "degrade-and-heal scenario with its busbw "
                        "recovery floor)")
    p.add_argument("--metrics", action="store_true",
                   help="start a per-node MetricServer (ephemeral ports)")
    p.add_argument("--slo", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="add/override one SLO (repeatable): p99_leg_ms, "
                        "min_goodput_bps, max_retransmit_ratio, "
                        "max_dedup_ratio; breach exits 3")
    p.add_argument("--trace-file", default=None,
                   help="write the run's span JSONL here "
                        "(summarize with the port's cmd.agent_trace)")
    p.add_argument("--trend-gate", action="store_true",
                   help="judge this run's SLO measurements against "
                        "the history ledger baseline "
                        "(TPU_HISTORY_DIR); a regression exits 1 "
                        "(non-convergence/SLO breach still exit 2/3 "
                        "first)")
    return p.parse_args(argv)


def _print_report(report, file=None):
    file = file or sys.stderr
    nodes = report["nodes"]
    print(f"scenario: {report['scenario']}  converged: "
          f"{report['converged']}", file=file)
    width = max([len(n) for n in nodes] + [4])
    print(f"{'node':<{width}} {'rack':>6} {'healthy':>8} {'gen':>4} "
          f"{'legs_ok':>8} {'legs_failed':>12} {'down':>5}", file=file)
    for name, n in sorted(nodes.items()):
        print(f"{name:<{width}} {n['rack']:>6} "
              f"{n['healthy']}/{n['total']:>4} "
              f"{n['daemon_generation']:>4} {n['legs_ok']:>8} "
              f"{n['legs_failed']:>12} {str(n['down']):>5}", file=file)
    links = report["links"]
    if links:
        lw = max(len(k) for k in links)
        print(f"\n{'link':<{lw}} {'tier':>11} {'up':>3} {'frames':>7} "
              f"{'bytes':>9} {'drops':>6} {'dups':>5} {'blocked':>8}",
              file=file)
        for key, s in sorted(links.items()):
            print(f"{key:<{lw}} {s['tier']:>11} "
                  f"{'y' if s['up'] else 'N':>3} {s['frames']:>7} "
                  f"{s['bytes']:>9} {s['drops']:>6} {s['dups']:>5} "
                  f"{s['blocked']:>8}", file=file)
    if report.get("workload") == "collective" and report["rounds"]:
        print(f"\n{'round':>5} {'algorithm':>13} {'ok':>3} "
              f"{'time(ms)':>9} {'busbw(B/s)':>11} {'resynth':>8}",
              file=file)
        for rnd in report["rounds"]:
            for leg in rnd["legs"]:
                if leg.get("workload") != "collective":
                    continue
                print(f"{rnd['round']:>5} {leg['algorithm']:>13} "
                      f"{'y' if leg['ok'] else 'N':>3} "
                      f"{leg['time_ms']:>9.1f} "
                      f"{leg['busbw_bps']:>11.0f} "
                      f"{leg['resynth']:>8}", file=file)
    if report.get("workload") == "serving" and report["rounds"]:
        print(f"\n{'round':>5} {'accepted':>9} {'ok':>5} {'errors':>7} "
              f"{'shed':>5} {'lost':>5}", file=file)
        for rnd in report["rounds"]:
            for leg in rnd["legs"]:
                if leg.get("workload") != "serving":
                    continue
                print(f"{rnd['round']:>5} {leg['accepted']:>9} "
                      f"{leg['ok_requests']:>5} {leg['errors']:>7} "
                      f"{leg['shed']:>5} {leg['lost']:>5}", file=file)
    if report["agent_events_delta"]:
        print(f"\nagent events (delta): "
              f"{report['agent_events_delta']}", file=file)
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
    if args.scenario:
        builtin = load_scenario(args.scenario)
    elif args.workload == "serving":
        builtin = DEFAULT_SERVING_SCENARIO
    elif args.workload == "collective":
        builtin = DEFAULT_COLLECTIVE_SCENARIO
    elif args.proc:
        builtin = DEFAULT_PROC_SCENARIO
    else:
        builtin = DEFAULT_SCENARIO
    scenario = dict(builtin)
    if args.proc:
        scenario["proc"] = True
    if args.workload:
        scenario["workload"] = args.workload
    for key, value in (("nodes", args.nodes), ("racks", args.racks),
                       ("rounds", args.rounds),
                       ("payload_bytes", args.payload_bytes),
                       ("chunk_bytes", args.chunk_bytes),
                       ("stripes", args.stripes)):
        if value is not None:
            scenario[key] = value
    if args.pipelined:
        scenario["pipelined"] = True
    if args.tuned:
        scenario["pipelined"] = True
        scenario["tuned"] = True
    if args.no_shm:
        scenario["shm"] = False
    if args.metrics:
        scenario["metrics"] = True
    if args.slo:
        # A scenario file may carry a malformed slo: section; --slo
        # must still work (the section itself degrades in telemetry).
        # But an --slo the OPERATOR typed is an explicit CI gate: a
        # typo'd key must fail the invocation, not silently evaluate
        # zero checks and exit 0.
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
        report = run_scenario(scenario)
    except ProcHandshakeError as e:
        # A worker that never reported ready: the controller killed
        # and reaped every spawned process; say why and fail —
        # a boot that cannot complete must never hang CI.
        print(f"fleet boot failed: {e}", file=sys.stderr)
        if args.trace_file:
            trace.configure(None)
        return 2

    # Joinability stamps: the stdout report line and the ledger
    # record carry the same run_id.
    report["run_id"] = run_id
    report["version"] = history.repo_version()
    trend_rc = _record_and_trend(report, scenario, args, run_id)
    _print_report(report)
    print(json.dumps(report))
    if args.trace_file:
        trace.configure(None)  # flush/close the sink
    if not report["converged"]:
        return 2
    if not report["slo"]["ok"]:
        return 3
    return trend_rc


def _record_and_trend(report, scenario, args, run_id) -> int:
    """Ledger recording + the --trend-gate verdict, judged against
    PRIOR runs of this same config key (this run is appended after,
    so a regressed run cannot poison its own baseline).  Returns 1 on
    a regression under --trend-gate, else 0; history trouble costs
    the trend layer, never the fleet verdict."""
    ledger = history.RunLedger()
    if not ledger.enabled:
        return 0
    cfg_key = history.config_key(
        "fleet_sim", report.get("scenario"),
        report.get("workload"),
        "proc" if report.get("proc") else "inproc",
        f"n{scenario.get('nodes')}")
    metrics, cpu_attr, phase = history.fleet_report_evidence(report)
    if not metrics:
        return 0
    try:
        prior = ledger.records(kind="fleet_sim", cfg_key=cfg_key)
    except history.LedgerError as e:
        print(f"history ledger unreadable ({e}); trend gate skipped",
              file=sys.stderr)
        return 0
    verdicts = [
        history.trend_verdict(prior, m, v, cpu_attr=cpu_attr,
                              dominant_phase=phase)
        for m, v in sorted(metrics.items())
    ]
    ledger.record("fleet_sim", cfg_key, metrics, run_id=run_id,
                  cpu_attr=cpu_attr, dominant_phase=phase,
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
