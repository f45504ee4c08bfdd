"""Trajectory tables and regression verdicts over the history ledger.

The read side of obs/history.py: where the trend gates embedded in
the bench CLIs judge ONE fresh run against its baseline, this tool
walks the whole ledger — every (kind, config key, metric) series —
and renders the trajectory: the recent values, the robust baseline
(median + MAD over the last N), and the latest run's verdict, with
the cpu_attr/critical-path attribution when it regressed.

Usage:
  TPU_HISTORY_DIR=~/.tpu-history python -m container_engine_accelerators_tpu_torch.cmd.agent_trend
  python -m container_engine_accelerators_tpu_torch.cmd.agent_trend --dir ~/.tpu-history --metric p99_e2e_ms
  python -m container_engine_accelerators_tpu_torch.cmd.agent_trend --dir d --attribute     # subsystem-share
                                                    # breakdown per
                                                    # series
  python -m container_engine_accelerators_tpu_torch.cmd.agent_trend --dir d --import BENCH_r0*.json \
                                    --import MULTICHIP_r0*.json

``--import`` seeds the ledger from the repo's committed round-robin
result files: ``BENCH_r0*.json`` (one parsed headline metric per
successful round) and ``MULTICHIP_r0*.json`` (pass/fail per round).
Rounds that failed or carry no parsed metric are skipped with a note,
never a crash, and re-importing the same file is a no-op (records are
keyed by a deterministic ``import-<name>`` run id).

Human tables go to stderr, one JSON summary line to stdout (the repo
CLI contract).  Exit code: 0 when every judged series is inside its
band (or improved); 1 when any latest run REGRESSED past
median ± k·MAD; 2 when the ledger exists but cannot be read (or no
history dir was given at all — nothing to judge is an infra error,
not a clean pass).
"""

import argparse
import json
import os
import sys


from container_engine_accelerators_tpu_torch.obs import history


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--dir", default=None,
                   help="history directory (default TPU_HISTORY_DIR)")
    p.add_argument("--kind", default=None,
                   help="only series of this record kind (dcn_bench, "
                        "fleet_sim, fleet_serving, fleet_soak, ...)")
    p.add_argument("--config-key", default=None,
                   help="only series with this exact config key")
    p.add_argument("--metric", default=None,
                   help="only this metric")
    p.add_argument("--last", type=int, default=history.BASELINE_N,
                   help="baseline window: judge the latest run "
                        "against the previous N comparable runs "
                        f"(default {history.BASELINE_N})")
    p.add_argument("--min-runs", type=int,
                   default=history.MIN_BASELINE_RUNS,
                   help="refuse to judge with fewer prior runs than "
                        "this (default "
                        f"{history.MIN_BASELINE_RUNS})")
    p.add_argument("--k", type=float, default=history.DEFAULT_K,
                   help="band width: regression means the latest run "
                        "sits beyond median +/- k*MAD (default "
                        f"{history.DEFAULT_K})")
    p.add_argument("--attribute", action="store_true",
                   help="print the per-series subsystem-share "
                        "breakdown (cpu_attr points vs baseline "
                        "median, dominant critical-path phase) for "
                        "every judged series, not just regressions")
    p.add_argument("--import", dest="imports", action="append",
                   default=[], metavar="FILE",
                   help="seed the ledger from a BENCH_r0*.json / "
                        "MULTICHIP_r0*.json round file (repeatable); "
                        "unparseable rounds are skipped with a note")
    return p.parse_args(argv)


def import_round_file(ledger, path) -> str:
    """Seed one committed round file into the ledger.  Returns a
    human verdict string: imported / skipped (why).  Idempotent: the
    run id is derived from the file name, and an existing record with
    that id short-circuits."""
    name = os.path.splitext(os.path.basename(path))[0]
    run_id = f"import-{name}"
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as e:
        return f"skipped ({e})"
    if not isinstance(doc, dict):
        return "skipped (not a round record)"
    existing = ledger.records()
    if any(r.get("run_id") == run_id for r in existing):
        return "already imported"
    if "n_devices" in doc:
        # MULTICHIP round: no parsed metric, the evidence is the
        # pass/fail bit itself — a trendable 0/1 series per topology.
        cfg = history.config_key("multichip",
                                 f"n{doc.get('n_devices')}")
        ledger.record("multichip", cfg,
                      {"ok": 1.0 if doc.get("ok") else 0.0},
                      run_id=run_id, version="imported",
                      ts=doc.get("ts"))
        return f"imported (multichip ok={bool(doc.get('ok'))})"
    parsed = doc.get("parsed")
    if doc.get("rc") not in (0, None):
        return f"skipped (rc={doc.get('rc')})"
    if not isinstance(parsed, dict) or "metric" not in parsed \
            or not isinstance(parsed.get("value"), (int, float)):
        return "skipped (no parsed metric)"
    metric = str(parsed["metric"])
    cfg = history.config_key("bench_hw", metric)
    ledger.record("bench_hw", cfg, {metric: float(parsed["value"])},
                  run_id=run_id, version=str(doc.get("commit") or
                                             parsed.get("commit") or
                                             "imported"),
                  ts=parsed.get("ts"))
    return f"imported ({metric}={parsed['value']})"


def _series(records):
    """Group ledger records into {(kind, config_key): [records]} in
    ledger (oldest-first) order."""
    groups = {}
    for r in records:
        key = (r.get("kind") or "?", r.get("config_key") or "?")
        groups.setdefault(key, []).append(r)
    return groups


def _sparkline(values, width=8):
    """The trajectory tail as text: the last few values, oldest
    first, latest last."""
    tail = values[-width:]
    return " ".join(f"{v:g}" for v in tail)


def print_attribution_table(attr, file=None):
    file = file or sys.stderr
    subs = (attr or {}).get("subsystems") or []
    flat = (attr or {}).get("flat") or []
    if subs:
        print(f"    {'subsystem':<14} {'share':>7} {'baseline':>9} "
              f"{'delta':>7}", file=file)
        for m in subs:
            print(f"    {m['subsystem']:<14} "
                  f"{m['share_pts']:>6.1f}% {m['baseline_pts']:>8.1f}% "
                  f"{m['delta_pts']:>+6.1f}p", file=file)
    if flat:
        print(f"    flat: {', '.join(flat)}", file=file)
    phase = (attr or {}).get("dominant_phase")
    prior = (attr or {}).get("prior_dominant_phase")
    if phase and prior and phase != prior:
        print(f"    dominant phase: {phase} (was {prior})", file=file)
    elif phase:
        print(f"    dominant phase: {phase}", file=file)


def main(argv=None):
    args = parse_args(argv)
    root = args.dir or os.environ.get(history.HISTORY_DIR_ENV)
    if not root:
        print("no history directory: pass --dir or set "
              f"{history.HISTORY_DIR_ENV}", file=sys.stderr)
        return 2
    ledger = history.RunLedger(root)
    if not ledger.enabled:
        print(f"history dir {root!r} unusable; nothing to judge",
              file=sys.stderr)
        return 2
    for path in args.imports:
        verdict = import_round_file(ledger, path)
        print(f"import {os.path.basename(path)}: {verdict}",
              file=sys.stderr)
    try:
        records = ledger.records(kind=args.kind,
                                 cfg_key=args.config_key,
                                 metric=args.metric)
    except history.LedgerError as e:
        print(f"ledger unreadable: {e}", file=sys.stderr)
        return 2

    groups = _series(records)
    rows = []
    regressed = []
    header = (f"{'kind':<13} {'config_key':<38} {'metric':<22} "
              f"{'n':>3} {'median':>10} {'latest':>10} {'delta%':>7} "
              f"{'status':<11} trajectory")
    printed_header = False
    for (kind, cfg_key), recs in sorted(groups.items()):
        metrics = sorted({m for r in recs
                          for m in (r.get("metrics") or {})})
        if args.metric:
            metrics = [m for m in metrics if m == args.metric]
        for metric in metrics:
            hits = [r for r in recs
                    if metric in (r.get("metrics") or {})]
            values = [float(r["metrics"][metric]) for r in hits]
            latest = hits[-1]
            v = history.trend_verdict(
                hits[:-1], metric, values[-1], k=args.k,
                min_runs=args.min_runs, n=args.last,
                cpu_attr=latest.get("cpu_attr"),
                dominant_phase=latest.get("dominant_phase"))
            if not printed_header:
                print(header, file=sys.stderr)
                printed_header = True
            med = "-" if v["median"] is None \
                else f"{v['median']:.4g}"
            delta = "-" if v["delta_pct"] is None \
                else f"{v['delta_pct']:+.1f}"
            print(f"{kind:<13} {cfg_key:<38} {metric:<22} "
                  f"{len(values):>3} {med:>10} {values[-1]:>10.4g} "
                  f"{delta:>7} {v['status']:<11} "
                  f"{_sparkline(values)}", file=sys.stderr)
            attr = v.get("attribution")
            if args.attribute and attr is None:
                attr = history.attribute(
                    latest.get("cpu_attr"),
                    latest.get("dominant_phase"), hits[:-1])
            if attr and (args.attribute
                         or v["status"] == "regressed"):
                print_attribution_table(attr)
            row = {"kind": kind, "config_key": cfg_key,
                   "metric": metric, "runs": len(values),
                   "latest": values[-1], "verdict": v}
            rows.append(row)
            if v["status"] == "regressed":
                regressed.append(row)
    if not rows:
        print("history ledger holds no judged series "
              "(empty, or filters matched nothing)", file=sys.stderr)
    for row in regressed:
        print("REGRESSED: " + history.format_verdict(row["verdict"]),
              file=sys.stderr)
    print(json.dumps({
        "history_dir": root,
        "series": rows,
        "regressed": len(regressed),
        "ok": not regressed,
    }))
    return 1 if regressed else 0


if __name__ == "__main__":
    raise SystemExit(main())
