"""Summarize a node-agent trace JSONL: where does recovery time go?

The agent-side companion of cmd/trace_summary.py — that tool digests
the profiler traces of a training step; this one digests the span
JSONL a node agent writes when ``TPU_TRACE_FILE`` is set
(obs/trace.py), answering the operational questions a chaos run or a
flapping node raises:

- which ops dominate wall clock (dcn.send vs dcn.replay vs
  health.event), with count / total / mean / p50 / p95 / p99 per name;
- how many spans failed, and which fault sites killed them
  (``attrs.fault`` stamped by utils/faults.py);
- optionally one full trace reconstructed as a parent/child tree
  (``--trace <id>``), e.g. a reconnect with its flow replays nested
  under it;
- ``--exemplar <op-or-trace-id>``: resolve a latency exemplar in one
  hop.  The scrape's ``agent_exemplar{op,bucket,trace}`` row names the
  trace of an op's worst sample; pass the OP name and this finds the
  slowest span of that name in the JSONL and prints its whole trace
  tree (pass the scraped trace id itself and it resolves that id,
  prefix-matching allowed) — metric → trace without grep.
- ``--critical-path <op-or-trace-id>``: where did the wall-clock go?
  Resolves like ``--exemplar`` (an op name picks its slowest span as
  the root; a trace id, prefix ok, picks that trace's longest root),
  then prints the DOMINANT CHAIN root → leaf with per-phase
  percentages, the per-phase self-time rollup of the whole subtree,
  and the root's coverage (how much of its wall-clock the named child
  phases attribute) — obs/critpath.py applied to the JSONL.

Torn evidence is expected input: a SIGKILLed worker routinely leaves a
truncated last JSONL line.  Malformed lines are skipped, COUNTED, and
reported on stderr and in the JSON result in every mode — never a
crash, never silent.

Also accepts flight-recorder dumps (obs/flight.py): a line whose
object carries ``flight_recorder`` contributes its ``spans`` list.

Accepts MULTIPLE JSONL files and merges them before aggregating — the
cross-process story: a fleet run leaves one file per node process, and
a single DCN transfer's trace id spans both sides (the client stamps it
on the control protocol, the daemon stamps it on data-plane frames, the
coordinator exports it via TPU_TRACE_CONTEXT — obs/trace.py).  Merging
then ``--trace <id>`` renders one cross-node tree.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.agent_trace <trace.jsonl> [more.jsonl ...] [--top 20]
                            [--trace ID] [--slowest 5]
Prints one JSON line (machine-readable) after a human table, exactly
like trace_summary.py.
"""

import argparse
import json
import os
import sys
from collections import defaultdict


# Stdlib-only by contract (obs/ is importable without prometheus_client
# or grpc) — this tool still runs in the barest debug container.
from container_engine_accelerators_tpu_torch.obs import critpath


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("paths", nargs="+", metavar="path",
                   help="trace JSONL files (TPU_TRACE_FILE output) or "
                        "flight-recorder dumps; several files (one per "
                        "process) are merged")
    p.add_argument("--top", type=int, default=20,
                   help="span names to show in the table")
    p.add_argument("--slowest", type=int, default=5,
                   help="individually slowest spans to list")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="print this trace id as a span tree instead of "
                        "aggregating")
    p.add_argument("--exemplar", default=None, metavar="OP|TRACE",
                   help="resolve a scraped agent_exemplar to its trace "
                        "tree: an op name picks that op's slowest span; "
                        "a trace id (prefix ok) resolves directly")
    p.add_argument("--critical-path", dest="critical_path",
                   default=None, metavar="OP|TRACE",
                   help="render the dominant chain of one trace with "
                        "per-phase percentages and the subtree's "
                        "self-time rollup (op name = that op's slowest "
                        "span as root; trace id prefix ok)")
    return p.parse_args(argv)


def load_spans(paths):
    """Tolerant reader: skips malformed lines (a crash mid-write must
    not make the evidence unreadable), unwraps flight-recorder blobs,
    merges any number of per-process files (a ``file`` attr-free span
    keeps no origin marker — processes already self-identify via the
    ``node``/``thread`` attrs)."""
    if isinstance(paths, str):  # back-compat: single-path callers
        paths = [paths]
    spans, skipped = [], 0
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if obj.get("flight_recorder"):
                    spans.extend(obj.get("spans", []))
                elif "span" in obj and "name" in obj:
                    spans.append(obj)
                else:
                    skipped += 1
    return spans, skipped


def _pct(ordered, q):
    if not ordered:
        return 0.0
    return ordered[min(len(ordered) - 1, int(len(ordered) * q))]


def aggregate(spans, top=20, slowest=5):
    per_name = defaultdict(list)
    errors = defaultdict(int)
    faults = defaultdict(int)
    for s in spans:
        per_name[s["name"]].append(float(s.get("dur_us", 0.0)))
        if s.get("status") == "error":
            errors[s["name"]] += 1
        fault = (s.get("attrs") or {}).get("fault")
        if fault:
            faults[fault] += 1
    rows = []
    for name, durs in per_name.items():
        durs.sort()
        rows.append({
            "name": name,
            "count": len(durs),
            "errors": errors.get(name, 0),
            "total_ms": round(sum(durs) / 1e3, 3),
            "mean_us": round(sum(durs) / len(durs), 1),
            "p50_us": round(_pct(durs, 0.50), 1),
            "p95_us": round(_pct(durs, 0.95), 1),
            "p99_us": round(_pct(durs, 0.99), 1),
        })
    rows.sort(key=lambda r: -r["total_ms"])
    slow = sorted(spans, key=lambda s: -float(s.get("dur_us", 0.0)))[:slowest]
    return {
        "spans": len(spans),
        "traces": len({s.get("trace") for s in spans}),
        "rows": rows[:top],
        "fault_injections": dict(faults),
        "slowest": [
            {"name": s["name"], "dur_us": s.get("dur_us"),
             "trace": s.get("trace"), "status": s.get("status"),
             "attrs": s.get("attrs", {})}
            for s in slow
        ],
    }


def print_table(summary, file=None):
    file = file or sys.stderr
    rows = summary["rows"]
    width = max([len(r["name"]) for r in rows] + [10])
    print(f"{'span':<{width}} {'count':>7} {'err':>5} {'total_ms':>10} "
          f"{'mean_us':>10} {'p50_us':>10} {'p95_us':>10} {'p99_us':>10}",
          file=file)
    for r in rows:
        print(f"{r['name']:<{width}} {r['count']:>7} {r['errors']:>5} "
              f"{r['total_ms']:>10.3f} {r['mean_us']:>10.1f} "
              f"{r['p50_us']:>10.1f} {r['p95_us']:>10.1f} "
              f"{r['p99_us']:>10.1f}", file=file)
    if summary["fault_injections"]:
        print(f"fault injections: {summary['fault_injections']}", file=file)


def print_tree(spans, trace_id, file=None):
    """One trace as an indented parent/child tree, start-ordered."""
    file = file or sys.stderr
    mine = [s for s in spans if s.get("trace") == trace_id]
    mine.sort(key=lambda s: s.get("ts", 0.0))
    children = defaultdict(list)
    ids = {s["span"] for s in mine}
    roots = []
    for s in mine:
        parent = s.get("parent")
        if parent in ids:
            children[parent].append(s)
        else:
            roots.append(s)  # parent evicted from the ring: treat as root

    def walk(s, depth):
        attrs = s.get("attrs") or {}
        extra = f" {attrs}" if attrs else ""
        mark = " !" if s.get("status") == "error" else ""
        print(f"{'  ' * depth}{s['name']} {s.get('dur_us', 0):.0f}us"
              f"{mark}{extra}", file=file)
        for c in children.get(s["span"], []):
            walk(c, depth + 1)

    for root in roots:
        walk(root, 0)
    return len(mine)


def resolve_exemplar(spans, key):
    """An op name -> its slowest span; a trace id (or unique prefix)
    -> any span of that trace.  None when nothing matches."""
    named = [s for s in spans if s.get("name") == key]
    if named:
        return max(named, key=lambda s: float(s.get("dur_us", 0.0)))
    by_id = [s for s in spans
             if str(s.get("trace", "")).startswith(key)]
    return by_id[0] if by_id else None


def resolve_critpath_root(spans, key):
    """The root span a --critical-path walk starts from: an op name
    picks that op's slowest span (the one whose time needs
    explaining); a trace id (prefix ok) picks that trace's LONGEST
    root span.  None when nothing matches."""
    named = [s for s in spans if s.get("name") == key]
    if named:
        return max(named, key=lambda s: float(s.get("dur_us", 0.0)))
    hit = [s for s in spans
           if str(s.get("trace", "")).startswith(key)]
    if not hit:
        return None
    roots, _children = critpath.build_trees(spans,
                                            hit[0].get("trace"))
    pool = roots or hit
    return max(pool, key=lambda s: float(s.get("dur_us") or 0.0))


def print_critical_path(spans, root, file=None):
    """The dominant chain + per-phase rollup for one root span;
    returns the machine-readable dict main() prints as JSON."""
    file = file or sys.stderr
    trace_id = root.get("trace")
    _roots, children = critpath.build_trees(spans, trace_id)
    chain = critpath.critical_path(root, children)
    rollup_s = critpath.phase_rollup(root, children)
    total_s = sum(rollup_s.values()) or 1e-12
    coverage = chain[0]["coverage"]
    print(f"critical path of trace {trace_id} "
          f"(root {root.get('name')}, "
          f"{float(root.get('dur_us') or 0):.0f}us, "
          f"{coverage * 100:.1f}% attributed to child phases):",
          file=file)
    for depth, hop in enumerate(chain):
        print(f"{'  ' * depth}{hop['name']} {hop['dur_us']:.0f}us "
              f"{hop['pct_of_root']:.1f}% "
              f"(self {hop['self_us']:.0f}us)", file=file)
    print("phase self-time rollup:", file=file)
    for name, sec in sorted(rollup_s.items(), key=lambda kv: -kv[1]):
        print(f"  {name:<28} {sec * 1e3:>10.3f}ms "
              f"{sec / total_s * 100:>5.1f}%", file=file)
    return {
        "trace": trace_id,
        "root": root.get("name"),
        "dur_us": root.get("dur_us"),
        "coverage": coverage,
        "path": chain,
        "phases": {name: round(sec * 1e3, 3)
                   for name, sec in rollup_s.items()},
    }


def main(argv=None):
    args = parse_args(argv)
    spans, skipped = load_spans(args.paths)
    if skipped:
        # Torn last lines are routine after a SIGKILL; say so in every
        # mode — evidence quality is part of the answer.
        print(f"skipped {skipped} malformed line(s) in "
              f"{', '.join(args.paths)}", file=sys.stderr)
    if not spans:
        raise SystemExit(
            f"no spans in {', '.join(args.paths)} ({skipped} bad lines)"
        )
    if args.critical_path:
        root = resolve_critpath_root(spans, args.critical_path)
        if root is None:
            raise SystemExit(
                f"no span named {args.critical_path!r} and no trace "
                f"id matching it in {', '.join(args.paths)}"
            )
        result = print_critical_path(spans, root)
        result["skipped_lines"] = skipped
        print(json.dumps({"critical_path": result}))
        return result
    if args.exemplar:
        hit = resolve_exemplar(spans, args.exemplar)
        if hit is None:
            raise SystemExit(
                f"no span named {args.exemplar!r} and no trace id "
                f"matching it in {', '.join(args.paths)}"
            )
        trace_id = hit.get("trace")
        print(f"exemplar {args.exemplar!r}: worst span "
              f"{hit.get('name')} {float(hit.get('dur_us', 0)):.0f}us "
              f"in trace {trace_id}", file=sys.stderr)
        n = print_tree(spans, trace_id)
        print(json.dumps({"exemplar": args.exemplar, "trace": trace_id,
                          "name": hit.get("name"),
                          "dur_us": hit.get("dur_us"), "spans": n,
                          "skipped_lines": skipped}))
        return
    if args.trace:
        n = print_tree(spans, args.trace)
        print(json.dumps({"trace": args.trace, "spans": n,
                          "skipped_lines": skipped}))
        return
    summary = aggregate(spans, args.top, args.slowest)
    summary["skipped_lines"] = skipped
    print_table(summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
