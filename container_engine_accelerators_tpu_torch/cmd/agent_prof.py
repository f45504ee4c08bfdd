"""agent_prof — merged hotspot attribution from the continuous profiler.

The sampling profiler (obs/profiler.py) aggregates folded stacks in
every agent process and serves them at ``GET /profile`` beside
``/metrics`` and ``/spans``; the fleet aggregator merges per-worker
profiles into the report's ``profile`` section.  This tool renders
either source as a human answer to "where does the CPU go":

- a **table** (default): top-N folded stacks with count, share, and
  subsystem, under a per-subsystem rollup;
- ``--folded``: raw collapsed lines (``stack count``) — pipe straight
  into ``flamegraph.pl`` or any folded-stack tool;
- ``--subsystem``: the rollup alone (the one-glance
  staging-memcpy-vs-socket-IO split).

Sources:
  python -m container_engine_accelerators_tpu_torch.cmd.agent_prof --port 2112              # live /profile scrape
  python -m container_engine_accelerators_tpu_torch.cmd.agent_prof --url http://node:2112/profile
  python -m container_engine_accelerators_tpu_torch.cmd.agent_prof report.json              # fleet report
  python -m container_engine_accelerators_tpu_torch.cmd.agent_prof report.json --node n1    # one worker's merge
  python -m container_engine_accelerators_tpu_torch.cmd.agent_prof a.json b.json --folded   # merge several

A report file is a ``cmd/fleet_sim.py`` report (its ``profile.fleet``
section, or ``profile.nodes[--node]``) or a raw ``/profile`` body;
several sources merge by summing stack counts.  Exit 0 on success
(including an empty profile, which renders as such), 1 when a source
cannot be read or carries no profile section.
"""

import argparse
import json
import sys


from container_engine_accelerators_tpu_torch.obs import profiler


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("files", nargs="*",
                   help="fleet report JSON (profile section) or raw "
                        "/profile bodies; merged when several")
    p.add_argument("--url", default=None,
                   help="full /profile URL (overrides --host/--port)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="scrape http://HOST:PORT/profile live")
    p.add_argument("--node", default=None,
                   help="render one node's entry from a report file "
                        "(default: the fleet-wide merge)")
    p.add_argument("--top", type=int, default=15,
                   help="stack rows in the table")
    p.add_argument("--folded", action="store_true",
                   help="emit collapsed 'stack count' lines for "
                        "flamegraph tools instead of the table")
    p.add_argument("--subsystem", action="store_true",
                   help="emit only the per-subsystem rollup")
    return p.parse_args(argv)


# -- loading -----------------------------------------------------------------


def _normalize(obj: dict):
    """A raw /profile body or a report profile entry -> the one shape
    this tool renders: {samples, dropped, subsystems, stacks}.  The
    report spells its stack list ``top``; the endpoint ``stacks``."""
    stacks = obj.get("stacks", obj.get("top"))
    if not isinstance(stacks, list):
        return None
    return {
        "samples": int(obj.get("samples") or 0),
        "dropped": int(obj.get("dropped") or 0),
        "subsystems": dict(obj.get("subsystems") or {}),
        "stacks": [e for e in stacks
                   if isinstance(e, dict) and "stack" in e],
    }


def load_file(path: str, node=None):
    """One source file -> normalized profile, or a (printed) None.
    Accepts a fleet report (uses its ``profile`` section) or a raw
    ``/profile`` body; a report written as several JSONL lines uses
    the last one (the fleet_sim convention)."""
    try:
        with open(path) as f:
            raw = f.read().strip()
    except OSError as e:
        print(f"cannot read {path}: {e}", file=sys.stderr)
        return None
    obj = None
    for blob in (raw, raw.splitlines()[-1] if raw else ""):
        try:
            obj = json.loads(blob)
            break
        except ValueError:
            continue
    if not isinstance(obj, dict):
        print(f"{path}: not a JSON object", file=sys.stderr)
        return None
    if "profile" in obj and isinstance(obj["profile"], dict):
        section = obj["profile"]
        if node is not None:
            entry = (section.get("nodes") or {}).get(node)
            if entry is None:
                print(f"{path}: no profile entry for node {node!r} "
                      f"(have: "
                      f"{', '.join(sorted(section.get('nodes') or {}))})",
                      file=sys.stderr)
                return None
            obj = entry
        else:
            obj = section.get("fleet", {})
    prof = _normalize(obj)
    if prof is None:
        print(f"{path}: no profile section found", file=sys.stderr)
    return prof


def scrape(url: str, timeout_s: float = 10.0):
    try:
        obj = profiler.fetch(url, timeout_s)
    except (OSError, ValueError) as e:
        print(f"scrape of {url} failed: {e}", file=sys.stderr)
        return None
    prof = _normalize(obj)
    if prof is None:
        print(f"{url}: malformed /profile body", file=sys.stderr)
    return prof


def merge(profiles):
    """Sum several normalized profiles into one (stack counts add;
    one stack keeps the first subsystem it was seen with)."""
    out = {"samples": 0, "dropped": 0, "subsystems": {}, "stacks": {}}
    for prof in profiles:
        out["samples"] += prof["samples"]
        out["dropped"] += prof["dropped"]
        for sub, n in prof["subsystems"].items():
            out["subsystems"][sub] = out["subsystems"].get(sub, 0) + n
        for e in prof["stacks"]:
            cur = out["stacks"].setdefault(
                e["stack"], {"subsystem": e.get("subsystem", "other"),
                             "count": 0})
            cur["count"] += int(e.get("count") or 0)
    out["stacks"] = [
        {"stack": s, "subsystem": m["subsystem"], "count": m["count"]}
        for s, m in sorted(out["stacks"].items(),
                           key=lambda kv: (-kv[1]["count"], kv[0]))
    ]
    return out


# -- rendering ---------------------------------------------------------------


def render_folded(prof, out=None):
    out = out or sys.stdout
    for e in prof["stacks"]:
        out.write(f"{e['stack']} {e['count']}\n")


def render_subsystems(prof, out=None):
    out = out or sys.stdout
    subs = prof["subsystems"] or {}
    if not subs:
        # No rollup on the source (older scrape): derive from stacks.
        for e in prof["stacks"]:
            subs[e["subsystem"]] = subs.get(e["subsystem"], 0) \
                + e["count"]
    total = sum(subs.values())
    busy = sum(n for s, n in subs.items() if s != "idle")
    out.write(f"{'subsystem':<16} {'samples':>9} {'share':>7} "
              f"{'busy%':>7}\n")
    for sub, n in sorted(subs.items(), key=lambda kv: -kv[1]):
        share = n / total if total else 0.0
        busy_share = (n / busy if busy and sub != "idle" else 0.0)
        busy_txt = f"{busy_share * 100:>6.1f}%" if sub != "idle" \
            else "      -"
        out.write(f"{sub:<16} {n:>9} {share * 100:>6.1f}% "
                  f"{busy_txt}\n")


def render_table(prof, top_n, source, out=None):
    out = out or sys.stdout
    out.write(f"agent_prof — {source}\n")
    out.write(f"samples {prof['samples']}  dropped {prof['dropped']}\n")
    out.write("\n")
    render_subsystems(prof, out)
    total = prof["samples"] or sum(e["count"] for e in prof["stacks"])
    rows = prof["stacks"][:max(0, top_n)]
    if rows:
        out.write("\n")
        out.write(f"{'count':>7} {'share':>7} {'subsystem':<14} "
                  f"stack (root;…;leaf)\n")
        for e in rows:
            share = e["count"] / total if total else 0.0
            out.write(f"{e['count']:>7} {share * 100:>6.1f}% "
                      f"{e['subsystem']:<14} {e['stack']}\n")
    else:
        out.write("\n(no stacks sampled yet)\n")


def main(argv=None):
    args = parse_args(argv)
    profiles = []
    source = None
    if args.url or args.port is not None or not args.files:
        url = args.url or (f"http://{args.host}:"
                           f"{args.port or 2112}/profile")
        prof = scrape(url)
        if prof is None:
            return 1
        profiles.append(prof)
        source = url
    for path in args.files:
        prof = load_file(path, node=args.node)
        if prof is None:
            return 1
        profiles.append(prof)
        source = source or path
    if len(args.files) > 1:
        source = f"{len(args.files)} merged sources"
    prof = merge(profiles)
    if args.folded:
        render_folded(prof)
        return 0
    if args.subsystem:
        render_subsystems(prof)
        return 0
    render_table(prof, args.top, source or "profile")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
