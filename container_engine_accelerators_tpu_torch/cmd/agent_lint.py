#!/usr/bin/env python3
"""agent_lint — the project-invariant lint gate of the port.

The port's copy of the root `cmd/agent_lint.py`: the same flags, output
and exit codes.  Runs every rule in the port's `analysis/lint.py`
registry over the port's package ASTs (its `cmd/` included) and prints
one `path:line: [rule] message` finding per violation; `--json` emits
the same as a machine-readable blob.

Run: `python -m container_engine_accelerators_tpu_torch.cmd.agent_lint
[PATH ...] [--rules R1,R2] [--json] [--list-rules]`.

Exit-code contract (CI depends on it):
  0  clean — no findings
  1  findings — the printed violations
  2  internal error — unreadable path, syntax error in a linted file,
     or a crash in the engine itself (a broken gate must be
     distinguishable from a failing one)

Suppressions are inline and must name their rule:
    sock.sendall(frame)  # lint: disable=raw-socket-send
"""

import argparse
import json
import os
import sys
import time

from container_engine_accelerators_tpu_torch.analysis import lint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="project-invariant AST lint "
                    "(analysis/lint.py rule registry)")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: the port's "
                             "package)")
    parser.add_argument("--rules", metavar="R1,R2",
                        help="run only these rules")
    parser.add_argument("--readme", metavar="PATH",
                        help="README to check metric names against")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings on stdout")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule registry and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        width = max(len(n) for n in lint.RULES)
        for name, r in sorted(lint.RULES.items()):
            kind = "project" if r.project else "file"
            print(f"{name:<{width}}  [{kind}]  {r.doc}")
        return 0

    # Resolve against the CWD the user typed them in — Config joins
    # non-absolute roots onto the repo root, which would make a
    # cwd-relative path silently lint nothing and exit 0.
    args.paths = [os.path.abspath(p) for p in args.paths]
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"agent_lint: internal error: no such path(s): {missing}",
              file=sys.stderr)
        return 2

    try:
        cfg = lint.Config(
            roots=args.paths or None,
            readme=args.readme,
        )
        rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
                 if args.rules else None)
        if rules:
            unknown = sorted(set(rules) - set(lint.RULES))
            if unknown:
                print(f"agent_lint: unknown rule(s): {unknown} "
                      f"(--list-rules)", file=sys.stderr)
                return 2
        t0 = time.monotonic()
        findings, errors = lint.lint(cfg, rules)
        elapsed = time.monotonic() - t0
    except Exception as e:  # the gate itself broke: exit 2, loudly
        print(f"agent_lint: internal error: {e}", file=sys.stderr)
        return 2

    if errors:
        for err in errors:
            print(f"agent_lint: internal error: {err}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps({
            "findings": [vars(f) for f in findings],
            "elapsed_s": round(elapsed, 3),
        }, indent=2))
    else:
        for f in findings:
            print(str(f))
        print(f"agent_lint: {len(findings)} finding(s) in "
              f"{elapsed:.2f}s", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
