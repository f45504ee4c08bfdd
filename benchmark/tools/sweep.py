"""Run cells several times in a row, each run its own process, and
summarise: the tool for setting bounds and limits.

    python benchmark/tools/sweep.py --out <dir> \\
        --run <cell>:<seconds>:<trace>:<control>:<seed>[,<seed>...] ...

Runs go in the order given.  Each run's result line (or its failure,
with the end of its standard error) is appended to ``<dir>/runs.jsonl``;
standard output gets one short line a run and, for each (cell, trace)
with three runs or more, each metric's median and its spread: the
distance between the first and third quartile (``statistics.quantiles``,
n=4) over the median.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

RUN = Path(__file__).resolve().parents[1] / "run.py"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--run", action="append", default=[])
    p.add_argument("--timeout", type=float, default=1200)
    return p.parse_args(argv)


def spread(values):
    if len(values) < 3:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None):
    args = parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seen = defaultdict(list)
    for spec in args.run:
        cell, seconds, trace, control, seeds = spec.split(":")
        for seed in seeds.split(","):
            cmd = [sys.executable, str(RUN), "--workload", cell, "--seed",
                   seed, "--seconds", seconds, "--trace", trace,
                   "--control", control]
            t = time.perf_counter()
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                rc, stdout, stderr = p.returncode, p.stdout, p.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
                stdout = stdout if isinstance(stdout, str) else stdout.decode()
                stderr = stderr if isinstance(stderr, str) else stderr.decode()
            wall = time.perf_counter() - t
            lines = stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            row = {"cell": cell, "seed": int(seed), "trace": int(trace),
                   "control": int(control), "rc": rc, "wall_s": wall,
                   "result": result,
                   "stderr_tail": stderr[-3000:] if rc or not result
                   else stderr[-600:]}
            with open(out / "runs.jsonl", "a") as f:
                f.write(json.dumps(row) + "\n")
            if result is None:
                print(f"{cell} seed {seed} trace {trace}: rc {rc} "
                      f"{wall:.1f}s\n{stderr[-2500:]}", flush=True)
                continue
            m = {k: v["value"] for k, v in result["metrics"].items()}
            seen[(cell, int(trace))].append(m)
            ck = {k: v["value"] for k, v in result["checks"].items()}
            ctl = {k: v["value"] for k, v in result.get("control", {}).items()}
            print(f"{cell} seed {seed} trace {trace}: rc {rc} {wall:.1f}s "
                  f"correct {result['correct']} att {result['attempted']} "
                  f"fail {result['failed']} peak "
                  f"{result['device'].get('memory_peak_bytes')} "
                  f"busy {result['device'].get('busy_s')} "
                  f"win {result['device'].get('window_s')}\n"
                  f"  metrics {json.dumps(m)}\n  checks {json.dumps(ck)}"
                  + (f"\n  control {json.dumps(ctl)}" if ctl else "")
                  + (f"\n  breakdown {json.dumps(result['breakdown'])}"
                     if "breakdown" in result else ""), flush=True)
    for (cell, trace), runs in seen.items():
        for name in runs[0]:
            vals = [r[name] for r in runs if name in r]
            sp = spread(vals)
            if sp is not None:
                print(f"{cell} trace {trace} {name}: median "
                      f"{statistics.median(vals)!r} spread {sp!r} "
                      f"n {len(vals)}")


if __name__ == "__main__":
    main()
