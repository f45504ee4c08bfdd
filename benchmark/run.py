"""One run of one benchmark cell on the card it is started on.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Run from the root of a checkout.  The cell, its configuration and its
traffic mix come from ``BENCHMARK.json`` and the files it names (see
``benchmark/README.md``).  Set-up draws the weights and inputs from
``--seed`` and warms every shape the cell uses; the window then
measures for ``--seconds``; after it the plain reference checks what the
window produced.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones from a traced slice after the window.
``--control 1`` also runs the reference in float8 and judges it by the
cell's limits, which it has to fail.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the last lines of standard error repeat the checks.  Without a
card, or with fewer than the cell asks for, or with JAX loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "container_engine_accelerators_tpu")
# The port's kernel builds stay inside the checkout; so would any other
# extension build.
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / ".torch_ext_build")
# One intra-op CPU thread: the serving loop is paced by the host's
# dispatch, and idle OpenMP workers beside it made runs of one seed
# differ by up to 12%.
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [str(BENCH), str(REPO)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    # The program under test, before anything else: a checkout without
    # it fails here.
    import container_engine_accelerators_tpu_torch.models.transformer  # noqa: F401

    from harness import run_cell
    from harness.manifest import Manifest

    manifest = Manifest.load(REPO / "BENCHMARK.json")
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, rec = run_cell(manifest, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START,
                           bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"run: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], **result["device"]}
    result["card"] = power_limit()
    result["counters"] = dict(rec.counters)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
