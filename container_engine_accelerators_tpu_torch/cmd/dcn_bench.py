#!/usr/bin/env python3
"""DCN transfer microbench: serial vs pipelined vs shm, size sweep.

Boots two PyXferd daemons on loopback (the protocol-faithful rig the
fleet simulator uses) and drives one-way transfers through the data
planes:

- ``serial``: the classic exchange leg — whole-payload ``put``, rx
  wait, whole-payload ``send``, land wait, base64 control-socket read;
- ``pipelined``: the chunked/striped SOCKET lane — overlapped
  stage+send via ``parallel.dcn_pipeline.send_pipelined`` (shm
  force-disabled) and raw DXR1 read-back;
- ``shm``: the zero-copy same-host lane — memoryview staging into the
  flow's mmap segment + one ``shm_commit``, serial chunk sends, and a
  buffer-reference ``shm_read`` read-back;
- ``memcpy``: the reference series — the same payload copied through
  a staging buffer and back out, no daemons.  This is the ceiling the
  same-host lane is stepping toward; it shares the JSONL so the gap
  is always on record next to the lanes;
- ``ring_socket`` (``--ring-socket``): the universal-ring SOCKET lane
  — descriptors posted to the flow's submission ring, ONE doorbell,
  the daemon's completer driving the sends while the client stages
  chunks straight onto the data socket.  Same wire bytes as
  ``pipelined``; the difference the exposed-comm series must show is
  WHERE the completion wait sits (behind staging, not after it);
- ``producer`` (``--producer``): the overlap-ready producer-fed ring
  lane — chunks pulled from an iterator as the ring round runs, so
  production cost rides inside the completion window instead of in
  front of it (the ``exchange_shard(producer=...)`` path);
- ``tuned`` (``--tuned``): the closed-loop plane — the socket
  pipelined lane with ``parallel/dcn_tune.py`` adapting chunk/stripe
  from its own telemetry across iterations.  With ``--compare`` the
  hand-tuned ``--grid`` static cells are swept at the largest size
  and the tuned series must reach ``--tune-min-ratio`` x the best of
  them, having been told nothing.

One JSONL record per (mode, size) goes to stdout (or ``--out``): flat
keys, one measurement per line, with enough config to reproduce.  The human table goes to stderr.  Each
record carries the mode's **exposed-communication ratio**
(``exposed_ratio``: DCN round-trip time not hidden behind staging,
over total DCN time — obs/critpath.py math recorded live by the data
plane; 1.0 is the serial baseline, ``--compare`` fails if the
pipelined lane does not beat it).  Each transfer runs under a
``bench.xfer`` root span: set ``TPU_TRACE_FILE`` and feed the JSONL to
``python -m container_engine_accelerators_tpu_torch.cmd.agent_trace
--critical-path bench.xfer`` for the per-phase story of the slowest
transfer.  The port's copy of the root ``cmd/dcn_bench.py``: the same
modes, flags, record keys and spans, over the port's daemon and client
(host code: no torch).

Usage (``B=container_engine_accelerators_tpu_torch.cmd.dcn_bench``):
  python -m $B                                     # default sweep
  python -m $B --sizes 65536,4194304 --iters 5
  python -m $B --compare                           # exit non-zero if
                                                   # pipelined < serial
                                                   # OR shm < 1.5x
                                                   # pipelined at the
                                                   # largest size
  python -m $B --chunk-bytes 262144 --stripes 4

Timing note: wall-clock per leg, best-of-N (min) as the headline and
the median alongside — the loopback rig is scheduling-noise-bound, so
min is the honest "cost of the code path" number.  Measure idle.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

from container_engine_accelerators_tpu_torch.fleet.xferd import (
    PyXferd,
)
from container_engine_accelerators_tpu_torch.metrics import (
    counters,
)
from container_engine_accelerators_tpu_torch.obs import (
    history,
    profiler,
    timeseries,
    trace,
)
from container_engine_accelerators_tpu_torch.parallel import (
    dcn,
    dcn_pipeline,
    dcn_tune,
)
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError,
    ResilientDcnXferClient,
)

DEFAULT_SIZES = "65536,262144,1048576,4194304"
# memcpy FIRST: it is the reference the shm series' pct_of_memcpy is
# computed against, so it must be measured before the lanes at each
# size.
MODES = ("memcpy", "serial", "pipelined", "shm")

# The hand-tuned static grids the --tuned --compare gate sweeps at the
# largest size: the closed-loop plane must match the BEST of these
# without being told which one it is.  chunk:stripes pairs.
DEFAULT_GRID = "262144:1,262144:2,1048576:1,1048576:2,1048576:4"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--sizes", default=DEFAULT_SIZES,
                   help="comma-separated payload sizes in bytes")
    p.add_argument("--iters", type=int, default=5,
                   help="iterations per (mode, size); min is reported")
    p.add_argument("--chunk-bytes", type=int, default=None,
                   help="pipelined chunk size (default "
                        "TPU_DCN_CHUNK_BYTES or 1 MiB)")
    p.add_argument("--stripes", type=int, default=None,
                   help="pipelined stripe count (default "
                        "TPU_DCN_STRIPES or 2)")
    p.add_argument("--out", default=None,
                   help="append JSONL here instead of stdout")
    p.add_argument("--compare", action="store_true",
                   help="exit 1 if pipelined throughput falls below "
                        "--min-ratio x serial, or shm below "
                        "--shm-min-ratio x pipelined, at the largest "
                        "size")
    p.add_argument("--min-ratio", type=float, default=1.0,
                   help="the pipelined-vs-serial --compare gate "
                        "(default 1.0: pipelined must not regress "
                        "below serial)")
    p.add_argument("--shm-min-ratio", type=float, default=2.5,
                   help="the shm-vs-pipelined --compare gate (default "
                        "2.5: the rig-measured post-ring/daemon-shm "
                        "floor — the zero-copy plane must be a real "
                        "step, not noise)")
    p.add_argument("--shm-exposed-gate", action="store_true",
                   help="with --compare, additionally fail when the "
                        "shm lane's exposed-comm ratio regresses "
                        "above the socket-pipelined lane's (plus "
                        "--shm-exposed-slack) at the largest size — "
                        "the descriptor-ring handoff must keep hiding "
                        "control time behind staging")
    p.add_argument("--shm-exposed-slack", type=float, default=0.15,
                   help="noise allowance for --shm-exposed-gate")
    p.add_argument("--ring-socket", action="store_true",
                   help="add the 'ring_socket' series: the universal "
                        "submission-ring socket lane (descriptors + "
                        "one doorbell, completer-driven sends)")
    p.add_argument("--producer", action="store_true",
                   help="add the 'producer' series: the producer-fed "
                        "ring lane — chunks pulled from an iterator "
                        "inside the completion window (implies "
                        "--ring-socket cells are comparable)")
    p.add_argument("--ring-exposed-gate", action="store_true",
                   help="fail when the ring_socket lane's exposed-"
                        "comm ratio does not drop below the legacy "
                        "socket pipeline's at the largest size (and, "
                        "with --producer, when the producer-fed "
                        "series does not stay below the stage-then-"
                        "send baseline too) — the ring's whole claim "
                        "is moving the completion wait behind staging")
    p.add_argument("--ring-exposed-slack", type=float, default=0.0,
                   help="noise allowance for --ring-exposed-gate "
                        "(default 0: strictly below the legacy "
                        "pipeline)")
    p.add_argument("--exposed-slack", type=float, default=0.0,
                   help="noise allowance for the pipelined-vs-serial "
                        "exposed-comm gate (default 0: strictly "
                        "below; plumbing-level tests relax it — tiny "
                        "payloads on a loaded host legitimately "
                        "overlap nothing)")
    p.add_argument("--tuned", action="store_true",
                   help="add the closed-loop 'tuned' series (socket "
                        "lane, parallel/dcn_tune.py adapting the grid "
                        "across iterations); with --compare, also "
                        "sweep the --grid static cells at the largest "
                        "size and gate tuned >= --tune-min-ratio x "
                        "the best static grid")
    p.add_argument("--grid", default=DEFAULT_GRID,
                   help="comma-separated chunk:stripes static cells "
                        "for the tuned-vs-static gate")
    p.add_argument("--tune-min-ratio", type=float, default=0.9,
                   help="the tuned-vs-best-static --compare gate "
                        "(default 0.9: the self-tuning plane must "
                        "match the best hand-tuned grid to within "
                        "scheduling noise, with zero knob input)")
    p.add_argument("--tune-warmup", type=int, default=4,
                   help="untimed burn-in transfers per size for the "
                        "tuned series: the controller pays its probes "
                        "there, so best-of-N measures the CONVERGED "
                        "plane (the static cells get no probes to "
                        "pay, so this is the like-for-like framing)")
    p.add_argument("--prof-overhead-gate", action="store_true",
                   help="run ONLY the profiler-overhead comparison: "
                        "paired pipelined transfers at the largest "
                        "size with the sampler off and on "
                        "(TPU_PROF_HZ default rate); exit 1 when the "
                        "sampled series' best throughput falls more "
                        "than --prof-max-overhead below the unsampled "
                        "one (the profiler overhead gate)")
    p.add_argument("--prof-max-overhead", type=float, default=0.05,
                   help="the continuous profiler's throughput budget "
                        "on the pipelined lane (default 0.05 = 5%%)")
    p.add_argument("--trend-gate", action="store_true",
                   help="judge every sweep cell's throughput and "
                        "exposed-comm ratio against the history "
                        "ledger baseline (TPU_HISTORY_DIR); a "
                        "regression exits 1 (the --compare gates "
                        "still fail first)")
    return p.parse_args(argv)


class BenchRig:
    """Two daemons + two resilient clients on loopback."""

    def __init__(self):
        self.workdir = tempfile.mkdtemp(prefix="dcn-bench-")
        # shm=True / ring=True pin the daemons' capabilities
        # regardless of the TPU_DCN_SHM / TPU_DCN_SHM_RING env: the
        # sweep forces the lane per mode (the client cfg side), so the
        # daemons must always OFFER them or a kill-switched
        # environment would crash the shm/ring modes instead of
        # benching them.
        self.a = PyXferd(os.path.join(self.workdir, "a"),
                         node="bench-a", shm=True, ring=True).start()
        self.b = PyXferd(os.path.join(self.workdir, "b"),
                         node="bench-b", shm=True, ring=True).start()
        self.ca = ResilientDcnXferClient(os.path.join(self.workdir, "a"))
        self.cb = ResilientDcnXferClient(os.path.join(self.workdir, "b"))
        self._n = 0
        # memcpy reference staging buffer, reused across iterations
        # (sized up on demand) — the reference measures copies, not
        # allocator behavior.
        self._ref = bytearray(0)

    def close(self):
        for c in (self.ca, self.cb):
            try:
                c.close()
            except OSError:
                pass
        self.a.stop()
        self.b.stop()
        shutil.rmtree(self.workdir, ignore_errors=True)

    def open_flow(self, mode: str, nbytes: int) -> dict:
        """Register the reusable flow for one (mode, size) cell.

        Flows are reused ACROSS iterations of a cell — the same
        measurement discipline as the memcpy reference's reused
        staging buffer: best-of-N measures the cost of the code path,
        not cold-mmap page faults and allocator behavior the first
        transfer on any real flow pays once.  Staleness cannot hide:
        every iteration sends a DIFFERENT payload and waits on the
        flow's CUMULATIVE rx accounting before reading it back."""
        self._n += 1
        flow = f"bench-{mode}-{self._n}"
        self.cb.register_flow(flow, peer="bench-a", bytes=nbytes)
        self.ca.register_flow(flow, peer="bench-b", bytes=nbytes)
        if mode == "shm":
            # Pre-attach the landing flow (what exchange_shard does):
            # peer chunks assemble straight into the mmap.
            self.cb.shm_attach(flow, nbytes)
        return {"flow": flow, "rx": 0}

    def close_flow(self, state: dict) -> None:
        for client in (self.ca, self.cb):
            try:
                client.release_flow(state["flow"])
            except (DcnXferError, OSError):
                pass  # bench teardown: next cell gets fresh flows

    def one_way(self, mode: str, payload: bytes,
                cfg: dcn_pipeline.PipelineConfig,
                state: dict = None) -> dict:
        """One timed transfer a->b; returns ``{elapsed_s,
        exposed_ratio}`` (``exposed_ratio`` None for memcpy — there is
        no communication to expose).  Verifies the landed bytes — a
        bench that measures corrupt transfers fast would be worse than
        no bench.  Each transfer runs under one ``bench.xfer`` root
        span, so a TPU_TRACE_FILE run feeds straight into
        ``agent_trace --critical-path bench.xfer``."""
        n = len(payload)
        if mode == "memcpy":
            # The zero-copy ceiling: stage copy in + read copy out,
            # nothing else.  Same verify as the real lanes.
            if len(self._ref) < n:
                self._ref = bytearray(n)
            t0 = time.perf_counter()
            self._ref[:n] = payload
            got = bytes(memoryview(self._ref)[:n])
            elapsed = time.perf_counter() - t0
            if got != payload:
                raise RuntimeError("memcpy reference mismatch")
            return {"elapsed_s": elapsed, "exposed_ratio": None}
        own = state is None
        if own:
            state = self.open_flow(mode, n)
        flow = state["flow"]
        # Cumulative landed bytes this flow must show before the
        # read-back: a reader can never be satisfied by a PREVIOUS
        # iteration's frame (rx accounting only ever grows).
        state["rx"] += n
        exposed_ratio = None
        # Ring ridership pin: the ring modes must actually ride the
        # submission ring — a silent fallback to the classic per-chunk
        # path would bench the wrong plane under the right label.
        ring_mode = mode in ("ring_socket", "producer")
        rounds0 = (counters.get("dcn.ring.socket.rounds")
                   if ring_mode else 0)
        try:
            t0 = time.perf_counter()
            with trace.span("bench.xfer", mode=mode, bytes=n):
                if mode == "serial":
                    self.ca.put(flow, payload)
                    dcn.wait_flow_rx(self.ca, flow, state["rx"],
                                     timeout_s=30)
                    # direct=0: the serial baseline measures the TCP
                    # path — without the pin the daemon would take
                    # the daemon↔daemon segment lane on this rig and
                    # the serial column would mislabel what it ran.
                    self.ca.send(flow, "127.0.0.1", self.b.data_port,
                                 n, direct=0)
                    dcn.wait_flow_rx(self.cb, flow, state["rx"],
                                     timeout_s=30)
                    # The serial shape overlaps nothing with its
                    # send+land leg: its exposed ratio is 1.0 by
                    # construction — the baseline the gate compares
                    # the pipelined lane against.
                    exposed_ratio = 1.0
                    got = self.cb.read(flow, n)
                else:
                    if mode == "producer":
                        # Producer-fed ring round: chunks pulled from
                        # the iterator as the round runs — the
                        # exchange_shard(producer=...) shape, minus
                        # the collective bookkeeping.
                        def _chunks(src=payload, step=cfg.chunk_bytes):
                            for off in range(0, len(src), step):
                                yield src[off:off + step]
                        res = dcn_pipeline.send_pipelined(
                            self.ca, flow, None, "127.0.0.1",
                            self.b.data_port, cfg, timeout_s=30,
                            producer=_chunks(), nbytes=n)
                    else:
                        res = dcn_pipeline.send_pipelined(
                            self.ca, flow, payload, "127.0.0.1",
                            self.b.data_port, cfg, timeout_s=30)
                    # The live accounting's verdict for THIS transfer
                    # (send_pipelined just set the gauge).
                    exposed_ratio = timeseries.gauges().get(
                        "dcn.exposed_ratio")
                    # Settle on cumulative rx BEFORE the frame-wait
                    # read: on a reused flow, this iteration's bytes
                    # must have landed — last iteration's completed
                    # frame can never satisfy the read.
                    dcn.wait_flow_rx(self.cb, flow, state["rx"],
                                     timeout_s=30)
                    got = dcn_pipeline.read_pipelined(
                        self.cb, flow, n, cfg, timeout_s=30)
                    want = "shm" if mode == "shm" else "socket"
                    if res.get("lane") != want:
                        raise RuntimeError(
                            f"mode {mode} ran on lane "
                            f"{res.get('lane')!r} — the bench must "
                            "measure the lane it says"
                        )
                    if ring_mode and counters.get(
                            "dcn.ring.socket.rounds") <= rounds0:
                        raise RuntimeError(
                            f"mode {mode} fell back off the "
                            "submission ring — the bench must "
                            "measure the lane it says"
                        )
            elapsed = time.perf_counter() - t0
            if got != payload:
                raise RuntimeError(
                    f"payload mismatch on {flow} ({mode}, {n} bytes)"
                )
            return {"elapsed_s": elapsed,
                    "exposed_ratio": exposed_ratio}
        finally:
            if own:
                self.close_flow(state)


def run_sweep(sizes, iters, cfg, sink, table=sys.stderr,
              modes=MODES, rig=None, tune_warmup=0, run_id=None,
              version=None):
    """Returns ``(best_mbps, exposed, cells)`` — the first two keyed
    by (mode, size), the third the per-cell JSONL record dicts in
    sweep order — after writing one JSONL record per cell to
    ``sink``."""
    own_rig = rig is None
    rig = rig or BenchRig()
    # The socket-pipelined and shm lanes must be measured apart, so
    # the sweep forces the lane per mode instead of trusting env —
    # including the DAEMON-side peer leg: the socket series pins
    # ``direct: 0`` on every send op so its bytes genuinely cross
    # TCP, while the shm series lets the daemon take the
    # daemon↔daemon segment lane.
    # ring=False pins the LEGACY per-chunk socket pipeline — the
    # stage-then-send baseline the ring series is judged against.
    # Without the pin the universal ring (default on) would quietly
    # turn the "pipelined" column into a second ring series and the
    # ring-vs-legacy comparison would measure nothing.
    cfg_socket = dcn_pipeline.PipelineConfig(
        chunk_bytes=cfg.chunk_bytes, stripes=cfg.stripes, shm=False,
        tuned=False, shm_direct=False, ring=False)
    cfg_ring = dcn_pipeline.PipelineConfig(
        chunk_bytes=cfg.chunk_bytes, stripes=cfg.stripes, shm=False,
        tuned=False, shm_direct=False, ring=True)
    cfg_shm = dcn_pipeline.PipelineConfig(
        chunk_bytes=cfg.chunk_bytes, stripes=cfg.stripes, shm=True,
        tuned=False, shm_direct=True)
    # The closed-loop series: same base grid, socket lane, the
    # per-destination controller adapting across iterations (its
    # learning is the point — iteration 1 pays the probes, best-of-N
    # reports the converged plane, the measurement discipline this
    # rig's noise demands anyway).
    cfg_tuned = dcn_pipeline.PipelineConfig(
        chunk_bytes=cfg.chunk_bytes, stripes=cfg.stripes, shm=False,
        tuned=True, shm_direct=False)
    results = {}
    exposed = {}
    cells = []
    try:
        print(f"{'bytes':>9} {'mode':>10} {'best_ms':>9} {'med_ms':>9} "
              f"{'best_MB/s':>10} {'exposed':>8} {'%memcpy':>8} "
              f"{'hot':>14}",
              file=table)
        for size in sizes:
            base = bytes(range(256)) * (size // 256) \
                + b"\x7f" * (size % 256)
            # A DIFFERENT payload per iteration (byte rotation): with
            # per-cell flow reuse, a stale read-back of last
            # iteration's frame would verify-fail instead of silently
            # passing.
            def rotated(i):
                k = (i * 977) % size if size else 0
                return base[k:] + base[:k] if k else base
            for mode in modes:
                mode_cfg = (cfg_shm if mode == "shm"
                            else cfg_tuned if mode == "tuned"
                            else cfg_ring if mode in ("ring_socket",
                                                      "producer")
                            else cfg_socket)
                state = (None if mode == "memcpy"
                         else rig.open_flow(mode, size))
                try:
                    if mode == "tuned":
                        for w in range(tune_warmup):
                            rig.one_way(mode, rotated(w + 1),
                                        mode_cfg, state)
                    # Per-cell CPU attribution: the profiler's
                    # subsystem counts before/after the cell's TIMED
                    # iterations — which code (staging memcpy vs
                    # socket IO vs ring poll) burned this cell's
                    # cycles.  Snapshot AFTER the tuned warmup, so
                    # probe rounds never pollute the converged
                    # plane's attribution.
                    prof0 = profiler.snapshot(top=0)["subsystems"]
                    runs = [rig.one_way(mode, rotated(i), mode_cfg,
                                        state)
                            for i in range(iters)]
                finally:
                    if state is not None:
                        rig.close_flow(state)
                shares = profiler.subsystem_shares(baseline=prof0)
                cpu_attr = ({k: round(v, 3)
                             for k, v in sorted(shares.items(),
                                                key=lambda kv:
                                                -kv[1])}
                            if shares else None)
                hot = next(iter(cpu_attr), None) if cpu_attr else None
                times = [r["elapsed_s"] for r in runs]
                ratios = [r["exposed_ratio"] for r in runs
                          if r["exposed_ratio"] is not None]
                best = min(times)
                med = statistics.median(times)
                mbps = size / best / 1e6
                results[(mode, size)] = mbps
                # Exposed-communication series (obs/critpath.py math,
                # recorded live by the data plane): median across
                # iterations — 1.0 = fully exposed (the serial
                # shape), lower = the stage/send overlap hid DCN time.
                exp_ratio = (round(statistics.median(ratios), 4)
                             if ratios else None)
                exposed[(mode, size)] = exp_ratio
                # Distance to the ceiling: this mode's best against
                # the memcpy reference at the same size (memcpy runs
                # FIRST per size, so the reference always exists).
                ref = results.get(("memcpy", size))
                pct = (round(mbps / ref * 100, 2)
                       if ref and mode != "memcpy" else None)
                record = {
                    "bench": "dcn_xfer",
                    "run_id": run_id,
                    "version": version,
                    "mode": mode,
                    "bytes": size,
                    "iters": iters,
                    "best_s": round(best, 6),
                    "median_s": round(med, 6),
                    "mbps": round(mbps, 2),
                    "exposed_ratio": exp_ratio,
                    "pct_of_memcpy": pct,
                    "cpu_attr": cpu_attr,
                    "chunk_bytes": cfg.chunk_bytes,
                    "stripes": cfg.stripes,
                    "ts": round(time.time(), 3),
                }
                sink.write(json.dumps(record) + "\n")
                sink.flush()
                cells.append(record)
                exp_txt = ("-" if exp_ratio is None
                           else f"{exp_ratio:.2f}")
                pct_txt = "-" if pct is None else f"{pct:.1f}%"
                hot_txt = ("-" if hot is None
                           else f"{hot} {cpu_attr[hot] * 100:.0f}%")
                print(f"{size:>9} {mode:>10} {best * 1e3:>9.1f} "
                      f"{med * 1e3:>9.1f} {mbps:>10.1f} "
                      f"{exp_txt:>8} {pct_txt:>8} {hot_txt:>14}",
                      file=table)
    finally:
        if own_rig:
            rig.close()
    return results, exposed, cells


def parse_grid(spec: str):
    """``chunk:stripes,...`` -> [(chunk, stripes)]; malformed cells
    are logged and skipped (the TPU_FAULT_SPEC rule), an empty grid is
    the caller's problem to surface."""
    cells = []
    for cell in spec.split(","):
        cell = cell.strip()
        if not cell:
            continue
        try:
            chunk_s, _, stripes_s = cell.partition(":")
            chunk, stripes = int(chunk_s), int(stripes_s)
            if chunk <= 0 or stripes <= 0:
                raise ValueError("must be positive")
            cells.append((chunk, stripes))
        except ValueError as e:
            print(f"ignoring malformed --grid cell {cell!r}: {e}",
                  file=sys.stderr)
    return cells


def run_static_grid(rig, size, iters, grid, base_cfg, sink,
                    table=sys.stderr, run_id=None, version=None):
    """The hand-tuned competition, measured PAIRED: each iteration
    runs every static (chunk, stripes) cell AND one tuned transfer
    back to back, so environment drift (a loaded host, a noisy
    neighbor) hits every series equally — comparing a tuned series
    against grid cells measured minutes apart would just measure the
    drift.  Returns ``({(chunk, stripes): best_mbps}, tuned_mbps)``
    with one JSONL record per grid cell."""
    payload = bytes(range(256)) * (size // 256) + b"\x7f" * (size % 256)
    cell_cfgs = {
        (chunk, stripes): dcn_pipeline.PipelineConfig(
            chunk_bytes=chunk, stripes=stripes, shm=False, tuned=False,
            shm_direct=False)
        for chunk, stripes in grid
    }
    tuned_cfg = dcn_pipeline.PipelineConfig(
        chunk_bytes=base_cfg.chunk_bytes, stripes=base_cfg.stripes,
        shm=False, tuned=True, shm_direct=False)
    times = {cell: [] for cell in cell_cfgs}
    tuned_times = []
    for _ in range(iters):
        for cell, cell_cfg in cell_cfgs.items():
            times[cell].append(
                rig.one_way("pipelined", payload, cell_cfg)
                ["elapsed_s"])
        # Two tuned draws per iteration: "best static" is a MAX over
        # cells of min-of-N — a single tuned series needs more draws
        # for its own min to stand against that selection bias, and
        # the extra transfers double the controller's in-phase
        # observations.
        for _ in range(2):
            tuned_times.append(
                rig.one_way("tuned", payload, tuned_cfg)["elapsed_s"])
    out = {}
    for (chunk, stripes), cell_times in times.items():
        best = min(cell_times)
        mbps = size / best / 1e6
        out[(chunk, stripes)] = mbps
        sink.write(json.dumps({
            "bench": "dcn_xfer_grid",
            "run_id": run_id,
            "version": version,
            "mode": "static",
            "bytes": size,
            "iters": iters,
            "chunk_bytes": chunk,
            "stripes": stripes,
            "best_s": round(best, 6),
            "mbps": round(mbps, 2),
            "ts": round(time.time(), 3),
        }) + "\n")
        sink.flush()
        print(f"{size:>9} {'grid':>10} {best * 1e3:>9.1f} "
              f"{'':>9} {mbps:>10.1f} {chunk // 1024:>5}K/{stripes}",
              file=table)
    tuned_mbps = size / min(tuned_times) / 1e6
    print(f"{size:>9} {'tuned*':>10} {min(tuned_times) * 1e3:>9.1f} "
          f"{'':>9} {tuned_mbps:>10.1f} {'paired':>8}", file=table)
    return out, tuned_mbps


def run_prof_overhead_gate(rig, size, iters, cfg, max_overhead,
                           table=sys.stderr):
    """The profiler overhead gate: paired pipelined transfers at
    one size, alternating sampler-off / sampler-on every iteration so
    environment drift hits both series equally (the run_static_grid
    discipline).  Best-of-N throughput with the sampler ON must stay
    within ``max_overhead`` of OFF — the always-on profiler must be
    observably free on the hot path, not assumed free.  The sampler's
    own cumulative accounting (``prof.overhead_ratio``) is printed
    beside the verdict and gated under the same budget."""
    base = bytes(range(256)) * (size // 256) + b"\x7f" * (size % 256)

    def rotated(i):
        k = (i * 977) % size if size else 0
        return base[k:] + base[:k] if k else base

    cfg_socket = dcn_pipeline.PipelineConfig(
        chunk_bytes=cfg.chunk_bytes, stripes=cfg.stripes, shm=False,
        tuned=False, shm_direct=False)
    def measure():
        state = rig.open_flow("pipelined", size)
        off_times, on_times = [], []
        try:
            # Untimed warmups: the first transfers on a fresh flow
            # pay cold-start costs (mmap faults, allocator growth,
            # TCP window ramp) neither series should carry.
            for w in range(3):
                rig.one_way("pipelined", rotated(w), cfg_socket,
                            state)
            for i in range(iters):
                profiler.stop()
                off_times.append(rig.one_way(
                    "pipelined", rotated(2 * i + 3), cfg_socket,
                    state)["elapsed_s"])
                profiler.start()
                on_times.append(rig.one_way(
                    "pipelined", rotated(2 * i + 4), cfg_socket,
                    state)["elapsed_s"])
        finally:
            rig.close_flow(state)
        best_over = min(on_times) / min(off_times) - 1.0
        med_over = (statistics.median(on_times)
                    / statistics.median(off_times) - 1.0)
        print(f"profiler overhead @ {size} bytes ({iters} paired): "
              f"best {min(off_times) * 1e3:.1f} -> "
              f"{min(on_times) * 1e3:.1f} ms "
              f"({best_over * 100:+.2f}%), median "
              f"{statistics.median(off_times) * 1e3:.1f} -> "
              f"{statistics.median(on_times) * 1e3:.1f} ms "
              f"({med_over * 100:+.2f}%), budget "
              f"{max_overhead * 100:.0f}%", file=table)
        # A real sampler regression shifts the whole distribution;
        # one noisy draw shifts a single statistic.  Breach = best
        # AND median both over budget.
        return best_over > max_overhead and med_over > max_overhead

    rc = 0
    # Breach must REPRODUCE (one retry, the scrape discipline): a
    # loaded host's one noisy window cannot fail CI; a sampler
    # that genuinely costs > budget breaches every window.
    if measure() and measure():
        print(f"FAIL: sampler throughput cost over the "
              f"{max_overhead * 100:.0f}% budget in both paired "
              f"windows", file=table)
        rc = 1
    self_ratio = profiler.snapshot(top=0)["overhead_ratio"]
    print(f"sampler self-accounting: "
          f"{(self_ratio or 0.0) * 100:.3f}% of wall time",
          file=table)
    if self_ratio is not None and self_ratio > max_overhead:
        print(f"FAIL: prof.overhead_ratio {self_ratio:.4f} over the "
              f"{max_overhead:.2f} budget", file=table)
        rc = 1
    return rc


def main(argv=None):
    args = parse_args(argv)
    sizes = sorted({int(s) for s in args.sizes.split(",") if s})
    if not sizes:
        print("no sizes to sweep", file=sys.stderr)
        return 2
    cfg = dcn_pipeline.PipelineConfig(chunk_bytes=args.chunk_bytes,
                                      stripes=args.stripes)
    modes = MODES
    if args.ring_socket or args.ring_exposed_gate:
        # The gate needs the ring series; asking for it implies it.
        modes = modes + ("ring_socket",)
    if args.producer:
        modes = modes + ("producer",)
    if args.tuned:
        modes = modes + ("tuned",)
    # Fresh controller state per bench run: a prior run's learned grid
    # must not flatter (or sandbag) this one's tuned series.
    dcn_tune.reset()
    if args.prof_overhead_gate:
        if not profiler.enabled():
            print("TPU_PROF=0: profiler disabled; overhead gate is "
                  "vacuous", file=sys.stderr)
            return 0
        rig = BenchRig()
        try:
            return run_prof_overhead_gate(
                rig, sizes[-1], max(1, args.iters), cfg,
                args.prof_max_overhead)
        finally:
            rig.close()
    # Always-on CPU attribution for the sweep (TPU_PROF=0 disables):
    # every JSONL cell carries its per-subsystem sample shares.
    profiler.start()
    out = open(args.out, "a") if args.out else sys.stdout
    largest = sizes[-1]
    grid_best = None
    # Joinability stamps: every JSONL record from this invocation
    # (sweep cells AND grid cells) carries the same run_id, which is
    # also the ledger record's key.
    run_id = history.new_run_id()
    version = history.repo_version()
    rig = BenchRig()
    try:
        results, exposed, cells = run_sweep(
            sizes, max(1, args.iters), cfg, out, modes=modes, rig=rig,
            tune_warmup=max(0, args.tune_warmup), run_id=run_id,
            version=version)
        tuned_gate_mbps = None
        if args.tuned and args.compare:
            grid = parse_grid(args.grid)
            if not grid:
                print("empty --grid: nothing to compare the tuned "
                      "plane against", file=sys.stderr)
                return 2
            grid_best, tuned_gate_mbps = run_static_grid(
                rig, largest, max(1, args.iters), grid, cfg, out,
                run_id=run_id, version=version)
    finally:
        rig.close()
        if args.out:
            out.close()
    serial = results[("serial", largest)]
    pipelined = results[("pipelined", largest)]
    shm = results[("shm", largest)]
    memcpy = results[("memcpy", largest)]
    ratio = pipelined / serial if serial else float("inf")
    shm_ratio = shm / pipelined if pipelined else float("inf")
    shm_pct = shm / memcpy * 100 if memcpy else 0.0
    exp_serial = exposed.get(("serial", largest))
    exp_pipe = exposed.get(("pipelined", largest))
    exp_shm = exposed.get(("shm", largest))
    print(f"largest size {largest}: pipelined/serial = {ratio:.2f}x, "
          f"shm/pipelined = {shm_ratio:.2f}x, shm pct_of_memcpy = "
          f"{shm_pct:.1f}%, exposed-comm pipelined {exp_pipe} / shm "
          f"{exp_shm} vs serial {exp_serial}",
          file=sys.stderr)
    rc = 0
    if args.compare and ratio < args.min_ratio:
        print(f"FAIL: pipelined fell below {args.min_ratio:.2f}x "
              f"serial at {largest} bytes", file=sys.stderr)
        rc = 1
    if args.compare and shm_ratio < args.shm_min_ratio:
        print(f"FAIL: shm lane fell below {args.shm_min_ratio:.2f}x "
              f"pipelined at {largest} bytes", file=sys.stderr)
        rc = 1
    if args.compare:
        # The overlap gate: the pipelined lane must HIDE some of its
        # DCN time behind staging — an exposed-comm ratio at or above
        # the serial baseline (1.0) means the phase overlap the lane
        # exists for silently stopped happening.
        if exp_pipe is None or exp_serial is None \
                or exp_pipe >= exp_serial + args.exposed_slack:
            print(f"FAIL: pipelined exposed-comm ratio ({exp_pipe}) "
                  f"is not below serial's ({exp_serial}) at "
                  f"{largest} bytes", file=sys.stderr)
            rc = 1
    if args.ring_exposed_gate:
        # The universal-ring gate: moving the completion wait behind
        # staging is the ring's whole point — the ring_socket lane's
        # exposed-comm ratio must DROP below the legacy per-chunk
        # pipeline's at the largest size, and the producer-fed series
        # must stay below the stage-then-send baseline too.
        exp_ring = exposed.get(("ring_socket", largest))
        print(f"ring lanes @ {largest}: ring_socket exposed "
              f"{exp_ring} vs legacy pipelined {exp_pipe}",
              file=sys.stderr)
        if exp_ring is None or exp_pipe is None \
                or exp_ring >= exp_pipe + args.ring_exposed_slack:
            print(f"FAIL: ring_socket exposed-comm ratio ({exp_ring}) "
                  f"did not drop below the legacy pipeline's "
                  f"({exp_pipe}) at {largest} bytes", file=sys.stderr)
            rc = 1
        if args.producer:
            exp_prod = exposed.get(("producer", largest))
            print(f"ring lanes @ {largest}: producer exposed "
                  f"{exp_prod} vs legacy pipelined {exp_pipe}",
                  file=sys.stderr)
            if exp_prod is None or exp_pipe is None \
                    or exp_prod >= exp_pipe + args.ring_exposed_slack:
                print(f"FAIL: producer-fed exposed-comm ratio "
                      f"({exp_prod}) did not stay below the "
                      f"stage-then-send baseline ({exp_pipe}) at "
                      f"{largest} bytes", file=sys.stderr)
                rc = 1
    if args.compare and args.shm_exposed_gate:
        # The handoff gate: the descriptor-ring shm lane posts its
        # doorbell BEFORE staging, so its completion window rides
        # behind the memcpy — its exposed ratio must not regress
        # above the socket-pipelined lane's (within noise slack).
        if exp_shm is None or exp_pipe is None \
                or exp_shm > exp_pipe + args.shm_exposed_slack:
            print(f"FAIL: shm exposed-comm ratio ({exp_shm}) "
                  f"regressed above pipelined's ({exp_pipe}) + "
                  f"{args.shm_exposed_slack:.2f} slack at "
                  f"{largest} bytes", file=sys.stderr)
            rc = 1
    if grid_best is not None:
        # The self-tuning gate: the closed-loop plane, starting from
        # the default grid with ZERO knob input, must match the best
        # hand-tuned static cell (to within --tune-min-ratio of
        # scheduling noise) at the largest size.  Judged on the PAIRED
        # measurements from run_static_grid, not the sweep series —
        # the sweep's tuned cell ran minutes before the grid cells.
        best_cell = max(grid_best, key=grid_best.get)
        best_mbps = grid_best[best_cell]
        tuned_mbps = tuned_gate_mbps
        ratio = tuned_mbps / best_mbps if best_mbps else float("inf")
        print(f"tuned plane {tuned_mbps:.1f} MB/s vs best static grid "
              f"{best_mbps:.1f} MB/s (chunk={best_cell[0]}, "
              f"stripes={best_cell[1]}): {ratio:.2f}x",
              file=sys.stderr)
        if ratio < args.tune_min_ratio:
            print(f"FAIL: tuned plane fell below "
                  f"{args.tune_min_ratio:.2f}x the best static grid "
                  f"at {largest} bytes", file=sys.stderr)
            rc = 1
    trend_rc = _record_and_trend(args, run_id, cells)
    return rc if rc else trend_rc


def _record_and_trend(args, run_id, cells) -> int:
    """Ledger recording + the --trend-gate verdict, one ledger record
    per sweep cell.  Verdicts are judged against PRIOR runs of the
    same (mode, size, chunk, stripes) cell, then this run is
    appended — a regressed run never poisons its own baseline.
    Returns 1 on a regression under --trend-gate, else 0; history
    trouble costs the trend layer, never the bench verdict."""
    ledger = history.RunLedger()
    if not ledger.enabled:
        return 0
    regressed = False
    for cell in cells:
        cfg_key = history.config_key(
            "dcn_bench", cell["mode"], cell["bytes"],
            f"c{cell['chunk_bytes']}", f"s{cell['stripes']}")
        metrics = {"mbps": cell["mbps"]}
        if cell.get("exposed_ratio") is not None:
            metrics["exposed_ratio"] = cell["exposed_ratio"]
        if cell.get("pct_of_memcpy") is not None:
            metrics["pct_of_memcpy"] = cell["pct_of_memcpy"]
        try:
            prior = ledger.records(kind="dcn_bench", cfg_key=cfg_key)
        except history.LedgerError as e:
            print(f"history ledger unreadable ({e}); trend gate "
                  f"skipped", file=sys.stderr)
            return 0
        verdicts = [
            history.trend_verdict(prior, m, v,
                                  cpu_attr=cell.get("cpu_attr"))
            for m, v in sorted(metrics.items())
        ]
        ledger.record("dcn_bench", cfg_key, metrics, run_id=run_id,
                      cpu_attr=cell.get("cpu_attr"))
        for v in verdicts:
            if v["status"] == "regressed":
                regressed = True
                print(f"trend [{cfg_key}]: "
                      + history.format_verdict(v), file=sys.stderr)
    return 1 if (args.trend_gate and regressed) else 0


if __name__ == "__main__":
    raise SystemExit(main())
