"""Multi-process start-up inside Kubernetes, and the cross-node leg of a
collective through the node's dcnxferd daemon — PyTorch counterpart of
``container_engine_accelerators_tpu/parallel/dcn.py``.

JAX runs one process per host and sees every chip of it.  PyTorch runs
one process per GPU, each a rank of one ``torch.distributed`` group:
``initialize`` calls ``init_process_group`` (NCCL on the card, gloo on
the CPU) and pins the process to ``cuda:<LOCAL_RANK>``.

Env contract, read in this order:

- torchrun (several GPUs a pod, or a bare host): ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Its
  presence makes :func:`initialize` create a group even at
  ``WORLD_SIZE=1``; the trainers and the server call it only when they
  take a mesh (``parallel/launch.py``).
- the K8s indexed Job of the JAX package (one process a pod):
  ``TPU_WORKER_COUNT`` (or ``NUM_TPU_WORKERS``), ``TPU_WORKER_ID`` (or
  ``JOB_COMPLETION_INDEX``) and ``TPU_COORDINATOR_ADDR``, which when
  unset is ``<JOB_NAME>-0.<TPU_SERVICE_NAME>:8476``, pod 0 of the Job's
  headless Service.
- ``DCN_UDS_DIR``: the UDS directory of the node's dcnxferd sidecar;
  when set, :func:`make_xfer_client` / :func:`exchange_shard` stage a
  cross-node leg through the daemon.

The transfer half is host code (no torch): a GPU shard reaches it as
bytes on the host, and the peer's bytes go back to the card after it.
"""

import logging
import os
import time
from typing import Callable, Optional, Tuple

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476

# Env contract for the node dcnxferd sidecar.
DCN_UDS_ENV = "DCN_UDS_DIR"

# Whether this module created the process group (and so destroys it).
_OWNED = False


def resolve_cluster(env=None) -> Tuple[Optional[str], int, int]:
    """Return (coordinator ``host:port``, number of processes, this
    process's rank) from the env: (None, 1, 0) for a single process no
    launcher described."""
    env = env if env is not None else os.environ
    if "WORLD_SIZE" in env:
        num, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
        if not 0 <= rank < num:
            raise ValueError(f"RANK {rank} outside [0, {num})")
        host = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", str(DEFAULT_COORDINATOR_PORT))
        return f"{host}:{port}", num, rank
    num = int(env.get("TPU_WORKER_COUNT", env.get("NUM_TPU_WORKERS", "1")))
    if num <= 1:
        return None, 1, 0
    pid_raw = env.get("TPU_WORKER_ID", env.get("JOB_COMPLETION_INDEX"))
    if pid_raw is None:
        raise ValueError(
            "TPU_WORKER_COUNT > 1 but neither TPU_WORKER_ID nor "
            "JOB_COMPLETION_INDEX is set")
    process_id = int(pid_raw)
    if not 0 <= process_id < num:
        raise ValueError(f"process id {process_id} outside [0, {num})")
    addr = env.get("TPU_COORDINATOR_ADDR")
    if not addr:
        job = env.get("JOB_NAME")
        service = env.get("TPU_SERVICE_NAME", job)
        if not job:
            raise ValueError(
                "multi-host run needs TPU_COORDINATOR_ADDR or JOB_NAME to "
                "derive the coordinator from headless-service DNS")
        # Indexed Jobs give pod 0 the stable DNS name <job>-0.<service>.
        addr = f"{job}-0.{service}:{DEFAULT_COORDINATOR_PORT}"
    elif ":" not in addr:
        addr = f"{addr}:{DEFAULT_COORDINATOR_PORT}"
    return addr, num, process_id


def local_device(device=None, env=None) -> "torch.device":  # noqa: F821
    """This rank's device: ``cpu`` when asked for, else
    ``cuda:<LOCAL_RANK>``.  A rank that finds no GPU exits with a
    message; it never falls back to the CPU."""
    import torch

    env = env if env is not None else os.environ
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(env.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise SystemExit(
            f"rank needs cuda:{local} but "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" GPU(s) are visible; pass --device cpu to run on the CPU")
    return torch.device("cuda", local)


def initialize(env=None, device=None, force: bool = False,
               store=None) -> Tuple[int, int]:
    """Join (or create) the default process group from the env contract;
    return (world size, rank).

    Without a launcher's env (one process), nothing happens and (1, 0)
    returns, unless ``force``: a mesh was asked for, so a world-size-1
    group is made (an in-process store, nothing to dial).  ``device`` is
    ``cpu`` for gloo, else the rank's GPU for NCCL.  ``store`` (tests:
    a ``FileStore``) replaces the TCP rendezvous.  A group that already
    exists is reused."""
    import torch.distributed as dist

    global _OWNED
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    addr, num, rank = resolve_cluster(env)
    if addr is None and not force and store is None:
        return 1, 0
    dev = local_device(device, env)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        import torch

        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, world_size=num, rank=rank)
    if store is not None:
        kwargs["store"] = store
    elif num == 1:
        # No peer to meet: nothing to dial or listen on.
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = f"tcp://{addr}"
    log.info("init_process_group(%s, world_size=%d, rank=%d, %s)", backend,
             num, rank, "in-process store" if num == 1 else addr)
    dist.init_process_group(**kwargs)
    _OWNED = True
    return num, rank


def shutdown() -> None:
    """Destroy the process group if :func:`initialize` created it."""
    import torch.distributed as dist

    global _OWNED
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED = False


# ---- dcnxferd transfer path -------------------------------------------------


def make_xfer_client(
    uds_dir: Optional[str] = None,
    resilient: bool = True,
    env=None,
    **kwargs,
):
    """Build the node dcnxferd client from the pod env contract.

    Resolution order: explicit ``uds_dir`` arg, then ``DCN_UDS_DIR``
    env.  Returns None when neither is set (no sidecar on this node —
    callers degrade to pure in-process collectives).  ``resilient=True``
    (the default for workloads) returns a
    :class:`~container_engine_accelerators_tpu_torch.parallel.dcn_client.ResilientDcnXferClient`
    that rides out daemon restarts; pass False for the fail-fast
    transport client.
    """
    from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
        DcnXferClient,
        ResilientDcnXferClient,
    )

    env = env if env is not None else os.environ
    uds = uds_dir or env.get(DCN_UDS_ENV)
    if not uds:
        return None
    cls = ResilientDcnXferClient if resilient else DcnXferClient
    return cls(uds, **kwargs)


# Adaptive poll bounds for daemons without the blocking wait op: start
# fine-grained so small transfers stop paying a poll-quantum tax, back
# off to the old 20 ms ceiling so a long wait stays cheap.
POLL_MIN_S = 0.0005
POLL_MAX_S = 0.02


def wait_flow_rx(client, flow: str, nbytes: int,
                 timeout_s: float = 60.0) -> None:
    """Block until ``flow`` has landed ``nbytes`` (RX accounting is
    asynchronous on the daemon side).

    Fast path: the daemon's blocking ``wait`` control op (PyXferd) —
    a condition-variable wakeup instead of polling.  Fallback for
    wait-less daemons (the native daemon, the test stub): adaptive
    poll, doubling from :data:`POLL_MIN_S` to :data:`POLL_MAX_S`, each
    poll asking ``stats`` for just this flow (filter-aware daemons
    answer in O(1); older ones return everything and the client-side
    ``next`` does the filtering as before).
    """
    from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
        DcnWaitUnsupported,
    )

    wait_rx = getattr(client, "wait_rx", None)
    if wait_rx is not None:
        try:
            wait_rx(flow, nbytes, timeout_s=timeout_s)
            return
        except DcnWaitUnsupported:
            pass  # wait-less daemon: poll below
        except TimeoutError:
            raise TimeoutError(
                f"flow {flow!r} never received {nbytes} bytes"
            )
    deadline = time.monotonic() + timeout_s
    interval = POLL_MIN_S
    while time.monotonic() < deadline:
        f = next(
            (x for x in client.stats(flow=flow)["flows"]
             if x["flow"] == flow),
            None,
        )
        if f is not None and f["rx_bytes"] >= nbytes:
            return
        time.sleep(interval)
        interval = min(interval * 2, POLL_MAX_S)
    raise TimeoutError(f"flow {flow!r} never received {nbytes} bytes")


def exchange_shard(
    client,
    *,
    local_flow: str,
    peer_flow: str,
    data: Optional[bytes] = None,
    peer_host: str,
    peer_port: int,
    barrier: Optional[Callable[[], object]] = None,
    timeout_s: float = 60.0,
    pipelined: Optional[bool] = None,
    producer=None,
    nbytes: Optional[int] = None,
) -> bytes:
    """One cross-pod leg of a DCN collective, staged through dcnxferd.

    Registers both directions (``local_flow`` to send, ``peer_flow`` to
    land the peer's shard), stages ``data`` via the data plane, streams
    it to the peer daemon, and returns the peer's shard read back out of
    the local daemon.  ``barrier`` runs after flow registration and
    before the send: the peer must have registered its landing flow or
    the payload counts as unmatched and is dropped
    (``torch.distributed.barrier`` in real workers).

    With a resilient client the leg survives a daemon restart at any
    point on the LOCAL side: flows are replayed on reconnect, ``put``'s
    retry budget restages during staging, and a restart after a
    completed put is healed by the client itself — a ``send`` that hits
    the restarted daemon's blank staging restages the cached payload
    and re-sends under the same frame seq, and ``read`` does the
    equivalent for read-back (``dcn.send.restaged`` /
    ``dcn.read.restaged``).  What no client can heal alone is the
    PEER's staged shard dying with the peer daemon after it landed —
    the rx wait times out and callers retry the whole leg, which asks
    the peer to re-send.

    Payloads above the pipeline threshold (``TPU_DCN_CHUNK_BYTES``,
    daemon permitting) take the chunked/striped pipelined path: stage
    and send overlap per chunk and read-back is raw DXR1 instead of
    base64 — pass ``pipelined=False``/``True`` to force either leg.
    A pipelined failure falls back to the serial path once
    (``dcn.pipeline.fallback``) before surfacing, so a daemon that
    lost its pipeline capability mid-leg degrades instead of failing.
    Empty shards short-circuit after the barrier: registration keeps
    the rendezvous honest, but no bytes are staged, sent, or read.

    Producer mode (``producer`` + ``nbytes``, ``data=None``): the
    shard is pulled from an iterable (or zero-arg callable returning
    one) of byte chunks AS THE PIPELINED LEG STAGES — on a ring-
    capable daemon, production overlaps the DCN leg instead of
    preceding it, which is what pulls ``dcn.exposed_ratio`` below the
    stage-then-send baseline.  Every consumed chunk is captured, so
    the serial fallback (and a ring-less daemon) still sees the full
    payload; the producer itself is consumed at most once.
    """
    from container_engine_accelerators_tpu_torch.metrics import counters
    from container_engine_accelerators_tpu_torch.obs import histo, timeseries, trace
    from container_engine_accelerators_tpu_torch.parallel import dcn_pipeline
    from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
        DcnXferError,
    )

    produced = []
    producer_iter = None
    src = None
    if producer is not None:
        if data is not None:
            raise ValueError("pass data OR producer, not both")
        if not nbytes or int(nbytes) <= 0:
            raise ValueError("producer mode needs nbytes > 0")
        nbytes = int(nbytes)
        src = iter(producer() if callable(producer) else producer)

        def _capture(it=src):
            # Tee every consumed chunk: a fallback leg (serial path,
            # ring-less daemon) can then materialize the full shard
            # even though the producer is one-shot.
            for piece in it:
                produced.append(bytes(piece))
                yield piece

        producer_iter = _capture()
    else:
        nbytes = len(data)

    def _materialize() -> bytes:
        whole = b"".join(produced) + b"".join(bytes(p) for p in src)
        if len(whole) != nbytes:
            raise DcnXferError(
                f"producer yielded {len(whole)} bytes for "
                f"{local_flow!r}, expected {nbytes}")
        return whole
    try:
        # One span per leg, one child span per phase: a slow exchange
        # decomposes into register / barrier / stage / send / land /
        # read in the trace instead of a single opaque wall-clock.
        with trace.span("dcn.exchange", histogram="dcn.exchange",
                        local_flow=local_flow, peer_flow=peer_flow,
                        bytes=nbytes, peer=peer_host):
            # Registration inside the try: if the SECOND register fails
            # (max_flows, name collision) the finally still releases the
            # first instead of leaking it into every retry of the leg.
            with trace.span("dcn.exchange.register"):
                client.register_flow(local_flow, peer=peer_host,
                                     bytes=nbytes)
                client.register_flow(peer_flow, bytes=nbytes)
            if barrier is not None:
                with trace.span("dcn.exchange.barrier",
                                histogram="dcn.exchange.barrier"):
                    barrier()
            if nbytes == 0:
                # Nothing to move: the barrier already proved both
                # sides showed up, and the peer's empty shard has
                # nothing to land here either.
                counters.inc("dcn.exchange.empty")
                return b""
            cfg = dcn_pipeline.PipelineConfig()
            use_pipe = (pipelined if pipelined is not None
                        else dcn_pipeline.should_pipeline(client, nbytes,
                                                          cfg))
            if use_pipe:
                try:
                    return _exchange_pipelined(
                        client, local_flow, peer_flow, data, peer_host,
                        peer_port, cfg, timeout_s,
                        producer=producer_iter, nbytes=nbytes)
                except (DcnXferError, OSError) as e:
                    if pipelined:  # explicitly forced: surface it
                        raise
                    counters.inc("dcn.pipeline.fallback")
                    log.warning(
                        "pipelined exchange of %r failed (%s); "
                        "falling back to the serial leg",
                        local_flow, e,
                    )
            if data is None:
                # Producer mode on the serial path: materialize the
                # captured prefix plus the rest of the iterator —
                # stage-then-send, the baseline shape.
                data = _materialize()
            with trace.span("dcn.exchange.stage",
                            histogram="dcn.exchange.stage"):
                client.put(local_flow, data)
                wait_flow_rx(client, local_flow, nbytes, timeout_s)
            t_comm0 = time.monotonic()
            with trace.span("dcn.exchange.send",
                            histogram="dcn.exchange.send"):
                client.send(local_flow, peer_host, peer_port, nbytes)
            with trace.span("dcn.exchange.land",
                            histogram="dcn.exchange.land"):
                wait_flow_rx(client, peer_flow, nbytes, timeout_s)
            # The serial leg by construction overlaps NOTHING with its
            # send+land phases: its whole DCN time is exposed.  Feed
            # the same histograms the pipelined lane feeds so the
            # exposed-comm ratio compares the shapes honestly
            # (ratio 1.0 is the serial baseline the pipeline beats).
            comm_s = time.monotonic() - t_comm0
            if comm_s > 0:
                cur = trace.current()
                tid = cur.trace_id if cur is not None else None
                histo.observe("dcn.exposed", comm_s, trace_id=tid)
                histo.observe("dcn.comm", comm_s, trace_id=tid)
                timeseries.gauge("dcn.exposed_ratio", 1.0)
            got = client.read(peer_flow, nbytes)
            if len(got) != nbytes:
                # With chunked peers, rx accounting can reach nbytes
                # while the landed frame is still assembling (or spans
                # two attempts); a short read here is "not landed yet",
                # never data — surface it so the caller's leg retry
                # asks the peer to re-send.
                raise DcnXferError(
                    f"peer shard {peer_flow!r} read short: "
                    f"{len(got)} != {nbytes}"
                )
            return got
    finally:
        # Release both flows so repeated legs on a long-lived client
        # neither hit the daemon's duplicate-flow rejection nor leak
        # staging buffers toward max_flows/pool exhaustion.  By here the
        # peer's send into peer_flow has landed (we waited + read), and
        # local_flow's payload has been streamed out, so the releases
        # touch only this node's daemon state.
        for flow in (local_flow, peer_flow):
            try:
                client.release_flow(flow)
            except (DcnXferError, OSError):
                pass  # cleanup: a restarted daemon already forgot it


def _exchange_pipelined(client, local_flow, peer_flow, data, peer_host,
                        peer_port, cfg, timeout_s, producer=None,
                        nbytes=None) -> bytes:
    """The pipelined leg body: overlapped chunked stage+send of the
    local shard, then land-wait and read-back of the peer's (zero-copy
    shm when the daemon is same-host, DXR1 otherwise).  Flows are
    already registered; the caller owns release."""
    from container_engine_accelerators_tpu_torch.obs import trace
    from container_engine_accelerators_tpu_torch.parallel import dcn_pipeline
    from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
        DcnXferError,
    )

    nbytes = len(data) if data is not None else int(nbytes)
    with trace.span("dcn.exchange.pipeline",
                    histogram="dcn.exchange.pipeline",
                    local_flow=local_flow, bytes=nbytes):
        if cfg.shm and dcn_pipeline.shm_same_host(client):
            # Attach the LANDING flow's segment before the peer's
            # chunks arrive: they then assemble straight into the
            # mmap and the shm read below is a pure buffer reference.
            # Best effort — without it, shm_read migrates with one
            # copy, which still beats any socket stream.
            try:
                client.shm_attach(peer_flow, nbytes)
            except (DcnXferError, OSError):
                pass
        dcn_pipeline.send_pipelined(client, local_flow, data,
                                    peer_host, peer_port, cfg,
                                    timeout_s=timeout_s,
                                    producer=producer, nbytes=nbytes)
        with trace.span("dcn.exchange.land",
                        histogram="dcn.exchange.land"):
            wait_flow_rx(client, peer_flow, nbytes, timeout_s)
        return dcn_pipeline.read_pipelined(client, peer_flow, nbytes,
                                           cfg, timeout_s=timeout_s)
