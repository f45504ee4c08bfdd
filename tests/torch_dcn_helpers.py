"""Rank worker for the port's DCN integration test, run under gloo on
the CPU by ``tests/torch_dist_helpers.py::spawn``.  No jax here: a
spawned child re-imports its function's module.

Each rank holds a seeded float32 shard, runs its own ``PyXferd`` (or
uses the native daemon its parent started), and exchanges the shard
with its peer through ``parallel/dcn.py::exchange_shard`` in each
lane; the sum of its shard and the peer's must equal gloo's
``all_reduce`` of the two shards bit for bit.
"""

import os
import tempfile

import numpy as np

SHARD_ELEMS = 1 << 16  # 256 KiB of float32
CHUNK_BYTES = 1 << 16  # four chunks a pipelined leg

# Each lane: (env for the client's PipelineConfig, pipelined=).
LANES = {
    "serial": ({}, False),
    "pipelined": ({"TPU_DCN_SHM": "0", "TPU_DCN_SHM_DIRECT": "0"}, True),
    "default": ({}, None),
    "native": ({}, False),
}
_LANE_ENV = ("TPU_DCN_SHM", "TPU_DCN_SHM_DIRECT")


def exchange_lanes(rank, world, lanes, native_dirs):
    """-> {lane: (bit-equal to all_reduce, lane byte counters moved)}."""
    import torch
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
    from container_engine_accelerators_tpu_torch.obs import timeseries
    from container_engine_accelerators_tpu_torch.parallel import dcn

    peer = 1 - rank
    shard = np.random.default_rng(1234 + rank).standard_normal(
        SHARD_ELEMS).astype(np.float32)
    want = torch.from_numpy(shard.copy())
    dist.all_reduce(want)
    os.environ["TPU_DCN_CHUNK_BYTES"] = str(CHUNK_BYTES)
    os.environ.pop("TPU_FAULT_SPEC", None)
    out = {}
    with tempfile.TemporaryDirectory(prefix="dx") as tmp:
        daemon = PyXferd(os.path.join(tmp, f"r{rank}"),
                         node=f"r{rank}").start()
        try:
            for lane in lanes:
                env, pipelined = LANES[lane]
                for key in _LANE_ENV:
                    os.environ.pop(key, None)
                os.environ.update(env)
                uds = native_dirs[rank] if lane == "native" else \
                    daemon.uds_dir
                client = dcn.make_xfer_client(uds)
                ports = [None] * world
                dist.all_gather_object(ports, client.data_port())
                before = dict(timeseries.gauges())
                barrier = dist.barrier
                if lane == "native" and rank:
                    # A native daemon's send holds its event loop until
                    # the peer has read the frame: two daemons sending
                    # to each other at once wait on each other, so rank
                    # 1 sends once rank 0's shard has landed.
                    def barrier(c=client, flow=f"grad{peer}.{lane}"):
                        dist.barrier()
                        dcn.wait_flow_rx(c, flow, shard.nbytes)
                with client:
                    raw = dcn.exchange_shard(
                        client, local_flow=f"grad{rank}.{lane}",
                        peer_flow=f"grad{peer}.{lane}",
                        data=shard.tobytes(), peer_host="127.0.0.1",
                        peer_port=ports[peer], barrier=barrier,
                        pipelined=pipelined)
                got = torch.from_numpy(shard) + torch.frombuffer(
                    bytearray(raw), dtype=torch.float32)
                moved = {k: v - before.get(k, 0.0)
                         for k, v in timeseries.gauges().items()
                         if k.startswith("dcn.lane.")
                         and v != before.get(k, 0.0)}
                out[lane] = (bool(torch.equal(got.view(torch.int32),
                                              want.view(torch.int32))),
                             moved)
                dist.barrier()
        finally:
            daemon.stop()
    return out
