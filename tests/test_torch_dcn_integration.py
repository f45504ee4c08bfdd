"""End to end: two gloo ranks of the port exchange their shards through
dcnxferd, each with its own daemon, as on two nodes (counterpart of
tests/test_dcn_jax_integration.py).

Each rank rendezvouses through ``parallel/dcn.initialize(device="cpu")``,
starts its own ``PyXferd``, and runs ``exchange_shard`` with
``barrier=dist.barrier`` in the serial lane, the socket pipeline
(``TPU_DCN_SHM=0``), the default lane (shm on one host), and once
between two native daemons (no wait op: the poll path).  The shard plus
the peer's must equal gloo's ``all_reduce`` bit for bit.  One spawn runs
every lane; each lane is its own test.
"""

import os
import signal
import subprocess
import time

import pytest

from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferClient,
)
from tests import torch_dcn_helpers
from tests.torch_dist_helpers import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.environ.get(
    "DCNXFERD_BIN",
    os.path.join(REPO, "native", "dcnxferd", "build", "dcnxferd"),
)
HAVE_NATIVE = os.path.exists(BIN)
LANES = [lane for lane in torch_dcn_helpers.LANES
         if lane != "native" or HAVE_NATIVE]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcnint")
    procs, dirs = [], []
    try:
        if HAVE_NATIVE:
            for rank in range(2):
                uds = str(tmp / f"n{rank}")
                procs.append(subprocess.Popen(
                    [BIN, "--uds_path", uds, "--pool_bytes", str(8 << 20),
                     "--max_flows", "8", "--data_port", "0"],
                    stderr=subprocess.PIPE, text=True))
                dirs.append(uds)
            for proc, uds in zip(procs, dirs):
                deadline = time.time() + 10
                while not os.path.exists(os.path.join(uds, "xferd.sock")):
                    assert proc.poll() is None, proc.stderr.read()
                    assert time.time() < deadline
                    time.sleep(0.02)
        out = spawn(torch_dcn_helpers.exchange_lanes, 2, tmp, LANES, dirs,
                    timeout=300)
        if HAVE_NATIVE:
            for uds in dirs:
                with DcnXferClient(uds) as c:
                    assert c.stats()["active_flows"] == 0
        return out
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            proc.wait(timeout=10)


@pytest.mark.parametrize("lane", list(torch_dcn_helpers.LANES))
def test_shard_sum_equals_gloo_all_reduce(results, lane):
    if lane not in LANES:
        pytest.skip("dcnxferd not built (make native)")
    for rank, lanes in enumerate(results):
        equal, moved = lanes[lane]
        assert equal, (rank, lane)
        if lane == "pipelined":
            assert moved.get("dcn.lane.socket.total_bytes", 0) > 0, moved
            assert "dcn.lane.shm.total_bytes" not in moved, moved
        if lane == "default":
            assert moved.get("dcn.lane.shm.total_bytes", 0) > 0, moved
