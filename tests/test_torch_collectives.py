"""The port's collectives rig (``collectives/bench.py``, ``synth.py``)
against the JAX package's (``container_engine_accelerators_tpu/
collectives/bench.py``), on gloo ranks on the CPU.

Semantics, not bandwidth (the CPU's times mean nothing): the size parser
and nccl-tests' bus factors on ``tests/test_collectives.py``'s cases; at
2 and 4 ranks, 1, 2 and n chained rounds of each op on the same f32
input equal JAX's ``_make_collective(op, Mesh(devices[:n], ("x",)))``
block for block (exactly: the sums here are of small integers, exact in
f32 in any order), the n-round shift back at its origin; the per-rank
payload accounting (``size_bytes``) of a sweep equals JAX's on that mesh
for every op; a step factor below 2 is refused; and the verdict file
holds JAX's keys, with the same pass values and exit codes, in the pass,
fail and no-bar cases (at one rank, and the fail case on every rank of
2 and 4).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_helpers as H
import torch_par_helpers as P
from container_engine_accelerators_tpu.collectives import bench as jbench
from container_engine_accelerators_tpu_torch.collectives import bench
from container_engine_accelerators_tpu_torch.collectives.synth import (
    bus_factor,
)

WORLDS = (2, 4)
SWEEP = dict(min_bytes=2**12, max_bytes=2**14, iters=2, warmup=1)
CLI = ["-b", "4K", "-e", "8K", "--iters", "2", "--warmup", "1", "--op",
       "all_reduce", "--dtype", "float32", "--device", "cpu"]


@pytest.mark.parametrize("s", ["1M", "512M", "2G", "128K", "4096", "1.5K",
                               " 64k "])
def test_parse_size_equals_jax(s):
    assert bench._parse_size(s) == jbench._parse_size(s)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("op", bench.OPS)
def test_bus_factor_equals_jax(op, n):
    assert bus_factor(op, n) == jbench._bus_factor(op, n)


def _cases(n):
    """(op, reps, global f32 input) for each op at 1, 2 and n rounds:
    small integers, so every sum is exact."""
    rng = np.random.default_rng(n)
    return [(op, reps, rng.integers(-3, 4, n * 8).astype(np.float32))
            for op in bench.OPS for reps in sorted({1, 2, n})]


def _jax_values(n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    out = []
    for op, reps, x in _cases(n):
        out.append(np.asarray(jbench._make_collective(op, mesh)(
            jnp.asarray(x), reps)).reshape(n, -1))
    return out


def _jax_sizes(n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    return {op: [r.size_bytes for r in jbench.run_sweep(
        mesh=mesh, op=op, dtype=jnp.float32, **SWEEP)] for op in bench.OPS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (each rank's (values, sizes, fail-case exit code), the verdict
    rank 0 wrote)}."""
    out = {}
    for n in WORLDS:
        tmp = tmp_path_factory.mktemp(f"coll{n}")
        verdict = tmp / "verdict.json"
        argv = CLI + ["--line-rate-gbps", "1e9", "--verdict-json",
                      str(verdict)]
        ranks = H.spawn(P.collective_runs, n, tmp, _cases(n), SWEEP, argv)
        out[n] = (ranks, json.loads(verdict.read_text()))
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_chained_rounds_equal_jax(runs, n):
    ranks, _ = runs[n]
    want = _jax_values(n)
    for (op, reps, x), w, i in zip(_cases(n), want, range(len(want))):
        for rank, (values, _, _) in enumerate(ranks):
            np.testing.assert_array_equal(
                values[i], w[rank], err_msg=f"{op} x{reps} rank {rank}")
        if op == "ppermute" and reps == n:  # the full ring: back home
            np.testing.assert_array_equal(
                np.concatenate([r[0][i] for r in ranks]), x)


@pytest.mark.parametrize("n", WORLDS)
def test_sweep_payload_accounting_equals_jax(runs, n):
    ranks, _ = runs[n]
    want = _jax_sizes(n)
    for _, sizes, _ in ranks:
        assert sizes == want
    # S is the per-rank payload; all-gather's S the gathered output.
    assert want["all_reduce"] == [2**12, 2**13, 2**14]
    assert want["all_gather"] == [2**12, 2**13, 2**14]


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_exits_with_rank_0s_verdict(runs, n):
    ranks, verdict = runs[n]
    assert [r[2] for r in ranks] == [1] * n
    assert verdict["pass"] is False and verdict["devices"] == n
    assert verdict["platform"] == "cpu"


def test_step_factor_below_2_is_refused():
    with pytest.raises(ValueError, match="step factor"):
        bench.run_sweep(min_bytes=2**12, max_bytes=2**13, step_factor=1,
                        iters=1, warmup=1)


def _both(tmp_path, extra):
    """(JAX's rc and verdict, the port's rc and verdict) of the CLI on the
    host devices / one gloo rank.  The ring shift's bus factor is 1 at
    any n (the collectives' is 0 at n = 1), so its bar can pass at one
    rank."""
    out = []
    for name, main, flags in (("jax", jbench.main, CLI[:-2]),
                              ("port", bench.main, CLI)):
        path = tmp_path / f"{name}.json"
        flags = [f if f != "all_reduce" else "ppermute" for f in flags]
        rc = main(flags + ["--verdict-json", str(path)] + extra)
        out.append((rc, json.loads(path.read_text())))
    return out


@pytest.mark.parametrize("extra,rc,passed", [
    (["--line-rate-gbps", "1e-9"], 0, True),
    (["--line-rate-gbps", "1e9"], 1, False),
    ([], 0, None)], ids=["pass", "fail", "no-bar"])
def test_verdict_keys_and_bar_equal_jax(tmp_path, extra, rc, passed):
    import torch.distributed as dist

    (jrc, jv), (prc, pv) = _both(tmp_path, extra)
    assert not dist.is_initialized()  # the group main made, it destroyed
    assert pv.keys() == jv.keys()
    assert (jrc, jv["pass"]) == (prc, pv["pass"]) == (rc, passed)
    assert pv["line_rate_gbps"] == jv["line_rate_gbps"]
    assert [r.keys() for r in pv["results"]] == \
        [r.keys() for r in jv["results"]]
    assert [r["size_bytes"] for r in pv["results"]] == [4096, 8192]
    assert (pv["platform"], pv["devices"]) == ("cpu", 1)


# ---- DcnBenchAccounting: the sweep mirrored into the node daemon ----------


def _daemon_total(uds):
    from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
        DcnXferClient,
    )

    with DcnXferClient(uds) as c:
        return c.stats()["total_transferred"]


@pytest.mark.parametrize("daemon_pkg", ["torch", "jax"])
def test_dcn_accounting_mirrors_the_sweep_as_jax_does(tmp_path, monkeypatch,
                                                      daemon_pkg):
    """With ``DCN_UDS_DIR`` set each package's CLI records every sweep
    point's bytes into the daemon (either package's ``PyXferd``) under
    the flow ``bench-<op>``, and releases it at exit."""
    if daemon_pkg == "torch":
        from container_engine_accelerators_tpu_torch.fleet.xferd import (
            PyXferd,
        )
    else:
        from container_engine_accelerators_tpu.fleet.xferd import PyXferd

    daemon = PyXferd(str(tmp_path / "x")).start()
    monkeypatch.setenv("DCN_UDS_DIR", daemon.uds_dir)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    seen = {}
    for name, mod, flags in (("jax", jbench, CLI[:-2]), ("port", bench, CLI)):
        close = mod.DcnBenchAccounting.close

        def spy(acct, close=close, name=name):
            seen[name] = (acct._flow, acct._client.stats(flow=acct._flow))
            close(acct)

        monkeypatch.setattr(mod.DcnBenchAccounting, "close", spy)
        before = _daemon_total(daemon.uds_dir)
        assert mod.main(flags) == 0
        seen[name] += (_daemon_total(daemon.uds_dir) - before,)
    try:
        for name in ("jax", "port"):
            flow, stats, total = seen[name]
            assert flow == "bench-all_reduce"
            (entry,) = [f for f in stats["flows"] if f["flow"] == flow]
            assert entry["transferred"] == total == 4096 + 8192
        assert _daemon_total(daemon.uds_dir) == 2 * (4096 + 8192)
        from container_engine_accelerators_tpu_torch.parallel.dcn_client \
            import DcnXferClient

        with DcnXferClient(daemon.uds_dir) as c:
            assert c.stats()["active_flows"] == 0  # released at exit
    finally:
        daemon.stop()


def test_dcn_accounting_without_a_daemon_leaves_the_sweep_alone(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DCN_UDS_DIR", str(tmp_path / "nobody"))
    acct = bench.DcnBenchAccounting.from_env("bench-all_reduce")
    assert acct._client is None
    acct.record(bench.CollectiveResult("all_reduce", 4096, 1.0, 1.0, 1.0))
    acct.close()
    assert bench.main(CLI) == 0


@pytest.mark.parametrize("local,flow", [(None, "bench-all_reduce"),
                                        ("0", "bench-all_reduce"),
                                        ("3", "bench-all_reduce.3")])
def test_accounting_flow_a_rank(local, flow):
    env = {} if local is None else {"LOCAL_RANK": local}
    assert bench.bench_flow("all_reduce", env) == flow
