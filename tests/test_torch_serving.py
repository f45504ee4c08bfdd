"""The port's serving frontend and breakers (``serving/``) held against
the JAX package's: scripted ``NodeBreaker`` sequences on an injected
clock give equal states, answers and counters; the frontend with an
injected ``transfer=`` gives the same deliveries, sheds, hedges and
dedups in both packages; and the fleet's serving rounds keep the
zero-lost gate."""

import threading
import time

import pytest

import container_engine_accelerators_tpu.metrics.counters as j_counters
import container_engine_accelerators_tpu.serving.breaker as j_breaker
import container_engine_accelerators_tpu.serving.frontend as j_frontend
from container_engine_accelerators_tpu.parallel.dcn_client import (
    DcnXferError as JDcnXferError,
)
import container_engine_accelerators_tpu_torch.metrics.counters as p_counters
import container_engine_accelerators_tpu_torch.serving.breaker as p_breaker
import container_engine_accelerators_tpu_torch.serving.frontend as p_frontend
from container_engine_accelerators_tpu_torch.fleet.controller import (
    DEFAULT_SERVING_SCENARIO,
    FleetController,
)
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError as PDcnXferError,
)

PACKAGES = {
    "jax": (j_breaker, j_frontend, j_counters, JDcnXferError),
    "port": (p_breaker, p_frontend, p_counters, PDcnXferError),
}

SERVING_COUNTERS = (
    "serving.requests", "serving.shed", "serving.ok", "serving.errors",
    "serving.hedge.fired", "serving.hedge.won", "serving.hedge.wasted",
    "serving.dedup.dropped", "serving.breaker.open",
    "serving.breaker.close", "serving.breaker.probe",
)


class _FakeNode:
    def __init__(self, name):
        self.name = name
        self.root = "/nonexistent"
        self.down = False
        self.permanently_down = False


def _fleet(*names):
    return {n: _FakeNode(n) for n in names}


def _wait_for(cond, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# -- breaker: scripted sequences on an injected clock ------------------------

BREAKER_SCRIPTS = {
    "trip_after_consecutive": [
        ("fail", "n0"), ("fail", "n0"), ("ok", "n0"), ("fail", "n0"),
        ("fail", "n0"), ("allow", "n0"), ("fail", "n0"), ("allow", "n0"),
    ],
    "one_probe_then_close": [
        ("fail", "n0"), ("allow", "n0"), ("t", 1.5), ("allow", "n0"),
        ("allow", "n0"), ("ok", "n0"), ("allow", "n0"),
    ],
    "probe_failure_reopens": [
        ("fail", "n0"), ("t", 2.0), ("allow", "n0"), ("fail", "n0"),
        ("allow", "n0"), ("t", 2.5), ("allow", "n0"), ("t", 3.5),
        ("allow", "n0"),
    ],
    "abandoned_probe_released": [
        ("fail", "n0"), ("t", 2.0), ("allow", "n0"), ("allow", "n0"),
        ("release", "n0"), ("allow", "n0"),
    ],
    "two_nodes_independent": [
        ("fail", "n0"), ("fail", "n1"), ("fail", "n1"), ("allow", "n0"),
        ("allow", "n1"), ("t", 1.2), ("allow", "n1"), ("ok", "n1"),
        ("fail", "n0"), ("allow", "n0"),
    ],
}


def _run_breaker(pkg, script, failures):
    breaker, _, counters, _ = PACKAGES[pkg]
    clk = [0.0]
    b = breaker.NodeBreaker(failures=failures, cooldown_s=1.0,
                            clock=lambda: clk[0])
    c0 = {k: counters.get(k) for k in SERVING_COUNTERS}
    trail = []
    for op, arg in script:
        if op == "t":
            clk[0] = arg
            continue
        if op == "fail":
            b.record_failure(arg)
        elif op == "ok":
            b.record_success(arg)
        elif op == "release":
            b.release_probe(arg)
        elif op == "allow":
            trail.append(b.allow(arg))
        trail.append((arg, b.state(arg)))
    return {"trail": trail, "snapshot": b.snapshot(),
            "counters": {k: counters.get(k) - c0[k]
                         for k in SERVING_COUNTERS}}


@pytest.mark.parametrize("failures", [1, 2, 3])
@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_sequences_equal_jax(script, failures):
    steps = BREAKER_SCRIPTS[script]
    assert _run_breaker("port", steps, failures) == \
        _run_breaker("jax", steps, failures)


# -- frontend with an injected transfer --------------------------------------


def _case_batching(pkg):
    _, frontend, _, _ = PACKAGES[pkg]
    sizes, lock = [], threading.Lock()

    def transfer(batch, node, cancel):
        with lock:
            sizes.append(len(batch.requests))
        return batch.payload

    fe = frontend.ServingFrontend(
        _fleet("n0", "n1"),
        frontend.ServingConfig(max_batch=3, max_wait_ms=250.0,
                               admission_capacity=16),
        transfer=transfer)
    reqs = [fe.submit(bytes([i])) for i in range(7)]
    fe.start()
    try:
        _wait_for(lambda: all(r.done() for r in reqs))
    finally:
        fe.close()
    return {"sizes": sorted(sizes, reverse=True),
            "results": [(r.result, r.error) for r in reqs]}


def _case_shed(pkg):
    _, frontend, _, _ = PACKAGES[pkg]
    fe = frontend.ServingFrontend(
        _fleet("n0"),
        frontend.ServingConfig(admission_capacity=2),
        transfer=lambda batch, node, cancel: batch.payload)
    out = []
    for i in range(4):
        try:
            out.append(("queued", fe.submit(bytes([i])).rid))
        except frontend.RequestShed:
            out.append(("shed", i))
    fe.start()
    fe.close()
    try:
        fe.submit(b"late")
        out.append("accepted after close")
    except frontend.RequestShed:
        out.append("shed after close")
    return {"admission": [o[0] if isinstance(o, tuple) else o
                          for o in out]}


def _hedge_case(pkg, order):
    """Two attempts of one request: ``order`` says which lands first
    (``hedge`` — the primary parks and is cancelled; ``stubborn`` — the
    primary ignores cancellation and lands after the hedge won;
    ``primary`` — the primary lands after the hedge fired)."""
    _, frontend, _, _ = PACKAGES[pkg]
    calls, lock = [0], threading.Lock()
    p_gate, h_gate = threading.Event(), threading.Event()

    def primary(batch, node, cancel):
        if order == "hedge":
            _wait_for(cancel.is_set, what="loser cancellation")
            raise frontend.AttemptCancelled()
        assert p_gate.wait(10.0)
        return batch.payload

    def hedge(batch, node, cancel):
        if order == "primary":
            assert h_gate.wait(10.0)
        return batch.payload

    def transfer(batch, node, cancel):
        with lock:
            calls[0] += 1
            k = calls[0]
        return (primary if k == 1 else hedge)(batch, node, cancel)

    fe = frontend.ServingFrontend(
        _fleet("n0", "n1"),
        frontend.ServingConfig(max_batch=1, max_wait_ms=1.0,
                               hedge_after_ms=40.0),
        transfer=transfer).start()
    try:
        req = fe.submit(b"payload")
        _wait_for(lambda: calls[0] >= 2, what="hedge dispatched")
        if order == "primary":
            p_gate.set()
        assert req.wait(10.0)
        winner = req.winner
        p_gate.set()
        h_gate.set()
        fe.close()
    finally:
        p_gate.set()
        h_gate.set()
        fe.close()
    return {"winner": winner, "result": req.result, "calls": calls[0]}


def _case_failover(pkg):
    _, frontend, _, err = PACKAGES[pkg]

    def transfer(batch, node, cancel):
        if node.name == "n0":
            raise err("n0 is a black hole")
        return batch.payload

    fe = frontend.ServingFrontend(
        _fleet("n0", "n1"),
        frontend.ServingConfig(max_batch=1, max_wait_ms=1.0, attempts=2,
                               breaker_failures=2,
                               breaker_cooldown_s=60.0,
                               hedge_after_ms=5000.0),
        transfer=transfer).start()
    try:
        reqs = []
        for i in range(6):
            reqs.append(fe.submit(bytes([i])))
            assert reqs[-1].wait(10.0)
    finally:
        fe.close()
    return {"results": [(r.result, r.error) for r in reqs],
            "breaker": fe.breaker.state("n0"),
            "n1_ok": fe.node_stats["n1"]["ok"],
            "n0_failed": fe.node_stats["n0"]["failed"]}


def _case_all_fail(pkg):
    _, frontend, _, err = PACKAGES[pkg]

    def transfer(batch, node, cancel):
        raise err("everything is broken")

    fe = frontend.ServingFrontend(
        _fleet("n0", "n1"),
        frontend.ServingConfig(max_batch=1, max_wait_ms=1.0, attempts=2,
                               hedge_attempts=1, hedge_after_ms=50.0,
                               request_timeout_s=5.0,
                               breaker_failures=100),
        transfer=transfer).start()
    try:
        req = fe.submit(b"x")
        assert req.wait(15.0)
    finally:
        fe.close()
    return {"result": req.result, "broken": "broken" in (req.error or "")}


CASES = {
    "batching": _case_batching,
    "shed": _case_shed,
    "hedge_wins": lambda pkg: _hedge_case(pkg, "hedge"),
    "stubborn_loser_deduped": lambda pkg: _hedge_case(pkg, "stubborn"),
    "primary_wins_hedge_wasted": lambda pkg: _hedge_case(pkg, "primary"),
    "failover": _case_failover,
    "all_attempts_fail": _case_all_fail,
}


def _run_case(pkg, name):
    counters = PACKAGES[pkg][2]
    c0 = {k: counters.get(k) for k in SERVING_COUNTERS}
    out = CASES[name](pkg)
    # Late losers land on their own threads; let their accounting settle.
    time.sleep(0.05)
    out["counters"] = {k: counters.get(k) - c0[k] for k in SERVING_COUNTERS}
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_frontend_with_injected_transfer_equals_jax(case):
    port = _run_case("port", case)
    jax_out = _run_case("jax", case)
    assert port == jax_out
    if case == "stubborn_loser_deduped":
        assert port["counters"]["serving.dedup.dropped"] == 1
    if case == "hedge_wins":
        assert port["winner"] == "hedge"
        assert port["counters"]["serving.hedge.won"] == 1
    if case == "primary_wins_hedge_wasted":
        assert port["counters"]["serving.hedge.wasted"] == 1


def test_serving_config_from_scenario_equal():
    blob = {"requests_per_round": 16, "max_batch": 4, "max_wait_ms": 4.0,
            "hedge_after_ms": 500.0, "breaker_cooldown_s": 0.5,
            "not_a_knob": 1}
    port = p_frontend.ServingConfig.from_scenario(blob)
    jax_cfg = j_frontend.ServingConfig.from_scenario(blob)
    assert port._FIELDS == jax_cfg._FIELDS
    assert {f: getattr(port, f) for f in port._FIELDS} == \
        {f: getattr(jax_cfg, f) for f in jax_cfg._FIELDS}


def test_lost_request_in_any_round_fails_convergence():
    scenario = dict(DEFAULT_SERVING_SCENARIO, nodes=2, rounds=0, faults=[])
    ctl = FleetController(scenario).boot()
    try:
        per = {n: 0 for n in ctl.nodes}

        def leg(lost, errors=0):
            return {"workload": "serving", "requests": 4, "accepted": 4,
                    "shed": 0, "ok_requests": 4 - lost - errors,
                    "errors": errors, "lost": lost,
                    "ok": lost == 0 and errors == 0}

        report = ctl._report(
            [{"round": 0, "faults": [], "legs": [leg(lost=1)]},
             {"round": 1, "faults": [], "legs": [leg(lost=0)]}],
            dict(per), dict(per))
        assert report["serving"]["lost_requests"] == 1
        assert report["converged"] is False
        report = ctl._report(
            [{"round": 0, "faults": [], "legs": [leg(lost=0, errors=2)]},
             {"round": 1, "faults": [], "legs": [leg(lost=0)]}],
            dict(per), dict(per))
        assert report["converged"] is True
    finally:
        ctl.close()
