"""Lock-order race detector (analysis/lockwatch.py) unit suite.

The pins: a real ABBA inversion constructed across
two threads makes the detector fire; gated (ordered-by-a-common-lock)
acquisition is recognized as un-interleavable and suppressed; blocking
calls under a lock (long sleeps, socket IO, subprocess waits) are
findings unless annotated with ``blocking_ok``; the JSONL report and
its checker honor the exit-code contract (0 clean / 1 findings / 2
bad report); and the ``TPU_LOCKWATCH=1`` env shim instruments a
subprocess with zero code changes.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from container_engine_accelerators_tpu_torch.analysis import lockwatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def watch():
    """Installed-and-clean detector for the duration of one test; the
    patches are ALWAYS rolled back (tier-1 runs this suite without
    TPU_LOCKWATCH set, and the rest of the test run must see stock
    threading)."""
    lockwatch.install()
    lockwatch.reset()
    try:
        yield lockwatch
    finally:
        lockwatch.reset()
        lockwatch.uninstall()


def _run(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


class TestLockOrderGraph:
    def test_abba_inversion_fires_across_two_threads(self, watch):
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        _run(t1)
        _run(t2)
        f = watch.findings()
        assert len(f["inversions"]) == 1
        inv = f["inversions"][0]
        assert len(inv["cycle"]) == 2
        assert all("test_torch_lockwatch.py" in site for site in inv["cycle"])
        assert len(inv["threads"]) == 2
        # Acquisition stacks point at the nested-acquire code.
        assert any("test_torch_lockwatch.py" in line
                   for stack in inv["stacks"].values() for line in stack)
        assert f["blocking"] == []

    def test_inversion_counter_counts_each_finding_once(self, watch):
        """findings() is an idempotent query: assert_clean + the
        atexit report calling it back to back must not double-feed
        analysis.lockwatch.inversions."""
        from container_engine_accelerators_tpu_torch.metrics import counters

        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        _run(t1)
        _run(t2)
        before = counters.get("analysis.lockwatch.inversions")
        watch.findings()
        watch.findings()
        assert counters.get("analysis.lockwatch.inversions") == before + 1

    def test_consistent_order_is_clean(self, watch):
        a = threading.Lock()
        b = threading.Lock()

        def t(n):
            def body():
                for _ in range(n):
                    with a:
                        with b:
                            pass
            return body

        _run(t(3))
        _run(t(2))
        f = watch.findings()
        assert f["inversions"] == []
        assert f["edges"] == 1

    def test_gated_acquisition_is_suppressed(self, watch):
        """Both orders of (c, d) occur — but always under gate g, so
        the pair can never interleave: reported under `suppressed`
        (with the gate named), never as an inversion."""
        g = threading.Lock()
        c = threading.Lock()
        d = threading.Lock()

        def t1():
            with g:
                with c:
                    with d:
                        pass

        def t2():
            with g:
                with d:
                    with c:
                        pass

        _run(t1)
        _run(t2)
        f = watch.findings()
        assert f["inversions"] == []
        assert len(f["suppressed"]) == 1
        assert any("test_torch_lockwatch.py" in gate
                   for gate in f["suppressed"][0]["gates"])

    def test_ungated_interleaving_still_fires_despite_one_gated_run(
            self, watch):
        """A gate seen on only ONE side proves nothing: the edge's
        gate set is the intersection across sightings."""
        g = threading.Lock()
        c = threading.Lock()
        d = threading.Lock()

        def gated():
            with g:
                with c:
                    with d:
                        pass

        def bare():
            with d:
                with c:
                    pass

        _run(gated)
        _run(bare)
        f = watch.findings()
        assert len(f["inversions"]) == 1

    def test_reentrant_rlock_is_not_an_edge(self, watch):
        r = threading.RLock()
        with r:
            with r:
                pass
        f = watch.findings()
        assert f["edges"] == 0
        assert f["inversions"] == [] and f["same_site_nesting"] == []

    def test_same_site_nesting_is_informational(self, watch):
        """Two instances of one lock class nested (same construction
        site): the graph cannot orient the pair, so it is reported
        under same_site_nesting, not as a gate-failing inversion."""
        def mk():
            return threading.Lock()

        a, b = mk(), mk()
        with a:
            with b:
                pass
        f = watch.findings()
        assert f["inversions"] == []
        assert len(f["same_site_nesting"]) == 1

    def test_condition_wait_round_trip_stays_clean(self, watch):
        """The xferd pattern — Condition(watched Lock), a parked
        waiter, a notifier — must neither deadlock nor leave stale
        bookkeeping behind."""
        lk = threading.Lock()
        cond = threading.Condition(lk)
        woke = []

        def waiter():
            with cond:
                woke.append(cond.wait(timeout=5))

        t = threading.Thread(target=waiter)
        t.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with cond:
                if cond._waiters:  # parked: safe to notify
                    cond.notify_all()
                    break
            time.sleep(0.005)
        t.join()
        assert woke == [True]
        f = watch.findings()
        assert f["inversions"] == [] and f["blocking"] == []


class TestBlockingUnderLock:
    def test_long_sleep_under_lock_fires(self, watch):
        lk = threading.Lock()
        with lk:
            time.sleep(0.02)
        f = watch.findings()
        assert len(f["blocking"]) == 1
        b = f["blocking"][0]
        assert b["call"] == "time.sleep"
        assert b["seconds"] == pytest.approx(0.02)
        assert any("test_torch_lockwatch.py" in s for s in b["locks"])

    def test_short_sleep_and_unlocked_sleep_are_fine(self, watch):
        lk = threading.Lock()
        with lk:
            time.sleep(0.001)  # backoff idiom, under the threshold
        time.sleep(0.02)  # no lock held
        assert watch.findings()["blocking"] == []

    def test_sleep_threshold_env_knob(self, watch, monkeypatch):
        monkeypatch.setenv(lockwatch.SLEEP_MS_ENV, "100")
        lk = threading.Lock()
        with lk:
            time.sleep(0.02)  # under the raised threshold
        assert watch.findings()["blocking"] == []
        monkeypatch.setenv(lockwatch.SLEEP_MS_ENV, "not-a-number")
        with lk:
            time.sleep(0.02)  # malformed knob degrades to default 10ms
        assert len(watch.findings()["blocking"]) == 1

    def test_socket_send_under_lock_fires(self, watch):
        a, b = socket.socketpair()
        lk = threading.Lock()
        try:
            with lk:
                a.sendall(b"x")
            f = watch.findings()
            assert [x["call"] for x in f["blocking"]] == \
                ["socket.sendall"]
            assert f["blocking"][0]["count"] == 1
        finally:
            a.close()
            b.close()

    def test_socket_io_without_lock_is_fine(self, watch):
        a, b = socket.socketpair()
        try:
            a.sendall(b"x")
            assert b.recv(1) == b"x"
            assert watch.findings()["blocking"] == []
        finally:
            a.close()
            b.close()

    def test_subprocess_wait_under_lock_fires(self, watch):
        lk = threading.Lock()
        p = subprocess.Popen([sys.executable, "-c", "pass"])
        with lk:
            p.wait()
        f = watch.findings()
        assert [x["call"] for x in f["blocking"]] == ["subprocess.wait"]

    def test_blocking_ok_routes_to_allowed(self, watch):
        lk = threading.Lock()
        with lk:
            with lockwatch.blocking_ok("test: serialized stream"):
                time.sleep(0.02)
        f = watch.findings()
        assert f["blocking"] == []
        assert len(f["allowed"]) == 1
        assert f["allowed"][0]["reason"] == "test: serialized stream"

    def test_repeated_sightings_dedup_to_one_finding(self, watch):
        lk = threading.Lock()
        for _ in range(5):
            with lk:
                time.sleep(0.02)
        f = watch.findings()
        assert len(f["blocking"]) == 1
        assert f["blocking"][0]["count"] == 5


class TestReportAndChecker:
    def test_report_round_trip_clean(self, watch, tmp_path):
        path = str(tmp_path / "report.jsonl")
        watch.write_report(path)
        code, totals = lockwatch.check_report(path)
        assert code == 0
        assert totals["processes"] == 1
        assert totals["inversions"] == 0 and totals["blocking"] == 0

    def test_report_round_trip_findings(self, watch, tmp_path):
        lk = threading.Lock()
        with lk:
            time.sleep(0.02)
        path = str(tmp_path / "report.jsonl")
        watch.write_report(path)
        code, totals = lockwatch.check_report(path)
        assert code == 1
        assert totals["blocking"] == 1
        assert totals["details"][0]["kind"] == "blocking"
        # Machine-readable: every line parses, summary tagged.
        lines = [json.loads(x) for x in open(path)]
        assert lines[0]["lockwatch"] == 1

    def test_multi_process_reports_append_and_sum(self, watch,
                                                  tmp_path):
        path = str(tmp_path / "report.jsonl")
        watch.write_report(path)
        watch.write_report(path)  # a second "process"
        code, totals = lockwatch.check_report(path)
        assert code == 0
        assert totals["processes"] == 2

    def test_checker_bad_report_is_exit_2(self, tmp_path):
        assert lockwatch.check_report(str(tmp_path / "nope"))[0] == 2
        bad = tmp_path / "bad.jsonl"
        bad.write_text("this is not json\n")
        assert lockwatch.check_report(str(bad))[0] == 2
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        code, totals = lockwatch.check_report(str(empty))
        assert code == 2  # no summary lines: the run was not watched

    def test_checker_cli_exit_codes(self, watch, tmp_path):
        path = str(tmp_path / "report.jsonl")
        watch.write_report(path)
        proc = subprocess.run(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.analysis.lockwatch",
             "--check", path],
            cwd=REPO, capture_output=True, text=True, timeout=60,
        )
        assert proc.returncode == 0, proc.stderr
        assert "clean" in proc.stdout


class TestShimLifecycle:
    def test_install_is_idempotent_and_uninstall_restores(self):
        stock = (threading.Lock, threading.RLock, time.sleep,
                 subprocess.Popen.wait, dict(vars(socket.socket)))
        first = lockwatch.install()
        try:
            assert lockwatch.install() is False  # second arm: no-op
        finally:
            lockwatch.reset()
            lockwatch.uninstall()
        assert first is True
        # The port's shim restores what it found, not what it allocates
        # with: threading.RLock is a Python function over _thread.RLock.
        assert threading.Lock is lockwatch._RealLock
        assert threading.RLock is stock[1]
        assert time.sleep is stock[2] is lockwatch._real_sleep
        assert subprocess.Popen.wait is stock[3]
        assert dict(vars(socket.socket)) == stock[4]

    def test_third_party_lock_sites_get_real_locks(self, watch):
        """Only first-party construction sites are wrapped: a lock
        allocated from stdlib code (queue.Queue's mutex) must be a
        plain real lock, keeping the graph about OUR contracts."""
        import queue

        q = queue.Queue()
        assert not isinstance(q.mutex, lockwatch._WatchedLock)
        assert isinstance(threading.Lock(), lockwatch._WatchedLock)

    def test_env_shim_instruments_a_subprocess_unchanged(self, tmp_path):
        """TPU_LOCKWATCH=1 + package import = armed, report written at
        exit — zero code changes in the child, which imports only the
        port (the activation path of every subprocess)."""
        report = str(tmp_path / "child.jsonl")
        code = (
            "import container_engine_accelerators_tpu_torch\n"
            "import threading\n"
            "a = threading.Lock()\n"
            "b = threading.Lock()\n"
            "def t1():\n"
            "    with a:\n"
            "        with b: pass\n"
            "def t2():\n"
            "    with b:\n"
            "        with a: pass\n"
            "for fn in (t1, t2):\n"
            "    t = threading.Thread(target=fn); t.start(); t.join()\n"
            "import sys\n"
            "assert 'container_engine_accelerators_tpu' not in sys.modules\n"
        )
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO,
            capture_output=True, text=True, timeout=60,
            env={**os.environ, lockwatch.LOCKWATCH_ENV: "1",
                 lockwatch.REPORT_ENV: report},
        )
        assert proc.returncode == 0, proc.stderr
        rc, totals = lockwatch.check_report(report)
        assert rc == 1
        assert totals["inversions"] == 1

    def test_env_off_means_no_wrapping(self, tmp_path):
        """Without the env the package import must leave threading
        untouched — the shim is opt-in."""
        code = (
            "import container_engine_accelerators_tpu_torch\n"
            "import threading\n"
            "from container_engine_accelerators_tpu_torch.analysis import "
            "lockwatch\n"
            "assert threading.Lock is lockwatch._RealLock\n"
            "print('STOCK')\n"
        )
        env = {k: v for k, v in os.environ.items()
               if k != lockwatch.LOCKWATCH_ENV}
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO,
            capture_output=True, text=True, timeout=60, env=env,
        )
        assert proc.returncode == 0, proc.stderr
        assert "STOCK" in proc.stdout


# ---- two shims in one process -------------------------------------------


@pytest.fixture
def jax_shim():
    """The JAX package's shim, armed first and always rolled back."""
    from container_engine_accelerators_tpu.analysis import (
        lockwatch as jax_lockwatch,
    )

    jax_lockwatch.install()
    jax_lockwatch.reset()
    try:
        yield jax_lockwatch
    finally:
        jax_lockwatch.reset()
        jax_lockwatch.uninstall()


class TestTwoShims:
    def test_port_shim_declines_when_jax_shim_is_armed(self, jax_shim):
        assert lockwatch.foreign_shim()
        assert lockwatch.install() is False
        try:
            assert not lockwatch._active
            a = threading.Lock()
            # One wrapper, the JAX shim's, around a real lock.
            assert isinstance(a, jax_shim._WatchedLock)
            assert not isinstance(a, lockwatch._WatchedLock)
            assert not isinstance(a._real, (jax_shim._WatchedLock,
                                            lockwatch._WatchedLock))
            assert threading.Lock is jax_shim._lock_factory
        finally:
            lockwatch.uninstall()  # never armed: touches nothing
        assert threading.Lock is jax_shim._lock_factory

    def test_port_shim_arms_once_the_jax_shim_is_gone(self, jax_shim):
        jax_shim.uninstall()
        assert not lockwatch.foreign_shim()
        assert lockwatch.install() is True
        try:
            lock = threading.Lock()
            assert isinstance(lock, lockwatch._WatchedLock)
            assert type(lock._real) is type(lockwatch._RealLock())
        finally:
            lockwatch.reset()
            lockwatch.uninstall()

    def test_shim_files_are_never_construction_sites(self, watch):
        """Both shims' files are plumbing: a lock made through the JAX
        shim's allocator names the caller's line, not the shim's."""
        assert lockwatch._is_first_party(__file__)
        assert not lockwatch._is_first_party(lockwatch._THIS_FILE)
        assert not lockwatch._is_first_party(lockwatch._PEER_SHIM_FILE)
        assert os.path.exists(lockwatch._PEER_SHIM_FILE)
        assert lockwatch._PEER_SHIM_FILE in lockwatch._FRAME_SKIP
