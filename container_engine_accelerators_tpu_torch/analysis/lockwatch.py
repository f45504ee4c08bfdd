"""Dynamic lock-order race detector — the ``go test -race`` analog.

Activated by ``TPU_LOCKWATCH=1`` (the package ``__init__`` installs the
shim on import, so any process that imports the stack — pytest, fleet
workers, CLIs — is covered with **no production code changes**), this
module monkey-patches ``threading.Lock``/``threading.RLock`` with
instrumented wrappers and watches three hazard classes:

- **Lock-order inversions.**  Every acquisition made while other locks
  are held adds an edge ``held-site -> acquired-site`` to a global
  lock-order graph (sites are ``file:line`` of the lock's construction,
  so all instances of one structural lock share a node, exactly like
  lockdep's lock classes).  A cycle in that graph — the classic ABBA —
  is a potential deadlock even if this run never interleaved badly.
  False-positive suppression: an opposing edge pair observed while both
  threads held a common **gate** lock cannot interleave and is reported
  under ``suppressed``, not ``inversions``; same-site self-edges (two
  instances of one lock class nested) are reported informationally
  under ``same_site_nesting`` because the graph cannot orient them.

- **Blocking calls under a lock.**  Socket sends/receives/accepts/
  connects on blocking sockets, ``subprocess`` waits, and sleeps of at
  least ``TPU_LOCKWATCH_SLEEP_MS`` (default 10) made while holding any
  watched lock.  Deliberate serialize-a-stream locks (the NRI trunk
  mux, PyXferd's per-peer streams) annotate with
  :func:`blocking_ok` — those sightings land in ``allowed`` with their
  reason, keeping the gate's ``blocking`` count honest.

- **Acquisition stacks.**  The first sighting of every edge and every
  blocking call records a trimmed stack, so the JSONL report points at
  code, not just at lock names.

Scope: only locks *constructed* from first-party code (this repo's
files) are wrapped; stdlib/third-party lock sites (logging, queue,
prometheus, jax) get real locks, which keeps the graph about OUR
ordering contracts and the overhead off foreign hot paths.

Reporting: findings feed ``counters`` (``analysis.lockwatch.*`` — the
flight recorder snapshots them with everything else) and a
machine-readable JSONL report written at process exit when
``TPU_LOCKWATCH_REPORT`` names a file (multi-process runs append; the
checker sums).  ``python -m container_engine_accelerators_tpu_torch.analysis.
lockwatch --check <report>`` is the gate half: exit 0 clean, 1 on any
inversion or unallowed blocking call, 2 on a missing/corrupt report.

Kept stdlib-only at import (counters are imported lazily at finding
time) so installing the shim from the package ``__init__`` cannot
recurse into modules whose locks it is about to wrap.

This is the port's own copy of the JAX package's
``analysis/lockwatch.py``: the same env variables, report format, exit
codes and ``analysis.lockwatch.*`` counters.  Both packages can be
imported into one process, so this copy takes its real allocators from
``_thread`` (never from ``threading``, which the other shim may have
re-bound), captures the blocking surfaces at :func:`install` time, and
declines to arm while another shim's allocators are in place: one
process is watched by one shim.  Both shims' files are plumbing to the
site and stack walks.
"""

import _thread
import atexit
import json
import os
import subprocess
import socket
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple

LOCKWATCH_ENV = "TPU_LOCKWATCH"
REPORT_ENV = "TPU_LOCKWATCH_REPORT"
SLEEP_MS_ENV = "TPU_LOCKWATCH_SLEEP_MS"
DEFAULT_SLEEP_MS = 10.0
STACK_LIMIT = 16

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_THIS_FILE = os.path.abspath(__file__)
# The JAX package's shim, by path only (never imported): when it wraps
# this one, or this one wraps it, its frames are plumbing, not the
# construction site of a lock.
_PEER_SHIM_FILE = os.path.join(
    _REPO_ROOT, "container_engine_accelerators_tpu", "analysis",
    "lockwatch.py")
_SHIM_FILES = frozenset({_THIS_FILE, _PEER_SHIM_FILE})

# The real allocators come from ``_thread``: ``threading.Lock`` may
# already be another shim's factory when this module is imported.  The
# instrumentation's own state lock can never be a watched lock.
_RealLock = _thread.allocate_lock
_RealRLock = _thread.RLock
_SOCK_METHODS = ("send", "sendall", "sendmsg", "recv", "recv_into",
                 "recvfrom", "accept", "connect")


def _socket_methods() -> Dict[str, object]:
    """Each watched method as ``socket.socket`` resolves it now: its own
    class dict first (``accept``, ``sendfile`` and any patch live
    there), then the C base's."""
    out = {}
    for m in _SOCK_METHODS:
        for klass in socket.socket.__mro__:
            if m in vars(klass):
                out[m] = vars(klass)[m]
                break
    return out


# The patched surfaces as they were when the shim armed; install()
# refreshes them, uninstall() puts them back.
_orig_lock = threading.Lock
_orig_rlock = threading.RLock
_real_sleep = time.sleep
_real_popen_wait = subprocess.Popen.wait
_real_sock = _socket_methods()
# Methods that were socket.socket's own before install (the rest are
# inherited and are deleted again on uninstall).
_own_sock: Set[str] = set()

# Exact plumbing files whose frames are instrumentation noise, never
# user code.  Matched by full path — a *suffix* match would also eat
# first-party test files.
_FRAME_SKIP = _SHIM_FILES | frozenset({
    os.path.abspath(threading.__file__),
})
_CALLSITE_SKIP = _FRAME_SKIP | frozenset({
    os.path.abspath(socket.__file__),
    os.path.abspath(subprocess.__file__),
})

_active = False
_installed = False
_state = _RealLock()  # guards the graph + finding stores (leaf, unwatched)
_edges: Dict[Tuple[str, str], dict] = {}
_blocking: Dict[Tuple[str, str, str], dict] = {}
_allowed: Dict[Tuple[str, str, str], dict] = {}
_inv_counted = 0  # inversions already fed to the counter (delta base)
_tls = threading.local()


def _tstate():
    st = getattr(_tls, "state", None)
    if st is None:
        st = _tls.state = {"held": [], "guard": False, "allow": []}
    return st


def _sleep_threshold_s() -> float:
    """Sleeps under a lock shorter than this are backoff idiom, not a
    hazard; malformed values degrade to the default (the
    TPU_FAULT_SPEC rule)."""
    raw = os.environ.get(SLEEP_MS_ENV)
    if raw is None:
        return DEFAULT_SLEEP_MS / 1e3
    try:
        ms = float(raw)
        if not ms >= 0:
            raise ValueError("threshold must be >= 0")
        return ms / 1e3
    except ValueError:
        return DEFAULT_SLEEP_MS / 1e3


def _shorten(path: str) -> str:
    """Repo-relative path for sites and stacks — stable across hosts."""
    ap = os.path.abspath(path)
    if ap.startswith(_REPO_ROOT + os.sep):
        return ap[len(_REPO_ROOT) + 1:]
    return path


def _is_first_party(path: str) -> bool:
    ap = os.path.abspath(path)
    return (ap.startswith(_REPO_ROOT + os.sep)
            and ap not in _SHIM_FILES)


def _construction_site() -> Optional[str]:
    """``file:line`` of the frame that called ``threading.Lock()`` —
    the lock's class identity.  None for non-first-party sites (those
    get real locks)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) not in _FRAME_SKIP:
            if _is_first_party(fn):
                return f"{_shorten(fn)}:{f.f_lineno}"
            return None
        f = f.f_back
    return None


def _stack() -> List[str]:
    """Trimmed, repo-relative acquisition stack (instrumentation and
    interpreter plumbing frames dropped)."""
    out = []
    for fr in traceback.extract_stack(limit=STACK_LIMIT):
        if os.path.abspath(fr.filename) in _FRAME_SKIP:
            continue
        out.append(f"{_shorten(fr.filename)}:{fr.lineno} {fr.name}")
    return out


def _callsite() -> str:
    """First non-instrumentation frame — the dedup key for blocking
    findings (one finding per code location, with a count)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) not in _CALLSITE_SKIP:
            return f"{_shorten(fn)}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _inc(name: str, n: int = 1) -> None:
    """Lazy counters.inc — imported at finding time so this module's
    import (from the package __init__, before anything else) never
    drags obs/ in early.  Guarded: metric emission must not feed the
    graph it is reporting on."""
    st = _tstate()
    if st["guard"]:
        return
    st["guard"] = True
    try:
        from container_engine_accelerators_tpu_torch.metrics import counters
        counters.inc(name, n)
    except Exception:  # lint: disable=swallowed-exception
        pass  # the detector's reporting must never break the detected
    finally:
        st["guard"] = False


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


class _Held:
    __slots__ = ("lock", "count")

    def __init__(self, lock):
        self.lock = lock
        self.count = 1


def _note_acquired(lock: "_WatchedLock") -> None:
    st = _tstate()
    if st["guard"]:
        return
    held = st["held"]
    for h in held:
        if h.lock is lock:
            h.count += 1  # reentrant re-acquire: no new edges
            return
    if held:
        st["guard"] = True
        try:
            _record_edges(held, lock)
        finally:
            st["guard"] = False
    held.append(_Held(lock))


def _note_released(lock: "_WatchedLock") -> None:
    held = _tstate()["held"]
    for i in range(len(held) - 1, -1, -1):
        if held[i].lock is lock:
            held[i].count -= 1
            if held[i].count <= 0:
                del held[i]
            return


def _record_edges(held: List[_Held], acquired: "_WatchedLock") -> None:
    """One edge per distinct held site -> the acquired site, carrying
    the gate set (other locks held at this sighting), the thread, and
    a first-sighting stack."""
    sites = [h.lock._site for h in held]
    dst = acquired._site
    tname = threading.current_thread().name
    stack = None
    with _state:
        for i, src in enumerate(sites):
            guards = set(sites[:i] + sites[i + 1:])
            e = _edges.get((src, dst))
            if e is None:
                if stack is None:
                    stack = _stack()
                _edges[(src, dst)] = {
                    "guards": guards, "threads": {tname},
                    "count": 1, "stack": stack,
                }
            else:
                e["guards"] &= guards
                e["threads"].add(tname)
                e["count"] += 1


class _WatchedLock:
    """Instrumented ``threading.Lock``: real lock + order bookkeeping."""

    _reentrant = False

    def __init__(self, site: str):
        self._real = _RealLock()
        self._site = site

    def acquire(self, blocking=True, timeout=-1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            _note_acquired(self)
        return ok

    def release(self):
        _note_released(self)
        self._real.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._real.locked()

    def __repr__(self):
        return f"<lockwatch {type(self).__name__} site={self._site}>"


class _WatchedRLock(_WatchedLock):
    """Instrumented ``threading.RLock`` — also speaks the private
    Condition protocol (``_is_owned``/``_release_save``/
    ``_acquire_restore``) so ``threading.Condition(watched_rlock)``
    keeps working, with the bookkeeping released across waits exactly
    like the lock itself."""

    _reentrant = True

    def __init__(self, site: str):
        self._real = _RLock_orig()
        self._site = site

    def _is_owned(self):
        return self._real._is_owned()

    def _release_save(self):
        st = _tstate()
        count = 0
        for i in range(len(st["held"]) - 1, -1, -1):
            if st["held"][i].lock is self:
                count = st["held"][i].count
                del st["held"][i]
                break
        return (self._real._release_save(), count)

    def _acquire_restore(self, state):
        inner, count = state
        self._real._acquire_restore(inner)
        if count:
            held = _tstate()["held"]
            h = _Held(self)
            h.count = count
            held.append(h)


def _RLock_orig():
    # threading.RLock may itself have been re-bound by install(); the
    # captured original is the only safe allocator here.
    return _RealRLock()


def _lock_factory():
    if _active:
        site = _construction_site()
        if site is not None:
            return _WatchedLock(site)
    return _RealLock()


def _rlock_factory():
    if _active:
        site = _construction_site()
        if site is not None:
            return _WatchedRLock(site)
    return _RealRLock()


# ---------------------------------------------------------------------------
# blocking-call detection
# ---------------------------------------------------------------------------


def _note_blocking(call: str, seconds: Optional[float] = None) -> None:
    st = _tstate()
    if st["guard"] or not st["held"]:
        return
    locks = tuple(h.lock._site for h in st["held"])
    st["guard"] = True
    try:
        site = _callsite()
        key = (call, site, "+".join(locks))
        tname = threading.current_thread().name
        if st["allow"]:
            store, counter = _allowed, "analysis.lockwatch.allowed"
            reason = st["allow"][-1]
        else:
            store, counter = _blocking, "analysis.lockwatch.blocking"
            reason = None
        with _state:
            f = store.get(key)
            if f is None:
                f = store[key] = {
                    "call": call, "site": site, "locks": list(locks),
                    "threads": {tname}, "count": 0, "stack": _stack(),
                }
                if reason is not None:
                    f["reason"] = reason
                if seconds is not None:
                    f["seconds"] = seconds
                new = True
            else:
                f["threads"].add(tname)
                new = False
            f["count"] += 1
    finally:
        st["guard"] = False
    if new:
        _inc(counter)


@contextmanager
def blocking_ok(reason: str):
    """Annotate a deliberate blocking-under-lock region (a lock whose
    whole purpose is serializing one stream's writes).  Sightings
    inside land in the report's ``allowed`` list — named, counted,
    visible — instead of failing the gate.  Free when the shim is
    inactive."""
    if not _active:
        yield
        return
    st = _tstate()
    st["allow"].append(reason)
    try:
        yield
    finally:
        st["allow"].pop()


def _watched_sleep(seconds):
    try:
        if _active and seconds >= _sleep_threshold_s():
            _note_blocking("time.sleep", seconds=seconds)
    except TypeError:
        pass
    return _real_sleep(seconds)


def _watched_popen_wait(self, timeout=None):
    if _active:
        _note_blocking("subprocess.wait")
    return _real_popen_wait(self, timeout=timeout)


def _make_sock_wrapper(name, orig):
    def wrapper(self, *args, **kwargs):
        if _active:
            try:
                blocking = self.gettimeout() != 0
            except OSError:
                blocking = True
            if blocking:
                _note_blocking(f"socket.{name}")
        return orig(self, *args, **kwargs)

    wrapper.__name__ = name
    return wrapper


# ---------------------------------------------------------------------------
# install / report / gate
# ---------------------------------------------------------------------------


def enabled(env=None) -> bool:
    env = env if env is not None else os.environ
    return env.get(LOCKWATCH_ENV) == "1"


_STOCK_MODULES = ("_thread", "threading", __name__)


def foreign_shim() -> bool:
    """Whether another shim's allocators are in place (the JAX
    package's, armed first in this process): stock allocators belong to
    ``_thread`` or ``threading``."""
    return any(getattr(alloc, "__module__", None) not in _STOCK_MODULES
               for alloc in (threading.Lock, threading.RLock))


def install() -> bool:
    """Arm the shim: patch the lock allocators and the blocking-call
    surfaces, and register the exit-time report writer.  Idempotent;
    returns True when newly installed, False when already armed or when
    another shim is (this one then stays off)."""
    global _active, _installed, _real_sleep, _real_popen_wait, _real_sock
    global _orig_lock, _orig_rlock
    if _installed:
        _active = True
        return False
    if foreign_shim():
        return False
    _installed = True
    _active = True
    _orig_lock, _orig_rlock = threading.Lock, threading.RLock
    _real_sleep = time.sleep
    _real_popen_wait = subprocess.Popen.wait
    _real_sock = _socket_methods()
    _own_sock.clear()
    _own_sock.update(m for m in _SOCK_METHODS
                     if m in vars(socket.socket))
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    time.sleep = _watched_sleep
    subprocess.Popen.wait = _watched_popen_wait
    for m in _SOCK_METHODS:
        setattr(socket.socket, m, _make_sock_wrapper(m, _real_sock[m]))
    atexit.register(_atexit_report)
    return True


def uninstall() -> None:
    """Restore every patched surface.  Locks handed out while active
    keep their bookkeeping (release still balances), but no new edges
    or findings are recorded."""
    global _active, _installed
    if not _installed:
        _active = False
        return
    _active = False
    _installed = False
    threading.Lock = _orig_lock
    threading.RLock = _orig_rlock
    time.sleep = _real_sleep
    subprocess.Popen.wait = _real_popen_wait
    for m in _SOCK_METHODS:
        if m in _own_sock:
            setattr(socket.socket, m, _real_sock[m])
        else:
            delattr(socket.socket, m)


def reset() -> None:
    """Drop the graph and the finding stores — test isolation."""
    global _inv_counted
    with _state:
        _edges.clear()
        _blocking.clear()
        _allowed.clear()
        _inv_counted = 0


def _cycles() -> Tuple[List[dict], List[dict], List[dict]]:
    """(inversions, suppressed, same_site_nesting) from the edge set.

    Two-node cycles (the ABBA shape) are judged pairwise; a pair whose
    opposing sightings always shared a common gate lock cannot
    interleave and is suppressed.  Larger strongly-connected components
    are reported whole, with the same all-edges gate test."""
    with _state:
        edges = {k: {"guards": set(v["guards"]),
                     "threads": set(v["threads"]),
                     "count": v["count"], "stack": list(v["stack"])}
                 for k, v in _edges.items()}
    inversions: List[dict] = []
    suppressed: List[dict] = []
    nesting: List[dict] = []
    pair_nodes: Set[str] = set()
    for (src, dst), e in sorted(edges.items()):
        if src == dst:
            nesting.append({"site": src, "count": e["count"],
                            "threads": sorted(e["threads"]),
                            "stack": e["stack"]})
            continue
        if (dst, src) in edges and src < dst:
            rev = edges[(dst, src)]
            entry = {
                "cycle": [src, dst],
                "threads": sorted(e["threads"] | rev["threads"]),
                "counts": {f"{src}->{dst}": e["count"],
                           f"{dst}->{src}": rev["count"]},
                "stacks": {f"{src}->{dst}": e["stack"],
                           f"{dst}->{src}": rev["stack"]},
            }
            gates = e["guards"] & rev["guards"]
            pair_nodes.update((src, dst))
            if gates:
                entry["gates"] = sorted(gates)
                suppressed.append(entry)
            else:
                inversions.append(entry)
    # Longer cycles: SCCs of the remaining graph (pairwise cycles are
    # already judged above; exclude their nodes so one ABBA does not
    # also surface as its enclosing component).
    adj: Dict[str, Set[str]] = {}
    for (src, dst) in edges:
        if src != dst and src not in pair_nodes and dst not in pair_nodes:
            adj.setdefault(src, set()).add(dst)
            adj.setdefault(dst, set())
    for comp in _sccs(adj):
        if len(comp) < 2:
            continue
        comp_edges = [(s, d) for (s, d) in edges
                      if s in comp and d in comp and s != d]
        gates = None
        threads: Set[str] = set()
        for k in comp_edges:
            g = edges[k]["guards"]
            gates = set(g) if gates is None else gates & g
            threads |= edges[k]["threads"]
        entry = {
            "cycle": sorted(comp),
            "threads": sorted(threads),
            "counts": {f"{s}->{d}": edges[(s, d)]["count"]
                       for (s, d) in comp_edges},
            "stacks": {f"{s}->{d}": edges[(s, d)]["stack"]
                       for (s, d) in comp_edges},
        }
        if gates:
            entry["gates"] = sorted(gates)
            suppressed.append(entry)
        else:
            inversions.append(entry)
    return inversions, suppressed, nesting


def _sccs(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan — the graph is tiny but recursion limits are
    not a failure mode a detector gets to have."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]
    for root in adj:
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def findings() -> dict:
    """Everything the detector knows, as one JSON-ready blob.
    Idempotent for the counter: only inversions NEW since the last
    call are fed to it (assert_clean + the atexit report must not
    double-count one finding)."""
    global _inv_counted
    inversions, suppressed, nesting = _cycles()
    if len(inversions) > _inv_counted:
        _inc("analysis.lockwatch.inversions",
             len(inversions) - _inv_counted)
        _inv_counted = len(inversions)

    def _flat(store):
        with _state:
            return [dict(v, threads=sorted(v["threads"]))
                    for _, v in sorted(store.items())]

    with _state:
        n_edges = len(_edges)
    return {
        "inversions": inversions,
        "suppressed": suppressed,
        "same_site_nesting": nesting,
        "blocking": _flat(_blocking),
        "allowed": _flat(_allowed),
        "edges": n_edges,
    }


def assert_clean() -> None:
    """Raise AssertionError on any gate-failing finding — the
    in-process hook for tests."""
    f = findings()
    problems = []
    if f["inversions"]:
        problems.append(f"{len(f['inversions'])} lock-order inversion(s)")
    if f["blocking"]:
        problems.append(f"{len(f['blocking'])} blocking call(s) under "
                        f"a lock")
    assert not problems, (
        f"lockwatch: {', '.join(problems)}: "
        + json.dumps({k: f[k] for k in ('inversions', 'blocking')},
                     default=sorted)
    )


def write_report(path: str) -> dict:
    """Append this process's findings to ``path`` as JSONL: one
    summary line (``{"lockwatch": 1, ...counts, "pid": ...}``) then
    one line per finding, each tagged with its kind.  Multi-process
    runs (fleet workers) append to the same file; the checker sums."""
    blob = findings()
    lines = [json.dumps({
        "lockwatch": 1, "pid": os.getpid(),
        "edges": blob["edges"],
        "inversions": len(blob["inversions"]),
        "blocking": len(blob["blocking"]),
        "allowed": len(blob["allowed"]),
        "suppressed": len(blob["suppressed"]),
        "same_site_nesting": len(blob["same_site_nesting"]),
    })]
    for kind in ("inversions", "suppressed", "same_site_nesting",
                 "blocking", "allowed"):
        for entry in blob[kind]:
            lines.append(json.dumps(dict(entry, kind=kind),
                                    default=sorted))
    with open(path, "a") as fh:
        fh.write("\n".join(lines) + "\n")
    return blob


def _atexit_report() -> None:
    path = os.environ.get(REPORT_ENV)
    if not path or not _active:
        return
    try:
        write_report(path)
    except OSError:  # pragma: no cover - a bad path must not mask exit
        pass


def check_report(path: str) -> Tuple[int, dict]:
    """Read an (appended, multi-process) JSONL report; return
    (exit_code, totals).  Exit contract: 0 clean, 1 findings, 2
    missing/corrupt report (an internal error, not a verdict)."""
    totals = {"processes": 0, "edges": 0, "inversions": 0,
              "blocking": 0, "allowed": 0, "suppressed": 0,
              "same_site_nesting": 0}
    details: List[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("lockwatch") == 1:
                    totals["processes"] += 1
                    for k in ("edges", "inversions", "blocking",
                              "allowed", "suppressed",
                              "same_site_nesting"):
                        totals[k] += int(rec.get(k, 0))
                elif rec.get("kind") in ("inversions", "blocking"):
                    details.append(rec)
    except (OSError, ValueError) as e:
        return 2, {"error": str(e), "path": path}
    if totals["processes"] == 0:
        return 2, dict(totals, error="no lockwatch summary lines "
                                     "(did the run have "
                                     "TPU_LOCKWATCH=1?)", path=path)
    code = 1 if (totals["inversions"] or totals["blocking"]) else 0
    return code, dict(totals, details=details)


def main(argv: Optional[List[str]] = None) -> int:
    """``--check <report.jsonl>`` gate CLI (the tail of a lockwatch run)."""
    import argparse

    parser = argparse.ArgumentParser(
        description="lockwatch report checker: exit 0 clean, 1 on "
                    "inversions/blocking-under-lock, 2 on a bad report")
    parser.add_argument("--check", required=True, metavar="REPORT",
                        help="JSONL report written under "
                             "TPU_LOCKWATCH_REPORT")
    args = parser.parse_args(argv)
    code, totals = check_report(args.check)
    print(json.dumps(totals, indent=2, default=sorted))
    if code == 0:
        print(f"lockwatch: clean ({totals['processes']} process(es), "
              f"{totals['edges']} edge(s), "
              f"{totals['allowed']} allowed blocking site(s), "
              f"{totals['suppressed']} gate-suppressed pair(s))")
    elif code == 1:
        print(f"lockwatch: FAIL — {totals['inversions']} inversion(s), "
              f"{totals['blocking']} blocking-under-lock finding(s)",
              file=sys.stderr)
    else:
        print(f"lockwatch: internal error: {totals.get('error')}",
              file=sys.stderr)
    return code


if __name__ == "__main__":  # pragma: no cover - exercised via CLI tests
    sys.exit(main())
