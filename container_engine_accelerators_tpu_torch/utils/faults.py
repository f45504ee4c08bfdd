"""Deterministic fault injection, copied from
``container_engine_accelerators_tpu/utils/faults.py`` so that the port
imports nothing of the JAX package.  The spec grammar, the errors, the
``fault.fired.<site>`` counters and the ``fault=<site>`` stamp on the
span a fault kills are the same.

Sites wired in the port:

    checkpoint.save   TrainCheckpointer.save
    health.stream     the health checker's Xid event-wait loop
    kubelet.register  the device plugin's Register RPC to the kubelet
    k8s.patch         the maintenance watcher's node-taint patch

A named site (``faults.check("kubelet.register")``) raises when armed
from the ``TPU_FAULT_SPEC`` environment variable, so the binary that
runs on a node can be told to fail its Nth attempt::

    TPU_FAULT_SPEC="kubelet.register:fail@1;health.stream:drop@1x2"

    site:mode[@N][xK]   fire on the Nth hit of the site (1-based,
                        default 1), for K consecutive hits (default 1,
                        ``*`` = forever).

Modes: ``fail`` raises FaultInjectedError, ``drop`` raises
InjectedConnectionDrop, ``conflict`` raises InjectedConflict (``status
= 409``, what the maintenance watcher's 409 retry keys on) — all
``OSError`` subclasses, so the code's own ``except OSError`` paths treat
them as the real failure.  A fired site counts ``fault.fired.<site>`` in
``metrics/counters.py``, which ``/metrics`` exports as ``agent_events``,
and stamps ``fault=<site>`` and ``fault_mode`` on the active span
(``obs/trace.py``), so a trace shows which attempt the injection killed.
A malformed entry is logged and skipped, never raised.
"""

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import trace

log = logging.getLogger(__name__)

TPU_FAULT_SPEC_ENV = "TPU_FAULT_SPEC"


class FaultInjectedError(OSError):
    """An armed fault site fired (generic failure)."""


class InjectedConnectionDrop(FaultInjectedError):
    """An armed fault site fired emulating the peer dropping the link."""


class InjectedConflict(FaultInjectedError):
    """An armed fault site fired emulating an HTTP 409 Conflict."""

    status = 409


_MODES = {
    "fail": FaultInjectedError,
    "drop": InjectedConnectionDrop,
    "conflict": InjectedConflict,
}
FOREVER = -1


@dataclasses.dataclass
class FaultRule:
    site: str
    mode: str
    at: int = 1  # fire starting at the Nth hit (1-based)
    times: int = 1  # consecutive hits to fire for; FOREVER = every hit

    def fires(self, hit: int) -> bool:
        if hit < self.at:
            return False
        return self.times == FOREVER or hit < self.at + self.times


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a TPU_FAULT_SPEC string; malformed entries are logged and
    skipped, never raised."""
    rules: List[FaultRule] = []
    for entry in spec.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            site, _, action = entry.partition(":")
            if not site or not action:
                raise ValueError("expected site:mode[@N][xK]")
            mode, _, position = action.partition("@")
            at, times = 1, 1
            if position:
                n, _, k = position.partition("x")
                at = int(n)
                if k == "*":
                    times = FOREVER
                elif k:
                    # Validate before any sentinel mapping: "x-1" must be
                    # rejected, not collide with the FOREVER sentinel.
                    times = int(k)
                    if times < 1:
                        raise ValueError("xK must be >= 1")
            if mode not in _MODES:
                raise ValueError(f"unknown mode {mode!r}")
            if at < 1:
                raise ValueError("@N must be >= 1")
            rules.append(FaultRule(site=site, mode=mode, at=at, times=times))
        except (ValueError, TypeError) as e:
            log.error("ignoring malformed %s entry %r: %s",
                      TPU_FAULT_SPEC_ENV, entry, e)
    return rules


class FaultInjector:
    """Hit-counting fault arming for named sites (thread-safe)."""

    def __init__(self, rules: Optional[List[FaultRule]] = None):
        self._rules = list(rules or [])
        self._hits: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        return cls(parse_spec(spec))

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "FaultInjector":
        env = env if env is not None else os.environ
        return cls.from_spec(env.get(TPU_FAULT_SPEC_ENV, ""))

    @property
    def rules(self) -> List[FaultRule]:
        return list(self._rules)

    def check(self, site: str) -> None:
        """Record a hit on ``site``; raise if an armed rule fires."""
        if not self._rules:  # fast path: injection off (the default)
            return
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            rule = next(
                (r for r in self._rules
                 if r.site == site and r.fires(hit)), None,
            )
            if rule is None:
                return
            self._fired[site] = self._fired.get(site, 0) + 1
        counters.inc(f"fault.fired.{site}")
        trace.annotate(fault=site, fault_mode=rule.mode)
        log.warning("fault injection: %s %s at hit %d", site, rule.mode, hit)
        raise _MODES[rule.mode](
            f"injected {rule.mode} at fault site {site!r} (hit {hit})"
        )

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self._fired.get(site, 0)
            return sum(self._fired.values())


# ---- process-global injector (what the call sites use) ----------------------

_global: Optional[FaultInjector] = None
_global_lock = threading.Lock()


def injector() -> FaultInjector:
    """The process injector, lazily armed from TPU_FAULT_SPEC."""
    global _global
    inj = _global
    if inj is not None:
        return inj
    with _global_lock:
        if _global is None:
            _global = FaultInjector.from_env()
            if _global.rules:
                log.warning("fault injection ARMED: %s", _global.rules)
        return _global


def check(site: str) -> None:
    """The one-liner call sites use: no-op unless armed."""
    injector().check(site)


def set_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Swap the process injector (None: re-arm lazily from the
    environment); returns the previous one."""
    global _global
    with _global_lock:
        prev, _global = _global, inj
        return prev


@contextlib.contextmanager
def armed(spec: str):
    """Scope an explicit spec over the process injector (tests)::

        with faults.armed("kubelet.register:fail@1") as inj:
            ...
            assert inj.fired("kubelet.register") == 1
    """
    inj = FaultInjector.from_spec(spec)
    prev = set_injector(inj)
    try:
        yield inj
    finally:
        set_injector(prev)
