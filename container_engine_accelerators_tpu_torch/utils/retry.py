"""Retry budget for calls that touch a flaky resource — the part of
``container_engine_accelerators_tpu/utils/retry.py`` that the port uses
(``RetryPolicy.attempts`` and ``backoff_s`` for the checkpointer and the
kubelet registration, ``call`` for the NRI plugin's dial), copied so
that the port imports nothing of the JAX package.  ``call`` opens one
``retry.attempt`` span an attempt and, once the budget is spent, counts
``retry.exhausted`` and dumps the flight recorder (``obs/flight.py``),
as the JAX module does.

The correct response to a transient ``OSError`` (a checkpoint mount
that flaps under node pressure, a runtime socket mid-restart) is
exponential backoff with jitter under a bounded budget: never an
unbounded spin, never a one-strike crash.
"""

import dataclasses
import logging
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import flight, trace

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + deadline.

    ``max_attempts`` counts total tries (first try included).  Sleeps
    happen *between* attempts: ``backoff_s(0)`` is the delay after the
    first failure.
    """

    max_attempts: int = 5
    initial_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1  # ± fraction of the computed backoff
    deadline_s: Optional[float] = None

    def backoff_s(self, attempt: int, rng: Callable[[], float] = random.random
                  ) -> float:
        base = min(
            self.initial_backoff_s * (self.multiplier ** attempt),
            self.max_backoff_s,
        )
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * rng() - 1.0)
        return max(base, 0.0)

    def attempts(
        self,
        sleep: Callable[[float], object] = time.sleep,
        monotonic: Callable[[], float] = time.monotonic,
    ) -> Iterator[int]:
        """Yield attempt indices 0..max_attempts-1, sleeping the backoff
        between yields and stopping early once ``deadline_s`` would be
        exceeded.  The caller breaks out on success; exhausting the
        iterator means the budget is spent::

            for attempt in policy.attempts():
                try:
                    return do_thing()
                except OSError as e:
                    last = e
            raise last

        ``sleep`` is injectable so tests can run the loop instantly.
        """
        start = monotonic()
        for attempt in range(max(1, self.max_attempts)):
            yield attempt
            if attempt + 1 >= self.max_attempts:
                break
            delay = self.backoff_s(attempt)
            if (
                self.deadline_s is not None
                and monotonic() - start + delay > self.deadline_s
            ):
                log.debug("retry deadline %.1fs reached after attempt %d",
                          self.deadline_s, attempt + 1)
                break
            counters.inc("retry.attempts")
            sleep(delay)

    def call(
        self,
        fn: Callable,
        *args,
        retry_on: Tuple[Type[BaseException], ...] = (OSError,),
        sleep: Callable[[float], object] = time.sleep,
        on_retry: Optional[Callable[[int, BaseException], object]] = None,
        **kwargs,
    ):
        """Run ``fn`` under this policy; re-raise the last error once the
        budget is spent.  Each attempt is a ``retry.attempt`` span (fn and
        attempt attributes), so a slow recovery's trace shows every try;
        ``on_retry(attempt, error)`` runs after each failed one."""
        name = getattr(fn, "__name__", str(fn))
        last: Optional[BaseException] = None
        for attempt in self.attempts(sleep=sleep):
            try:
                with trace.span("retry.attempt", fn=name, attempt=attempt):
                    return fn(*args, **kwargs)
            except retry_on as e:  # the loop is the point
                last = e
                if on_retry is not None:
                    on_retry(attempt, e)
                log.warning("attempt %d/%d of %s failed: %s", attempt + 1,
                            self.max_attempts, name, e)
        counters.inc("retry.exhausted")
        flight.on_terminal(f"retry budget exhausted: {name}")
        assert last is not None
        raise last
