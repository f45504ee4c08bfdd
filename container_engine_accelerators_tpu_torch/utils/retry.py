"""Retry budget for calls that touch a flaky resource — the part of
``container_engine_accelerators_tpu/utils/retry.py`` that the port's
checkpointer uses (``RetryPolicy.attempts`` and ``backoff_s``), copied
so that the port imports nothing of the JAX package.  The JAX module's
counters, spans and flight-recorder hooks are left out.

The correct response to a transient ``OSError`` (a checkpoint mount
that flaps under node pressure) is exponential backoff with jitter
under a bounded budget: never an unbounded spin, never a one-strike
crash.
"""

import dataclasses
import logging
import random
import time
from typing import Callable, Iterator, Optional

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
            sleep(delay)
