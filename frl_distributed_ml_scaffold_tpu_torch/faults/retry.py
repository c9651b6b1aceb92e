"""One retry policy for every retrying tier: the port of the JAX
package's ``faults/retry.py``.

- **Exponential backoff with a cap**: ``delay(attempt) =
  min(backoff_s * 2**(attempt-1), max_backoff_s)``.
- **Seeded jitter**: ``jitter`` spreads each delay uniformly over
  ``[d*(1-jitter), d*(1+jitter)]`` from a ``random.Random(seed)``, so a
  replay gives the same delays.
- **A budget, not a promise**: ``max_retries`` retries after the first
  try, then the last exception propagates.

``call`` is the sleeping form (the data pipeline's batch builds). Every
retry is logged: a silent retry is the failure mode this exists to end.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Iterator, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + jitter + budget; see the module docstring."""

    max_retries: int = 3
    backoff_s: float = 1.0
    max_backoff_s: float = 60.0
    jitter: float = 0.0  # fraction of the delay, uniform, seeded
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} < 0")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError(
                f"negative backoff ({self.backoff_s}, {self.max_backoff_s})"
            )
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter={self.jitter} outside [0, 1)")

    def delay(
        self, attempt: int, rng: Optional[random.Random] = None
    ) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        if attempt < 1:
            raise ValueError(f"attempt={attempt} < 1 (1-based)")
        d = min(self.backoff_s * (2.0 ** (attempt - 1)), self.max_backoff_s)
        if self.jitter and d > 0:
            r = rng if rng is not None else random.Random(self.seed)
            d *= 1.0 + self.jitter * (2.0 * r.random() - 1.0)
        return d

    def delays(self) -> Iterator[float]:
        """The full budgeted delay sequence (one shared jitter stream —
        deterministic per seed)."""
        rng = random.Random(self.seed)
        for attempt in range(1, self.max_retries + 1):
            yield self.delay(attempt, rng)

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        retry_on: tuple = (Exception,),
        describe: str = "",
        logger: Any | None = None,
        counter: Any | None = None,
        on_retry: Callable[[int, BaseException], None] | None = None,
        sleep: Callable[[float], None] = time.sleep,
        **kwargs: Any,
    ) -> Any:
        """Run ``fn`` under the policy: on a ``retry_on`` exception, log
        it, count it (``counter.inc()`` when given), back off, retry; the
        budget's last exception propagates unchanged. Anything outside
        ``retry_on`` propagates immediately — a retry loop must never
        absorb KeyboardInterrupt or a programming error it wasn't told
        about."""
        rng = random.Random(self.seed)
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                # Only retries performed are counted: the failure that
                # exhausts the budget propagates and is not a retry.
                if counter is not None:
                    counter.inc()
                if on_retry is not None:
                    on_retry(attempt, e)
                d = self.delay(attempt, rng)
                if logger is None:
                    from frl_distributed_ml_scaffold_tpu_torch.utils.logging import (
                        get_logger,
                    )

                    logger = get_logger()
                logger.warning(
                    "retry %d/%d%s in %.3fs after %s: %s",
                    attempt,
                    self.max_retries,
                    f" for {describe}" if describe else "",
                    d,
                    type(e).__name__,
                    e,
                )
                if d > 0:
                    sleep(d)
