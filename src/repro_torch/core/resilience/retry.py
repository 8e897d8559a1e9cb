"""One retry/backoff policy for every failure domain.

Before this module, each layer counted failures its own way: `maponly.py`
kept an ad-hoc ``max_retries`` integer, `blockstore.py` looped bare over
replicas, and nothing anywhere bounded *time* (a block that fails slowly
could spin a multi-hour out-of-core job forever). `RetryPolicy` is the one
definition of "try again":

  * bounded attempts (``max_attempts`` — the classic retry budget);
  * exponential backoff with **decorrelated jitter**
    (``sleep = min(cap, uniform(base, 3 * prev))``), which avoids the
    synchronized retry storms plain exponential backoff produces when many
    workers fail on the same shared resource;
  * a per-operation ``deadline_s`` (wall budget across all attempts);
  * explicit ``retryable`` exception classes — anything else fails fast;
  * injectable ``clock``/``sleep``/``seed`` so tests run instantly and
    chaos schedules stay deterministic.

The default policy (``base_delay_s=0``) retries immediately, which is
exactly the pre-existing behaviour of every caller — the policy changes
*where the decision lives*, not what a default-configured job does.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class RetryPolicy:
    """Immutable retry strategy; per-operation bookkeeping lives in
    `RetryState` (``policy.new_state()``), one state per block/op."""

    max_attempts: int = 3
    base_delay_s: float = 0.0      # 0 = retry immediately (legacy default)
    max_delay_s: float = 2.0       # decorrelated-jitter cap
    deadline_s: float | None = None  # wall budget across ALL attempts
    retryable: tuple = (Exception,)
    seed: int = 0                  # jitter RNG seed (deterministic tests)
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("backoff delays must be >= 0")

    # -------------------------------------------------------------- decide
    def retryable_exc(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def should_retry(self, attempts: int, elapsed: float,
                     exc: BaseException) -> bool:
        """May another attempt launch after ``attempts`` failures?

        ``attempts`` counts FAILED attempts so far (the manifest's
        ``attempts`` field after the current failure is journaled);
        ``elapsed`` is wall time since the op first started.
        """
        if not self.retryable_exc(exc):
            return False
        if attempts >= self.max_attempts:
            return False
        if self.deadline_s is not None and elapsed >= self.deadline_s:
            return False
        return True

    def next_delay(self, prev_delay: float, rng: random.Random) -> float:
        """Decorrelated jitter: ``min(cap, U(base, 3 * prev))``."""
        if self.base_delay_s <= 0 and prev_delay <= 0:
            return 0.0  # immediate-retry policy: never sleep
        lo = self.base_delay_s
        hi = max(3.0 * prev_delay, lo)
        d = rng.uniform(lo, hi) if hi > lo else lo
        return min(self.max_delay_s, d)

    # -------------------------------------------------------------- drive
    def new_state(self) -> "RetryState":
        return RetryState(self)

    def call(self, fn: Callable[[int], object]):
        """Run ``fn(attempt_index)`` (0-based) under this policy.

        The synchronous form, used where the whole retry loop fits in
        one call frame (e.g. `BlockStore.read_block`, where the attempt
        index selects the replica). Event-driven callers (the job runners,
        whose attempts resolve on other threads) use `should_retry` +
        `RetryState.backoff` directly. Raises the last attempt's exception
        when the budget is spent.
        """
        state = self.new_state()
        while True:
            try:
                return fn(state.attempts)
            except BaseException as exc:
                if not state.admit(exc):
                    raise


class RetryState:
    """Mutable per-operation retry bookkeeping (attempt count, deadline
    clock, jitter chain). Not thread-safe; guard externally if shared."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.attempts = 0          # failed attempts recorded so far
        self.last_error: BaseException | None = None
        self.t0 = policy.clock()
        self._rng = random.Random(policy.seed)
        self._prev_delay = policy.base_delay_s

    @property
    def elapsed(self) -> float:
        return self.policy.clock() - self.t0

    def admit(self, exc: BaseException, attempts: int | None = None) -> bool:
        """Record one failed attempt; True = backoff applied, retry now.

        ``attempts`` overrides the internal counter for callers whose
        durable attempt count lives elsewhere (the job manifest survives
        crash-restarts; this state does not).
        """
        self.attempts = self.attempts + 1 if attempts is None else attempts
        self.last_error = exc
        if not self.policy.should_retry(self.attempts, self.elapsed, exc):
            return False
        self.backoff()
        return True

    def backoff(self) -> float:
        """Sleep the next decorrelated-jitter delay; returns it."""
        d = self.policy.next_delay(self._prev_delay, self._rng)
        if d > 0:
            self._prev_delay = d
            self.policy.sleep(d)
        return d
