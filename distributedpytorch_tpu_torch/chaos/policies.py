"""The one retry/backoff, timeout and circuit breaker, the counterpart
of ``distributedpytorch_tpu/chaos/policies.py``.

:class:`Retry` (exponential backoff with seeded jitter, bounded by
attempts and/or a deadline), :class:`Timeout` (a hard wall-clock bound on
a call, on a daemon thread) and :class:`CircuitBreaker` (consecutive
failures open it; an optional half-open probe after a cooldown).  Stdlib
only.  ``time.sleep``/clock calls resolve through the ``time`` module at
call time, so tests that patch them drive these policies too.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable


class RetryBudgetExceededError(RuntimeError):
    """Every attempt failed and the retry budget (attempts/deadline) is
    spent; ``__cause__`` carries the last exception."""


class PolicyTimeoutError(TimeoutError):
    """The wrapped call exceeded its :class:`Timeout` bound."""


class CircuitOpenError(RuntimeError):
    """The breaker is open: calls are refused without touching the
    protected dependency."""


class Retry:
    """Exponential backoff with optional jitter, bounded by attempt count
    and/or wall-clock deadline.

    The backoff sequence is ``min(cap_s, base_s * 2**(attempt-1))`` (the
    exponent clamped so an unbounded poll can't overflow float math — the
    rule of the JAX package's ``backend_health``), optionally jittered by a seeded
    ``random.Random`` so N clients retrying the same outage don't
    stampede in lockstep while tests stay deterministic.

    Two success models:

    * exception-driven (default): ``fn`` raising one of ``retry_on``
      means "retry"; anything else propagates; a return is success.
    * poll-driven (``until``): ``fn``'s RESULT is judged by the
      predicate; a falsy verdict retries.  When the budget runs out the
      LAST result is returned (the caller inspects it) — the shape of a
      health poll, where "still unhealthy at deadline" is an answer,
      not an error.

    ``min_sleep_s`` floors each nap under a deadline (a nearly-expired
    window should still nap briefly, not busy-spin), while the deadline
    itself caps the nap so the final sleep never overshoots the window.
    ``sleep``/``clock`` default to the ``time`` module's, looked up at
    call time — injectable for tests, patchable via ``time``.
    """

    #: exponent clamp: 2**30 seconds is already ~34 years of backoff
    MAX_EXPONENT = 30

    def __init__(self, base_s: float = 0.5, cap_s: float = 30.0, *,
                 attempts: int | None = None,
                 deadline_s: float | None = None,
                 jitter: float = 0.0, min_sleep_s: float = 0.0,
                 seed: int | None = None,
                 sleep: Callable[[float], None] | None = None,
                 clock: Callable[[], float] | None = None):
        if base_s < 0 or cap_s < 0:
            raise ValueError(f"backoff must be >= 0, got base={base_s} "
                             f"cap={cap_s}")
        if not 0.0 <= jitter < 1.0:
            raise ValueError(f"jitter is a fraction in [0, 1), got {jitter}")
        if attempts is not None and attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.attempts = attempts
        self.deadline_s = deadline_s
        self.jitter = jitter
        self.min_sleep_s = min_sleep_s
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def backoff_s(self, attempt: int) -> float:
        """Nap after the ``attempt``-th failure (1-based), pre-clamping."""
        b = min(self.cap_s,
                self.base_s * (2 ** min(attempt - 1, self.MAX_EXPONENT)))
        if self.jitter:
            b *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return b

    def sleep(self, seconds: float) -> None:
        """Nap through this policy's (injectable) sleep — the public
        surface for callers that drive their own retry loop but want the
        policy's backoff curve and test injection (the supervisor)."""
        if seconds > 0:
            (self._sleep or time.sleep)(seconds)

    def call(self, fn: Callable[[], Any], *,
             retry_on: tuple = (Exception,),
             until: Callable[[Any], bool] | None = None,
             on_attempt: Callable[[int, Any, float], None] | None = None
             ) -> Any:
        """Run ``fn`` under the policy; see the class docstring for the
        two success models.  ``on_attempt(attempt, outcome, remaining_s)``
        fires after each FAILED attempt (outcome is the result or the
        exception; remaining_s is ``inf`` without a deadline)."""
        clock = self._clock or time.monotonic
        sleep = self._sleep or time.sleep
        deadline = None if self.deadline_s is None \
            else clock() + self.deadline_s
        attempt = 0
        while True:
            attempt += 1
            err: BaseException | None = None
            result = None
            try:
                result = fn()
                if until is None or until(result):
                    return result
            except retry_on as e:
                err = e
            remaining = float("inf") if deadline is None \
                else deadline - clock()
            if on_attempt is not None:
                on_attempt(attempt, err if err is not None else result,
                           remaining)
            out_of_budget = (
                (self.attempts is not None and attempt >= self.attempts)
                or (deadline is not None and remaining <= 0))
            if out_of_budget:
                if err is None and until is not None:
                    return result  # poll mode: the last answer IS the answer
                raise RetryBudgetExceededError(
                    f"{attempt} attempts exhausted") from err
            nap = self.backoff_s(attempt)
            if deadline is not None:
                nap = min(nap, max(self.min_sleep_s, remaining))
            if nap > 0:
                sleep(nap)


class Timeout:
    """Hard wall-clock bound on a call that may never return.

    The call runs on a daemon thread joined with a timeout: on expiry the
    caller gets :class:`PolicyTimeoutError` and the stuck thread is
    abandoned — acceptable for probes in a process whose orchestrator
    will restart it anyway (the contract ``device_op_alive`` always had).
    This is NOT cancellation: the wedged work keeps its thread.  Use for
    liveness probes, never around state mutations.

    Abandoned workers are RECORDED, not forgotten: each leak bumps the
    ``chaos_timeout_threads_leaked`` counter, and :meth:`reap` (run at
    the top of every call) joins any that have since finished — a
    recovering dependency frees its threads instead of accumulating one
    zombie per timeout for the process lifetime.
    """

    def __init__(self, timeout_s: float):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        #: workers abandoned past their deadline, reaped opportunistically
        self._leaked: list[threading.Thread] = []

    def reap(self) -> int:
        """Join leaked workers that have since finished; returns how many
        are STILL wedged.  Runs at the top of every :meth:`call` so a
        policy whose probe recovers late frees its thread on the next
        use, not at process exit."""
        still = []
        for t in self._leaked:
            t.join(0)
            if t.is_alive():
                still.append(t)
        self._leaked = still
        return len(still)

    @property
    def leaked_threads(self) -> int:
        """Currently-abandoned (still running) workers."""
        return len(self._leaked)

    @staticmethod
    def _count_leak() -> None:
        # lazy: this module stays stdlib-only
        try:
            from ..telemetry.registry import get_registry, is_enabled

            if is_enabled():
                get_registry().counter(
                    "chaos_timeout_threads_leaked",
                    "Timeout workers abandoned past their deadline"
                ).inc()
        except Exception:  # noqa: BLE001 — accounting must never raise
            pass

    def call(self, fn: Callable[[], Any]) -> Any:
        self.reap()
        box: dict = {}

        def run() -> None:
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(self.timeout_s)
        if t.is_alive():
            self._leaked.append(t)
            self._count_leak()
            raise PolicyTimeoutError(
                f"call exceeded {self.timeout_s}s (worker abandoned; "
                f"{len(self._leaked)} leaked, reaped on next call)")
        if "error" in box:
            raise box["error"]
        return box["value"]


class CircuitBreaker:
    """Consecutive-failure breaker: after ``failure_threshold`` failures
    in a row the circuit opens and calls are refused
    (:class:`CircuitOpenError`) instead of hammering a dead dependency.
    Any success closes it and zeroes the count (non-consecutive failures
    never open it).

    ``reset_after_s`` re-arms an open breaker for ONE probe call after a
    cooldown (half-open); omit it for a permanently-latching breaker
    (the right shape when the owner replaces the dependency on open, as
    a writer does by dropping its client handle).
    """

    def __init__(self, failure_threshold: int = 5, *,
                 reset_after_s: float | None = None,
                 clock: Callable[[], float] | None = None):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0  # guarded by self._lock
        self._opened_at: float | None = None  # guarded by self._lock

    @property
    def failures(self) -> int:
        """Consecutive failures so far (0 after any success)."""
        with self._lock:
            return self._failures

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    def _half_open_ready(self) -> bool:
        if self._opened_at is None or self.reset_after_s is None:
            return False
        clock = self._clock or time.monotonic
        return clock() - self._opened_at >= self.reset_after_s

    def call(self, fn: Callable[[], Any]) -> Any:
        with self._lock:
            if self._opened_at is not None:
                if not self._half_open_ready():
                    raise CircuitOpenError(
                        f"circuit open after {self._failures} consecutive "
                        "failures")
                # claim the ONE half-open probe slot: restarting the
                # cooldown under the lock makes concurrent callers see
                # not-ready and stay refused until this probe resolves
                # (success closes; failure leaves the fresh cooldown)
                clock = self._clock or time.monotonic
                self._opened_at = clock()
        try:
            result = fn()
        except BaseException:
            with self._lock:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    clock = self._clock or time.monotonic
                    self._opened_at = clock()
            raise
        with self._lock:
            self._failures = 0
            self._opened_at = None
        return result
