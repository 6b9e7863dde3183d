"""Resilience primitives for the serving pipeline.

The port of ``flyimg_tpu/runtime/resilience.py``, with its metrics
(``flyimg_retries_total``, ``flyimg_breaker_transitions_total``,
``flyimg_shed_total``, ``flyimg_deadline_exceeded_total``) when a registry
is given and its span events (``retry``, ``breaker.transition``,
``breaker.shed``, ``shed``, ``deadline.exceeded``) on the ambient trace:

- ``Deadline``: a per-request latency budget minted at ingress and spent by
  every stage (fetch, device waits). Exhaustion raises
  ``DeadlineExceededException`` (504) instead of holding the socket for the
  sum of every stage's timeout.
- ``RetryPolicy``: capped exponential backoff with full jitter (sleep =
  random(0, min(cap, base * 2^n))); retries only what its caller calls
  transient and never sleeps past the remaining budget.
- ``CircuitBreaker`` / ``BreakerRegistry``: a closed -> open -> half-open
  breaker per upstream host, so a dead origin sheds in microseconds instead
  of a connect timeout a request.
- ``AdmissionGate``: a bounded pending-work counter; past the bound new
  work is refused at once (``ServiceUnavailableException`` with
  ``retry_after_s``: 503 + Retry-After).
- ``classify_batch_error`` / ``QuarantineTable``: device-batch failure
  containment. One poison member of a shared batch would fail every
  innocent member, so the batcher classifies a failed launch (transient,
  poison, oversize, fatal), retries, bisects or splits it accordingly, and
  quarantines fingerprints of recent poison work so a hot bad input cannot
  poison fresh batches every tick.

Everything is plain threading and monotonic time, usable from the server's
request threads and the batcher alike. The knobs come from the server
parameters (``appconfig``).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional
from urllib.parse import urlsplit

import torch

from flyimg_tpu_torch.exceptions import (
    DeadlineExceededException,
    ServiceUnavailableException,
)
from flyimg_tpu_torch.runtime import tracing

__all__ = [
    "Deadline",
    "RetryPolicy",
    "CircuitBreaker",
    "BreakerRegistry",
    "CircuitOpenException",
    "AdmissionGate",
    "QuarantineTable",
    "classify_batch_error",
    "host_of",
    "TRANSIENT",
    "POISON",
    "OVERSIZE",
    "FATAL",
]


# ---------------------------------------------------------------------------
# Deadline budget


class Deadline:
    """A monotonic per-request latency budget.

    Minted once at ingress; every stage asks ``remaining()`` or
    ``timeout(cap)`` to bound its own wait and ``check(stage)`` to fail
    fast when the budget is gone. A ``None`` or non-positive budget is
    unbounded, and every method is then a no-op, so call sites need no
    branching.
    """

    __slots__ = ("_deadline_at", "budget_s", "_metrics", "_clock")

    def __init__(
        self,
        budget_s: Optional[float],
        *,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.budget_s = budget_s if budget_s and budget_s > 0 else None
        self._metrics = metrics
        self._clock = clock
        self._deadline_at = (
            clock() + self.budget_s if self.budget_s is not None else None
        )

    @property
    def expired(self) -> bool:
        return (
            self._deadline_at is not None
            and self._clock() >= self._deadline_at
        )

    def remaining(self) -> float:
        """Seconds left; ``inf`` when unbounded, floored at 0."""
        if self._deadline_at is None:
            return float("inf")
        return max(self._deadline_at - self._clock(), 0.0)

    def timeout(self, cap: Optional[float] = None) -> Optional[float]:
        """A wait timeout bounded by both the stage's cap and the remaining
        budget; None only when both are unbounded."""
        rem = self.remaining()
        if cap is None:
            return None if rem == float("inf") else rem
        return min(cap, rem) if rem != float("inf") else cap

    def check(self, stage: str = "") -> None:
        """Raise ``DeadlineExceededException`` (504) when the budget is
        spent."""
        if self.expired:
            if self._metrics is not None:
                self._metrics.record_deadline_hit(stage or "unknown")
            tracing.add_event(
                "deadline.exceeded",
                stage=stage or "unknown",
                budget_s=self.budget_s,
            )
            raise DeadlineExceededException(
                f"request deadline exceeded"
                f"{f' at stage {stage!r}' if stage else ''} "
                f"(budget {self.budget_s:.3f}s)"
            )

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "Deadline":
        """The request budget of ``request_deadline_s``, minted at
        ingress."""
        return cls(
            float(params.by_key("request_deadline_s", 0.0) or 0.0),
            metrics=metrics,
        )


# ---------------------------------------------------------------------------
# Retry with exponential backoff + full jitter


@dataclass
class RetryPolicy:
    """Bounded retry for transient failures.

    ``run`` retries ``fn`` while ``retryable(exc)`` holds, sleeping
    ``random(0, min(max_backoff, base_backoff * 2**attempt))`` between
    attempts (full jitter). A deadline bounds the whole: when the remaining
    budget cannot cover the next sleep, the last error propagates at once.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    # injectable for deterministic tests
    sleep: Callable[[float], None] = time.sleep
    rng: Callable[[], float] = random.random
    metrics: Optional[object] = None

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before retry number ``attempt`` (1-based)."""
        cap = min(self.max_backoff_s, self.base_backoff_s * (2 ** attempt))
        return self.rng() * cap

    def run(
        self,
        fn: Callable[[], object],
        *,
        retryable: Callable[[BaseException], bool],
        deadline: Optional[Deadline] = None,
        point: str = "",
    ):
        attempt = 0
        while True:
            if deadline is not None:
                deadline.check(point or "retry")
            try:
                return fn()
            except Exception as exc:
                attempt += 1
                if deadline is not None and deadline.expired:
                    # the budget died during this attempt: the caller gets
                    # a deterministic 504, not whatever error the doomed
                    # attempt surfaced
                    deadline.check(point or "retry")
                if attempt >= self.max_attempts or not retryable(exc):
                    raise
                delay = self.backoff(attempt)
                if deadline is not None and deadline.remaining() <= delay:
                    raise   # no budget for the backoff: the real error now
                if self.metrics is not None:
                    self.metrics.record_retry(point or "unknown")
                tracing.add_event(
                    "retry",
                    point=point or "unknown",
                    attempt=attempt,
                    backoff_s=round(delay, 4),
                    error=type(exc).__name__,
                )
                if delay > 0:
                    self.sleep(delay)

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "RetryPolicy":
        return cls(
            max_attempts=int(params.by_key("retry_max_attempts", 3)),
            base_backoff_s=float(params.by_key("retry_base_backoff_s", 0.05)),
            max_backoff_s=float(params.by_key("retry_max_backoff_s", 2.0)),
            metrics=metrics,
        )


# ---------------------------------------------------------------------------
# Circuit breaker


class CircuitOpenException(ServiceUnavailableException):
    """The breaker for this upstream is open: the origin was recently and
    repeatedly down, so the request sheds at once instead of paying a
    connect timeout. 503 + Retry-After (the breaker's recovery time)."""


class CircuitBreaker:
    """closed -> open -> half-open breaker for one upstream.

    - closed: requests flow; ``failure_threshold`` consecutive transient
      failures open it.
    - open: every ``allow()`` raises ``CircuitOpenException`` until
      ``recovery_s`` has passed.
    - half-open: one probe request goes through; its success closes the
      breaker, its failure opens it again (a fresh recovery window).

    Thread-safe.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        recovery_s: float = 10.0,
        name: str = "",
        clock: Callable[[], float] = time.monotonic,
        metrics=None,
    ) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.recovery_s = float(recovery_s)
        self.name = name
        self._clock = clock
        self._metrics = metrics
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # the caller holds the lock
        self._state = to
        if self._metrics is not None:
            self._metrics.record_breaker(self.name or "upstream", to)
        # a transition this request triggered lands in its trace
        tracing.add_event(
            "breaker.transition", host=self.name or "upstream", to=to
        )

    def allow(self) -> None:
        """Admit one attempt or raise ``CircuitOpenException``."""
        with self._lock:
            if self._state == self.CLOSED:
                return
            now = self._clock()
            if self._state == self.OPEN:
                remaining = self._opened_at + self.recovery_s - now
                if remaining > 0:
                    raise self._rejection(remaining)
                self._transition(self.HALF_OPEN)
                self._probe_inflight = False
            # half-open: one probe at a time; everyone else sheds
            if self._probe_inflight:
                raise self._rejection(self.recovery_s)
            self._probe_inflight = True

    def _rejection(self, retry_after: float) -> CircuitOpenException:
        exc = CircuitOpenException(
            f"upstream {self.name or 'origin'!s} circuit is open "
            f"(recently failing); retry in ~{max(retry_after, 0.0):.1f}s"
        )
        exc.retry_after_s = max(1, int(retry_after) or 1)
        tracing.add_event(
            "breaker.shed", host=self.name or "upstream",
            retry_after_s=round(max(retry_after, 0.0), 3),
        )
        return exc

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == self.HALF_OPEN:
                # a failed probe: straight back to open, a fresh window
                self._opened_at = self._clock()
                self._transition(self.OPEN)
                return
            self._consecutive_failures += 1
            if (
                self._state == self.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(self.OPEN)


class BreakerRegistry:
    """One ``CircuitBreaker`` per upstream host, made at first use.

    Host names come from the client (the source URL), so their number is
    bounded: past ``max_hosts`` distinct hosts idle closed breakers are
    evicted, and when none is idle new hosts share one overflow breaker.
    """

    OVERFLOW_HOST = "_overflow"

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        recovery_s: float = 10.0,
        max_hosts: int = 1024,
        metrics=None,
    ) -> None:
        self.failure_threshold = failure_threshold
        self.recovery_s = recovery_s
        self.max_hosts = max(1, int(max_hosts))
        self._metrics = metrics
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _make(self, host: str) -> CircuitBreaker:
        return CircuitBreaker(
            failure_threshold=self.failure_threshold,
            recovery_s=self.recovery_s,
            name=host,
            metrics=self._metrics,
        )

    def for_host(self, host: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(host)
            if breaker is not None:
                return breaker
            if len(self._breakers) >= self.max_hosts:
                idle = next(
                    (
                        key
                        for key, brk in self._breakers.items()
                        if brk.state == CircuitBreaker.CLOSED
                        and key != self.OVERFLOW_HOST
                    ),
                    None,
                )
                if idle is None:  # every breaker tracks live failures
                    breaker = self._breakers.get(self.OVERFLOW_HOST)
                    if breaker is None:
                        breaker = self._make(self.OVERFLOW_HOST)
                        self._breakers[self.OVERFLOW_HOST] = breaker
                    return breaker
                del self._breakers[idle]
            breaker = self._make(host)
            self._breakers[host] = breaker
            return breaker

    def open_count(self) -> int:
        """Breakers not closed (open or half-open): the
        ``flyimg_breaker_open`` gauge."""
        with self._lock:
            breakers = list(self._breakers.values())
        return sum(1 for brk in breakers if brk.state != CircuitBreaker.CLOSED)

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "BreakerRegistry":
        return cls(
            failure_threshold=int(
                params.by_key("breaker_failure_threshold", 5)
            ),
            recovery_s=float(params.by_key("breaker_recovery_s", 10.0)),
            metrics=metrics,
        )


def host_of(url: str) -> str:
    """The breaker key of a source URL: the lowercased host name (and
    port), not the raw netloc, whose userinfo is the client's to choose.
    Local paths share one key (local reads are never transient)."""
    try:
        parts = urlsplit(url)
        host = parts.hostname or "local"
        if parts.port:
            host = f"{host}:{parts.port}"
        return host
    except ValueError:
        return "local"


# ---------------------------------------------------------------------------
# Admission control


@dataclass
class AdmissionGate:
    """Bounded pending-work admission: at most ``max_pending`` admitted
    units at once; past that ``acquire`` sheds at once with a 503 +
    Retry-After instead of queueing into collapse. ``max_pending`` <= 0
    disables the bound."""

    max_pending: int = 0
    retry_after_s: float = 1.0
    name: str = "queue"
    metrics: Optional[object] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _pending: int = 0

    def acquire(self) -> None:
        with self._lock:
            if self.max_pending > 0 and self._pending >= self.max_pending:
                exc = ServiceUnavailableException(
                    f"{self.name} is full ({self._pending}/"
                    f"{self.max_pending} pending); shedding load"
                )
                exc.retry_after_s = max(1, int(self.retry_after_s))
                if self.metrics is not None:
                    self.metrics.record_shed(self.name)
                tracing.add_event(
                    "shed", reason=self.name, pending=self._pending,
                    max_pending=self.max_pending,
                )
                raise exc
            self._pending += 1

    def release(self) -> None:
        with self._lock:
            if self._pending > 0:
                self._pending -= 1

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending


# ---------------------------------------------------------------------------
# Device-batch failure containment (runtime/batcher.py)

#: batch-error classes. TRANSIENT is a property of the moment (retrying the
#: same batch can succeed); POISON of some member's input (the whole batch
#: fails again: only bisection to the member helps); OVERSIZE of the
#: launch's footprint (every member is innocent: smaller launches help,
#: quarantine never does); FATAL of the process's CUDA context (a sticky
#: error: every later launch fails too, so a retry or a bisection only
#: multiplies failures)
TRANSIENT = "transient"
POISON = "poison"
OVERSIZE = "oversize"
FATAL = "fatal"

# host-side transport and IO failures (TimeoutError and ConnectionError are
# OSError subclasses; listed for clarity)
_TRANSIENT_EXC_TYPES = (OSError, TimeoutError, ConnectionError)

#: CUDA errors that poison the context for good (cudaErrorIllegalAddress,
#: cudaErrorAssert, cudaErrorLaunchFailure, cudaErrorMisalignedAddress,
#: cudaErrorIllegalInstruction, cudaErrorHardwareStackError,
#: cudaErrorECCUncorrectable): their messages, lowercased
_STICKY_CUDA_MARKERS = (
    "illegal memory access",
    "device-side assert triggered",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "hardware stack error",
    "uncorrectable ecc error",
)


def classify_batch_error(exc: BaseException) -> str:
    """Classify one failed device launch as ``TRANSIENT``, ``POISON``,
    ``OVERSIZE`` or ``FATAL``.

    ``torch.OutOfMemoryError`` (the card's allocator) is OVERSIZE; a
    sticky CUDA error, whatever its Python type (``torch.AcceleratorError``
    or a ``RuntimeError`` naming it), is FATAL; host IO errors are
    TRANSIENT; everything else (assembly errors, injected member faults, a
    kernel wrapper's refusal) is POISON, so bisection can find it. A wrong
    poison default costs a bounded number of launches and ends at the same
    per-member failure; a wrong transient default would re-run a
    deterministic failure against the whole batch.
    """
    if isinstance(exc, torch.OutOfMemoryError):
        return OVERSIZE
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        if any(marker in msg for marker in _STICKY_CUDA_MARKERS):
            return FATAL
    if isinstance(exc, _TRANSIENT_EXC_TYPES):
        return TRANSIENT
    return POISON


class QuarantineTable:
    """TTL'd fingerprint table of recent poison work.

    Fingerprints are ``(prefix, suffix)`` pairs (the batcher's: plan key,
    image digest), kept as a two-level index so a submitter asks the cheap
    question first: ``has_prefix(plan_key)`` is a dict lookup, and only an
    implicated plan key pays for the image digest ``hit`` needs. A hit
    means "this exact work recently poisoned a batch", and the submitter
    runs it alone. Entries expire after ``ttl_s``; the table is bounded
    (the soonest to expire is evicted). Thread-safe; the clock is
    injectable for tests.
    """

    def __init__(
        self,
        ttl_s: float,
        *,
        max_entries: int = 1024,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.ttl_s = float(ttl_s)
        self.max_entries = max(1, int(max_entries))
        self._clock = clock
        self._lock = threading.Lock()
        # prefix -> {suffix: expires_at}
        self._entries: Dict[object, Dict[object, float]] = {}
        self._count = 0

    def add(self, fingerprint) -> None:
        prefix, suffix = fingerprint
        with self._lock:
            now = self._clock()
            bucket = self._entries.setdefault(prefix, {})
            if suffix not in bucket and self._count >= self.max_entries:
                self._purge_locked(now)
                if self._count >= self.max_entries:
                    self._evict_oldest_locked()
                bucket = self._entries.setdefault(prefix, {})
            if suffix not in bucket:
                self._count += 1
            bucket[suffix] = now + self.ttl_s

    def hit(self, fingerprint) -> bool:
        prefix, suffix = fingerprint
        with self._lock:
            bucket = self._entries.get(prefix)
            if bucket is None:
                return False
            expires_at = bucket.get(suffix)
            if expires_at is None:
                return False
            if self._clock() >= expires_at:
                self._remove_locked(prefix, suffix)
                return False
            return True

    def has_prefix(self, prefix) -> bool:
        """Any live entry under ``prefix``? A miss costs one dict lookup and
        no digest."""
        with self._lock:
            bucket = self._entries.get(prefix)
            if bucket is None:
                return False
            now = self._clock()
            for suffix, expires_at in list(bucket.items()):
                if now >= expires_at:
                    self._remove_locked(prefix, suffix)
            return prefix in self._entries

    def _remove_locked(self, prefix, suffix) -> None:
        bucket = self._entries.get(prefix)
        if bucket is not None and suffix in bucket:
            del bucket[suffix]
            self._count -= 1
            if not bucket:
                del self._entries[prefix]

    def _purge_locked(self, now: float) -> None:
        for prefix in list(self._entries):
            for suffix, expires_at in list(self._entries[prefix].items()):
                if now >= expires_at:
                    self._remove_locked(prefix, suffix)

    def _evict_oldest_locked(self) -> None:
        oldest = None
        for prefix, bucket in self._entries.items():
            for suffix, expires_at in bucket.items():
                if oldest is None or expires_at < oldest[2]:
                    oldest = (prefix, suffix, expires_at)
        if oldest is not None:
            self._remove_locked(oldest[0], oldest[1])

    def __len__(self) -> int:
        """Live (unexpired) entries (purges as a side effect)."""
        with self._lock:
            self._purge_locked(self._clock())
            return self._count
