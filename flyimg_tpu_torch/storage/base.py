"""Storage contract: the port of ``flyimg_tpu/storage/base.py``.

The surface the handler consumes (has, read, write, delete, stat, fetch
and the public URL of the ``/path`` route), the retry wrapper every
backend routes its reads and writes through, and hedged cache reads."""

from __future__ import annotations

import abc
import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Callable, Optional


class _DaemonPool:
    """Reusable daemon worker threads for hedged reads.

    Not a ThreadPoolExecutor: its workers are non-daemon and joined at
    interpreter exit, so one tunnel-hung backend read would block
    shutdown forever (the same reason the batcher drains on daemon
    threads). Workers here are daemons that park on a shared queue and
    exit after ``idle_timeout_s`` without work — steady-state hedged
    traffic reuses warm threads instead of paying a thread start per
    cache lookup, a hung read merely strands its worker (the next
    submit spawns a fresh one), and nothing outlives the process."""

    def __init__(self, idle_timeout_s: float = 30.0) -> None:
        self.idle_timeout_s = idle_timeout_s
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._lock = threading.Lock()
        self._idle = 0

    def submit(self, fn: Callable[[], None]) -> None:
        # the enqueue happens INSIDE the lock: paired with the worker's
        # locked drain-before-exit below, either the worker sees this
        # item before retiring or this submit sees idle==0 and spawns —
        # an idle-timeout retirement can never strand a queued read.
        # Accepted lock-held queue op: the queue is UNBOUNDED, so put()
        # cannot block — moving it outside the lock would reopen the
        # retire/strand race this ordering exists to close.
        with self._lock:
            spawn = self._idle == 0
            if spawn:
                # reserve the new worker so a concurrent submit doesn't
                # double-spawn for the same queued item
                self._idle += 1
            self._queue.put(fn)
        if spawn:
            threading.Thread(
                target=self._run, name="flyimg-storage-read", daemon=True
            ).start()

    def _run(self) -> None:
        while True:
            try:
                fn = self._queue.get(timeout=self.idle_timeout_s)
            except queue_mod.Empty:
                with self._lock:
                    # a submit may have enqueued between the timeout and
                    # this lock while counting us idle: drain it instead
                    # of retiring and stranding it
                    try:
                        fn = self._queue.get_nowait()
                    except queue_mod.Empty:
                        self._idle -= 1
                        return
            with self._lock:
                self._idle -= 1
            try:
                fn()
            finally:
                with self._lock:
                    self._idle += 1


#: one process-wide pool: hedged reads are rare enough (opt-in knob) that
#: sharing across storage instances keeps the thread count minimal
_HEDGE_POOL = _DaemonPool()


@dataclass(frozen=True)
class StorageStat:
    """Cheap metadata for a stored artifact. ``mtime`` (unix time) feeds the
    Last-Modified header (reference Response.php:72-78 uses the upload
    file's mtime); None -> the response layer falls back to now()."""

    mtime: Optional[float] = None


class Storage(abc.ABC):
    #: optional runtime.resilience.RetryPolicy installed by make_storage;
    #: backends route reads/writes through _with_retry so transient backend
    #: hiccups (throttling, 5xx, EIO) retry with jittered backoff instead
    #: of failing the request
    retry_policy = None
    #: hedged-read delay (seconds) armed by make_storage from the
    #: ``storage_hedge_delay_ms`` knob; 0 disables hedging and
    #: ``fetch_hedged`` degrades to a plain ``fetch``
    hedge_delay_s = 0.0
    #: ceiling on the whole hedged wait (primary + backup): a store whose
    #: BOTH reads hang must not hold the request thread forever
    HEDGE_WAIT_CAP_S = 30.0
    #: optional runtime.metrics.MetricsRegistry installed by make_storage
    metrics = None

    @staticmethod
    def _is_transient(exc: Exception) -> bool:
        """Backend-specific transient classification; the default retries
        nothing (safe for unknown backends)."""
        return False

    @property
    def shared(self) -> "Storage":
        """The tier shared across replicas — where fleet-visible state
        (variant manifests, lease markers) must live. A plain single-tier
        backend IS its own shared tier."""
        return self

    def _with_retry(self, op: str, fn):
        """Run one storage operation under the retry policy (when set) and
        the ``storage.<op>`` fault-injection point. Injected plans may
        raise (simulated backend failure, subject to the same retry
        classification) or return a value (simulated success). Backend
        errors land as events on the active request span (retries add
        their own events via RetryPolicy)."""
        from flyimg_tpu_torch.runtime import tracing
        from flyimg_tpu_torch.testing import faults

        def attempt():
            injected = faults.fire(f"storage.{op}")
            if injected is not faults.PASS:
                return injected
            try:
                return fn()
            except Exception as exc:
                # only transient-classified errors are real backend
                # hiccups; deterministic ones (FileNotFound = cache miss)
                # are normal control flow and would spam every trace
                if self._is_transient(exc):
                    tracing.add_event(
                        "storage.error", op=op, error=type(exc).__name__
                    )
                raise

        if self.retry_policy is None:
            return attempt()
        return self.retry_policy.run(
            attempt, retryable=self._is_transient, point=f"storage.{op}"
        )

    @abc.abstractmethod
    def has(self, name: str) -> bool: ...

    @abc.abstractmethod
    def read(self, name: str) -> bytes: ...

    @abc.abstractmethod
    def write(self, name: str, data: bytes) -> Optional[float]:
        """Store the artifact; returns its mtime when cheaply known (so the
        serving path never issues a metadata round trip for an object it
        just wrote), else None."""

    @abc.abstractmethod
    def delete(self, name: str) -> None: ...

    @abc.abstractmethod
    def public_url(self, name: str, request_base: Optional[str] = None) -> str:
        """Public URL for the /path route (reference Response.php:108-113)."""

    def stat(self, name: str) -> Optional[StorageStat]:
        """One round trip answering BOTH "is it cached?" and "when was it
        stored?" — None when absent. Default composes has(); backends
        override with a single native call (os.stat / S3 HeadObject)."""
        return StorageStat() if self.has(name) else None

    def list_names(self, prefix: str):
        """Object names starting with ``prefix``, or None when the backend
        cannot enumerate (the capability-absent signal: fleet membership
        — runtime/membership.py — gates itself off rather than guessing
        at liveness it cannot observe). Backends with a native listing
        primitive (os.scandir / S3 ListObjectsV2) override."""
        return None

    def fetch(self, name: str) -> Optional[tuple]:
        """(bytes, StorageStat) in ONE round trip, or None when absent —
        the cache-hit serving path (existence + bytes + mtime together;
        S3's GetObject already carries LastModified, local disk answers
        with one open+fstat). Default composes stat()+read() for backends
        without a cheaper combined call."""
        st = self.stat(name)
        if st is None:
            return None
        try:
            return self.read(name), st
        except Exception:
            # stat->read race: a concurrent delete (rf_1) between the two
            # calls must surface as "absent", not a 500
            if self.stat(name) is None:
                return None
            raise

    # -- hedged reads -------------------------------------------------------

    def _record_hedge(self, winner: str) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(
            f'flyimg_storage_hedged_reads_total{{winner="{winner}"}}',
            "Hedged cache reads by which attempt produced the result",
        ).inc()

    def fetch_hedged(self, name: str) -> Optional[tuple]:
        """``fetch`` with tail-latency hedging: the primary read runs on
        a daemon thread; if it produces nothing within ``hedge_delay_s``
        ONE backup read fires (a second attempt against the same
        backend — local disk retries the open, S3/GCS issue a fresh GET
        that lands on a different replica) and the first result wins.
        The loser is abandoned (daemon thread), never cancelled — object
        reads are idempotent. With hedging off (the default) this IS
        ``fetch``, same thread, zero overhead.

        The ``storage.read_delay`` fault point fires inside each attempt
        with ``attempt=0`` (primary) / ``attempt=1`` (backup) — a plan
        that sleeps only for attempt 0 models the slow-primary tail this
        exists to bound; its return value is ignored (latency-only
        point, unlike ``storage.read``'s value injection)."""
        from flyimg_tpu_torch.runtime import tracing
        from flyimg_tpu_torch.testing import faults

        delay = self.hedge_delay_s
        if not delay or delay <= 0:
            faults.fire("storage.read_delay", name=name, attempt=0)
            return self.fetch(name)
        import time as _time

        results: "queue_mod.Queue" = queue_mod.Queue()

        def attempt(idx: int) -> None:
            try:
                faults.fire("storage.read_delay", name=name, attempt=idx)
                results.put((idx, None, self.fetch(name)))
            except BaseException as exc:  # marshalled to the caller
                results.put((idx, exc, None))

        # reads run on the shared daemon pool (warm threads reused across
        # lookups — no thread start on the cache-hit hot path; a hung
        # read strands only its worker)
        _HEDGE_POOL.submit(lambda: attempt(0))
        outstanding = 1
        hedged = False
        first_error = None
        deadline = _time.monotonic() + self.HEDGE_WAIT_CAP_S
        timeout = delay
        while outstanding:
            try:
                idx, exc, value = results.get(timeout=timeout)
            except queue_mod.Empty:
                if not hedged:
                    # primary produced nothing within the hedge delay:
                    # fire the one backup and keep waiting for whichever
                    # lands first
                    hedged = True
                    outstanding += 1
                    tracing.add_event("storage.hedge", key=name)
                    if self.metrics is not None:
                        self.metrics.counter(
                            "flyimg_storage_hedges_total",
                            "Backup reads fired after a slow primary",
                        ).inc()
                    _HEDGE_POOL.submit(lambda: attempt(1))
                    timeout = max(deadline - _time.monotonic(), 0.001)
                    continue
                raise TimeoutError(
                    f"hedged storage read of {name!r} produced no result "
                    f"within {self.HEDGE_WAIT_CAP_S}s"
                )
            outstanding -= 1
            if exc is None:
                if hedged:
                    self._record_hedge(
                        "backup" if idx == 1 else "primary"
                    )
                return value
            if first_error is None:
                first_error = exc
            timeout = max(deadline - _time.monotonic(), 0.001)
        raise first_error
