"""Brownout: graceful degradation under overload.

The port of ``flyimg_tpu/runtime/brownout.py``. A hysteresis state machine

    NORMAL -> DEGRADED -> BROWNOUT -> SHED

driven by the pressure signals the runtime already exports (the batchers'
queue depth and queue-wait share, the SLO burn rates, the inflight gauge,
the open breakers, the host stage pools, the RSS watchdog, the device
supervisor), with a policy a level that the handler applies:

- **DEGRADED**: stale-while-revalidate. A cache hit past
  ``brownout_stale_ttl_s`` serves at once with ``Warning: 110`` and
  ``X-Flyimg-Degraded: stale`` while ONE background refresh re-renders it
  through the handler's single-flight table (``RefreshQueue``).
- **BROWNOUT**: DEGRADED, and ``spec.plan.degrade_plan`` drops the
  sharpening passes, the smart-crop scoring (K2, K3) gives way to the host
  entropy crop, and the encode quality is clamped to ``brownout_quality``.
  Degraded answers are served direct, never cached, and tagged
  ``X-Flyimg-Degraded``.
- **SHED**: BROWNOUT, and a cache miss answers 503 with Retry-After before
  any decode or launch; hits still serve.

Escalation is immediate; each step down waits ``brownout_min_dwell_s`` at
the level and pressure under ``threshold * brownout_hysteresis``. Each
transition adds a span event and a ``flyimg.brownout`` log line and moves
``flyimg_brownout_level`` and ``flyimg_brownout_transitions_total{to}``;
each degradation counts in ``flyimg_degraded_total{mode}``.

Also here: ``NegativeCache`` (origins that failed recently answer 502 at
once) and ``RefreshQueue`` (the bounded, coalesced background refresh).
Everything is off by default (``brownout_enable``, ``negative_cache_ttl_s``
0), and then serving is what it was. The clock is injectable, and the
``brownout.signal`` fault point (testing/faults.py) sets the pressure.
"""

from __future__ import annotations

import hashlib
import logging
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.metrics import escape_label_value
from flyimg_tpu_torch.testing import faults

__all__ = [
    "NORMAL",
    "DEGRADED",
    "BROWNOUT",
    "SHED",
    "LEVEL_NAMES",
    "BrownoutEngine",
    "NegativeCache",
    "RefreshQueue",
]

BROWNOUT_LOGGER = "flyimg.brownout"

#: degradation levels, ordered by severity
NORMAL, DEGRADED, BROWNOUT, SHED = 0, 1, 2, 3
LEVEL_NAMES = {NORMAL: "normal", DEGRADED: "degraded",
               BROWNOUT: "brownout", SHED: "shed"}


class BrownoutEngine:
    """The hysteresis state machine. ``evaluate()`` (once a request, at
    most every ``eval_interval_s``) folds the attached signals into one
    scalar, the largest of each signal over its reference, and maps it to
    a level through the ``*_at`` thresholds."""

    def __init__(
        self,
        *,
        enabled: bool = False,
        degraded_at: float = 0.6,
        brownout_at: float = 0.85,
        shed_at: float = 1.1,
        hysteresis: float = 0.75,
        min_dwell_s: float = 5.0,
        eval_interval_s: float = 0.25,
        queue_ref: float = 64.0,
        inflight_ref: float = 0.0,
        breaker_ref: float = 0.0,
        lease_ref: float = 8.0,
        quality: int = 40,
        stale_ttl_s: float = 300.0,
        refresh_max_pending: int = 8,
        shed_retry_after_s: float = 1.0,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.enabled = bool(enabled)
        # the thresholds are ordered, or the level mapping is meaningless
        self.degraded_at = float(degraded_at)
        self.brownout_at = max(float(brownout_at), self.degraded_at)
        self.shed_at = max(float(shed_at), self.brownout_at)
        self.hysteresis = min(max(float(hysteresis), 0.0), 1.0)
        self.min_dwell_s = max(float(min_dwell_s), 0.0)
        self.eval_interval_s = max(float(eval_interval_s), 0.0)
        self.queue_ref = max(float(queue_ref), 1.0)
        self.inflight_ref = float(inflight_ref)
        self.breaker_ref = float(breaker_ref)
        self.lease_ref = float(lease_ref)
        self.quality = int(quality)
        self.stale_ttl_s = float(stale_ttl_s)
        self.shed_retry_after_s = float(shed_retry_after_s)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._level = NORMAL
        self._level_since = clock()
        self._last_eval = float("-inf")
        self._last_pressure = 0.0
        self._last_components: Dict[str, float] = {}
        self._transitions_total = 0
        # escalation listeners (the flight recorder's dump): queued under
        # the lock, fired after evaluate() released it
        self._transition_listeners = []
        self._pending_notifications = []
        self._batchers: Tuple = ()
        self._slo = None
        self._inflight_fn: Optional[Callable[[], float]] = None
        self._breaker_open_fn: Optional[Callable[[], float]] = None
        self._host_pipeline = None
        self._lease_waiters_fn: Optional[Callable[[], float]] = None
        self._device_supervisor = None
        self._rss_fn: Optional[Callable[[], float]] = None
        self.refresh = RefreshQueue(max_pending=refresh_max_pending, metrics=metrics)

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "BrownoutEngine":
        clock = params.by_key("brownout_clock") or time.monotonic
        return cls(
            enabled=bool(params.by_key("brownout_enable", False)),
            degraded_at=float(params.by_key("brownout_degraded_at", 0.6)),
            brownout_at=float(params.by_key("brownout_brownout_at", 0.85)),
            shed_at=float(params.by_key("brownout_shed_at", 1.1)),
            hysteresis=float(params.by_key("brownout_hysteresis", 0.75)),
            min_dwell_s=float(params.by_key("brownout_min_dwell_s", 5.0)),
            eval_interval_s=float(params.by_key("brownout_eval_interval_s", 0.25)),
            queue_ref=float(params.by_key("brownout_queue_ref", 0.0))
            or float(params.by_key("batch_max_queue_depth", 0) or 0)
            or 64.0,
            inflight_ref=float(params.by_key("brownout_inflight_ref", 0.0)),
            breaker_ref=float(params.by_key("brownout_breaker_ref", 0.0)),
            lease_ref=float(params.by_key("brownout_lease_ref", 8.0)),
            quality=int(params.by_key("brownout_quality", 40)),
            stale_ttl_s=float(params.by_key("brownout_stale_ttl_s", 300.0)),
            refresh_max_pending=int(params.by_key("brownout_refresh_max_pending", 8)),
            shed_retry_after_s=float(params.by_key("shed_retry_after_s", 1.0)),
            metrics=metrics,
            clock=clock,
        )

    # -- signal wiring -----------------------------------------------------

    def add_transition_listener(self, listener) -> None:
        """``listener({from, to, pressure})`` on every escalation, outside
        the engine's lock."""
        self._transition_listeners.append(listener)

    def attach(self, *, batchers=(), slo=None, inflight_fn=None,
               breaker_open_fn=None, host_pipeline=None,
               lease_waiters_fn=None, device_supervisor=None,
               rss_fn=None) -> None:
        """Wire the pressure sources (service/app.py): the batch
        controllers, the SLO engine, the inflight gauge, the open-breaker
        count, the host stage pools (their worst pending share), the L2
        lease's followers parked behind a remote leader, the device
        supervisor (a CPU failover reads as the BROWNOUT threshold) and the
        RSS watchdog. A missing source adds no pressure."""
        self._batchers = tuple(batchers)
        self._slo = slo
        self._inflight_fn = inflight_fn
        self._breaker_open_fn = breaker_open_fn
        self._host_pipeline = host_pipeline
        self._lease_waiters_fn = lease_waiters_fn
        self._rss_fn = rss_fn
        self._device_supervisor = device_supervisor

    def register_metrics(self, registry) -> None:
        """The level gauge evaluates at scrape time (a scrape after the
        traffic stopped watches the level walk down), and the pressure."""
        registry.gauge(
            "flyimg_brownout_level",
            "Degradation level: 0 normal, 1 degraded, 2 brownout, 3 shed",
            fn=lambda: float(self.evaluate()),
        )
        registry.gauge(
            "flyimg_brownout_pressure",
            "Normalized overload pressure (max across attached signals)",
            fn=lambda: self._last_pressure,
        )

    # -- pressure ----------------------------------------------------------

    def _components(self) -> Dict[str, float]:
        """Each attached signal over its reference (1.0: at capacity). A
        failing source reads as no signal, never as a failed request."""
        out: Dict[str, float] = {}
        pending = 0.0
        for batcher in self._batchers:
            try:
                pending += float(batcher.admission.pending)
            except Exception:
                continue
        if self._batchers:
            out["queue_depth"] = pending / self.queue_ref
        metrics = self._metrics
        if metrics is not None and self._batchers:
            try:
                eff = metrics.batch_efficiency(self._batchers[0].name).stats()
                out["queue_wait_share"] = float(eff["queue_wait_share"])
            except Exception:
                pass
        if self._slo is not None and getattr(self._slo, "enabled", False):
            out["burn_fast"] = self._slo.burn_rate("fast") / max(
                self._slo.burn_threshold_fast, 1e-9)
            out["burn_slow"] = self._slo.burn_rate("slow") / max(
                self._slo.burn_threshold_slow, 1e-9)
        if self._host_pipeline is not None and getattr(self._host_pipeline, "enabled", False):
            try:
                out["host_stage"] = float(self._host_pipeline.pressure())
            except Exception:
                pass
        if self._device_supervisor is not None:
            try:
                # a CPU failover sits exactly at the BROWNOUT threshold:
                # cheaper plans and stale serving, never a shed
                out["device_health"] = (
                    self.brownout_at if self._device_supervisor.cpu_forced() else 0.0)
            except Exception:
                pass
        if self._lease_waiters_fn is not None and self.lease_ref > 0:
            try:
                out["l2_lease"] = float(self._lease_waiters_fn()) / self.lease_ref
            except Exception:
                pass
        if self._rss_fn is not None:
            try:
                out["rss"] = float(self._rss_fn())
            except Exception:
                pass
        if self._inflight_fn is not None and self.inflight_ref > 0:
            try:
                out["inflight"] = float(self._inflight_fn()) / self.inflight_ref
            except Exception:
                pass
        if self._breaker_open_fn is not None and self.breaker_ref > 0:
            try:
                out["breakers_open"] = float(self._breaker_open_fn()) / self.breaker_ref
            except Exception:
                pass
        return out

    def pressure(self) -> float:
        return max(self._components().values(), default=0.0)

    def _target_level(self, pressure: float) -> int:
        if pressure >= self.shed_at:
            return SHED
        if pressure >= self.brownout_at:
            return BROWNOUT
        if pressure >= self.degraded_at:
            return DEGRADED
        return NORMAL

    def _threshold_for(self, level: int) -> float:
        return {DEGRADED: self.degraded_at, BROWNOUT: self.brownout_at,
                SHED: self.shed_at}.get(level, self.degraded_at)

    # -- evaluation --------------------------------------------------------

    def evaluate(self) -> int:
        """The level after a fresh look at the pressure. Off, one bool
        check; on, at most every ``eval_interval_s``, unless the
        ``brownout.signal`` fault point injects a pressure (then every
        call evaluates)."""
        if not self.enabled:
            return NORMAL
        injected = faults.fire("brownout.signal")
        now = self._clock()
        level = self._evaluate_locked_region(injected, now)
        self._flush_notifications()
        return level

    def _evaluate_locked_region(self, injected, now: float) -> int:
        with self._lock:
            if injected is faults.PASS and now - self._last_eval < self.eval_interval_s:
                return self._level
            self._last_eval = now
            if injected is not faults.PASS and injected is not None:
                pressure = float(injected)
                components = {"injected": pressure}
            else:
                components = self._components()
                pressure = max(components.values(), default=0.0)
            self._last_pressure = pressure
            self._last_components = components
            target = self._target_level(pressure)
            if target > self._level:
                self._transition_locked(target, pressure, now)
            else:
                # one level down a dwell of elapsed credit while pressure
                # sits under the level's threshold times the hysteresis: a
                # long idle gap walks all the way down in one evaluation
                while (
                    self._level > target
                    and now - self._level_since >= self.min_dwell_s
                    and pressure < self._threshold_for(self._level) * self.hysteresis
                ):
                    self._transition_locked(
                        self._level - 1, pressure, self._level_since + self.min_dwell_s)
            return self._level

    def _flush_notifications(self) -> None:
        with self._lock:
            pending, self._pending_notifications = self._pending_notifications, []
        for doc in pending:
            for listener in self._transition_listeners:
                try:
                    listener(doc)
                except Exception:
                    logging.getLogger(BROWNOUT_LOGGER).warning(
                        "brownout transition listener failed", exc_info=True)

    def _transition_locked(self, to: int, pressure: float, since: float) -> None:
        """Move to ``to``; ``since`` is the new level's start (now going up,
        the consumed dwell boundary going down)."""
        frm = self._level
        self._level = to
        self._level_since = since
        self._transitions_total += 1
        name = LEVEL_NAMES[to]
        if self._metrics is not None:
            self._metrics.counter(
                f'flyimg_brownout_transitions_total{{to="{escape_label_value(name)}"}}',
                "Brownout level transitions by destination level",
            ).inc()
        tracing.add_event("brownout.transition", frm=LEVEL_NAMES[frm], to=name,
                          pressure=round(pressure, 4))
        if to > frm and self._transition_listeners:
            self._pending_notifications.append({
                "event": "brownout.escalation", "from": LEVEL_NAMES[frm],
                "to": name, "pressure": round(pressure, 4),
            })
        log = logging.getLogger(BROWNOUT_LOGGER)
        (log.warning if to > frm else log.info)(
            "brownout level %s -> %s (pressure %.3f)", LEVEL_NAMES[frm], name, pressure,
            extra={
                "event": "brownout.transition",
                "from_level": LEVEL_NAMES[frm],
                "to_level": name,
                "pressure": round(pressure, 4),
                "components": {k: round(v, 4) for k, v in self._last_components.items()},
            },
        )

    # -- the handler's reads -------------------------------------------------

    def level(self) -> int:
        return self._level

    def swr_active(self) -> bool:
        """DEGRADED and above: stale hits serve, one refresh re-renders."""
        return self.enabled and self._level >= DEGRADED

    def plan_degrade_active(self) -> bool:
        """BROWNOUT and above: cheaper plans."""
        return self.enabled and self._level >= BROWNOUT

    def shed_active(self) -> bool:
        """SHED: misses are refused."""
        return self.enabled and self._level >= SHED

    def record_degraded(self, mode: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_degraded_total{{mode="{escape_label_value(mode)}"}}',
            "Requests degraded under brownout, by degradation mode",
        ).inc()

    def snapshot(self) -> Dict[str, object]:
        """The /debug/brownout document."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "level": self._level,
                "level_name": LEVEL_NAMES[self._level],
                "pressure": round(self._last_pressure, 4),
                "components": {k: round(v, 4) for k, v in self._last_components.items()},
                "thresholds": {
                    "degraded_at": self.degraded_at,
                    "brownout_at": self.brownout_at,
                    "shed_at": self.shed_at,
                    "hysteresis": self.hysteresis,
                    "min_dwell_s": self.min_dwell_s,
                },
                "transitions_total": self._transitions_total,
                "refresh_queue": self.refresh.stats(),
            }


# ---------------------------------------------------------------------------
# negative origin cache


class NegativeCache:
    """Origins that failed recently, for ``ttl_s``: fed by the fetch (an
    origin whose transient failures used up the retries, or whose breaker
    is open); a later fetch of the same key answers 502 at once
    (``OriginUnavailableException``).

    A connect-level failure (nothing reached the origin) keys ``(host,
    path)`` without the query, so a cache-busting query cannot get past; a
    resource-level one (the origin answered 5xx) adds a digest of the
    query, so one broken ``?id=N`` spares its siblings. ``hit`` checks the
    origin key first. Bounded (the oldest expiry goes), thread-safe, its
    clock injectable; ``ttl_s <= 0`` turns it off."""

    def __init__(self, ttl_s: float, *, max_entries: int = 1024, metrics=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.ttl_s = float(ttl_s)
        self.max_entries = max(1, int(max_entries))
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        # (host, path, query digest or "") -> (expires at, error label)
        self._entries: Dict[Tuple[str, str, str], Tuple[float, str]] = {}

    @property
    def enabled(self) -> bool:
        return self.ttl_s > 0

    @staticmethod
    def key_for(url: str, *, resource: bool = False) -> Tuple[str, str, str]:
        try:
            parts = urlsplit(url)
            host = (parts.hostname or "local").lower()
            if parts.port:
                host = f"{host}:{parts.port}"
            digest = ""
            if resource and parts.query:
                digest = hashlib.blake2b(
                    parts.query.encode("utf-8", "surrogatepass"), digest_size=6,
                ).hexdigest()
            return host, parts.path or "/", digest
        except ValueError:
            return "local", "/", ""

    def add(self, url: str, error: str, *, resource: bool = False) -> None:
        if not self.enabled:
            return
        key = self.key_for(url, resource=resource)
        with self._lock:
            now = self._clock()
            if key not in self._entries and len(self._entries) >= self.max_entries:
                self._purge_locked(now)
                while len(self._entries) >= self.max_entries:
                    oldest = min(self._entries, key=lambda k: self._entries[k][0])
                    del self._entries[oldest]
            self._entries[key] = (now + self.ttl_s, str(error))
        if self._metrics is not None:
            self._metrics.counter(
                "flyimg_negative_cache_entries_total",
                "Origins entered into the negative cache",
            ).inc()
        tracing.add_event("fetch.negative_cache_store", host=key[0], error=str(error))

    def hit(self, url: str) -> Optional[str]:
        """The failure label while ``url``'s origin (any query) or resource
        (this query) is cached and unexpired, else None."""
        if not self.enabled:
            return None
        error = None
        with self._lock:
            now = self._clock()
            for key in (self.key_for(url), self.key_for(url, resource=True)):
                entry = self._entries.get(key)
                if entry is None:
                    continue
                expires_at, label = entry
                if now >= expires_at:
                    del self._entries[key]
                    continue
                error = label
                break
        if error is None:
            return None
        if self._metrics is not None:
            self._metrics.counter(
                "flyimg_negative_cache_hits_total",
                "Fetches short-circuited by the negative origin cache",
            ).inc()
        return error

    def _purge_locked(self, now: float) -> None:
        for key in [k for k, (exp, _e) in self._entries.items() if now >= exp]:
            del self._entries[key]

    def __len__(self) -> int:
        with self._lock:
            self._purge_locked(self._clock())
            return len(self._entries)


# ---------------------------------------------------------------------------
# bounded, coalesced background refresh


class RefreshQueue:
    """The stale-while-revalidate worker: re-renders coalesced by output
    name (a name queued or running is not queued again: N stale hits cost
    one render), run by one daemon thread started on first use. Past
    ``max_pending`` a refresh is dropped and counted. The
    ``brownout.refresh`` fault point fires once a refresh run."""

    def __init__(self, *, max_pending: int = 8, metrics=None) -> None:
        self.max_pending = max(1, int(max_pending))
        self._metrics = metrics
        self._lock = threading.Lock()
        self._keys: set = set()
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None
        # between deciding to start the worker and its start (outside the
        # lock): a concurrent submit must not start a second one
        self._spawning = False

    def submit(self, key: str, fn: Callable[[], None]) -> bool:
        """Queue one refresh; False when coalesced or over the bound."""
        spawn = False
        with self._lock:
            if key in self._keys:
                return False
            if len(self._keys) >= self.max_pending:
                if self._metrics is not None:
                    self._metrics.counter(
                        "flyimg_refresh_dropped_total",
                        "Stale-refresh renders dropped by the queue bound",
                    ).inc()
                return False
            self._keys.add(key)
            if not self._spawning and (self._thread is None or not self._thread.is_alive()):
                self._spawning = spawn = True
        self._queue.put((key, fn))
        if spawn:
            thread = threading.Thread(target=self._run, name="flyimg-torch-swr-refresh",
                                      daemon=True)
            try:
                thread.start()
            finally:
                with self._lock:
                    self._thread = thread
                    self._spawning = False
        return True

    def _run(self) -> None:
        while True:
            key, fn = self._queue.get()
            try:
                faults.fire("brownout.refresh", key=key)
                fn()
                if self._metrics is not None:
                    self._metrics.counter(
                        "flyimg_refresh_renders_total",
                        "Background stale-while-revalidate re-renders",
                    ).inc()
            except Exception as exc:
                # the stale entry stays; the next stale hit tries again
                logging.getLogger(BROWNOUT_LOGGER).warning(
                    "stale refresh for %s failed: %s", key, exc)
            finally:
                with self._lock:
                    self._keys.discard(key)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pending": len(self._keys), "max_pending": self.max_pending}
