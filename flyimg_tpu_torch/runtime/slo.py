"""SLO engine: declared service objectives, evaluated continuously.

The port of ``flyimg_tpu/runtime/slo.py`` (the multi-window burn-rate
scheme of the SRE workbook):

- **Objectives** come from the parameters: ``slo_latency_p99_ms`` (a
  request slower than this is "slow"), ``slo_availability`` (percent of
  requests that must not 5xx) and ``slo_latency_quantile`` (0.99: 1% of
  requests may be slow).
- **Windows**: requests land in fixed-width time slices (1/30 of the fast
  window); the fast (default 5 m) and slow (default 1 h) windows aggregate
  the slices they cover. The clock is injectable.
- **Burn rate** per window = observed bad fraction / allowed bad
  fraction, for errors (5xx against the availability budget) and latency
  (slow requests against the ``1 - quantile`` budget); the window's burn
  rate is the worse of the two.
- **Breach** = the fast AND the slow window both over their thresholds.
  Breaches are edge-triggered: one log line (logger ``flyimg.slo``)
  carrying the triggering request's trace id (that trace is force-kept
  past the tail sampler), a ``slo.breach`` span event on it, a
  ``flyimg_slo_breaches_total`` increment, and the breach listeners (the
  server dumps the flight recorder there).

Exported surface: ``flyimg_slo_*`` gauges (render-time callbacks on the
shared registry) and the debug-gated ``/debug/slo`` route
(service/app.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from flyimg_tpu_torch.runtime.metrics import (
    BUCKET_BOUNDS,
    bucket_index,
    escape_label_value,
    quantile_from_counts,
)

__all__ = ["SloEngine"]

SLO_LOGGER = "flyimg.slo"

# slices per fast window: fine enough that window edges move smoothly,
# coarse enough that aggregating a 1 h slow window stays a few hundred adds
_SLICES_PER_FAST_WINDOW = 30


class _Slice:
    """One time slice of request outcomes: totals, 5xx count, over-latency
    count, and a latency histogram (the shared log-spaced bounds) for
    window-p99 estimation."""

    __slots__ = ("index", "total", "bad", "slow", "lat")

    def __init__(self, index: int) -> None:
        self.index = index
        self.total = 0
        self.bad = 0
        self.slow = 0
        self.lat = [0] * (len(BUCKET_BOUNDS) + 1)


class SloEngine:
    """Sliding-window SLO evaluation with multi-window burn rates."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        latency_p99_ms: float = 150.0,
        availability: float = 99.9,
        latency_quantile: float = 0.99,
        window_fast_s: float = 300.0,
        window_slow_s: float = 3600.0,
        burn_threshold_fast: float = 14.4,
        burn_threshold_slow: float = 6.0,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.enabled = bool(enabled)
        self.latency_objective_s = float(latency_p99_ms) / 1000.0
        self.availability = float(availability)
        # allowed bad fractions: the denominators of every burn rate.
        # Floors keep a misconfigured 100%/1.0 objective from dividing
        # by zero (burn would be infinite on the first bad request anyway).
        self.error_budget_frac = max(1.0 - self.availability / 100.0, 1e-9)
        self.latency_budget_frac = max(1.0 - float(latency_quantile), 1e-9)
        self.latency_quantile = float(latency_quantile)
        self.window_fast_s = float(window_fast_s)
        self.window_slow_s = max(float(window_slow_s), self.window_fast_s)
        self.burn_threshold_fast = float(burn_threshold_fast)
        self.burn_threshold_slow = float(burn_threshold_slow)
        self._metrics = metrics
        self._clock = clock
        self._slice_s = max(self.window_fast_s / _SLICES_PER_FAST_WINDOW, 0.1)
        self._lock = threading.Lock()
        self._slices: List[_Slice] = []
        self._breached = False
        self._breaches_total = 0
        self._last_breach: Optional[Dict[str, object]] = None
        # breach listeners (service/app.py wires the batch flight
        # recorder's dump here): called OUTSIDE the engine lock, once
        # per edge-triggered breach, with the breach document
        self._breach_listeners: List[Callable[[Dict[str, object]], None]] = []

    @classmethod
    def from_params(cls, params, *, metrics=None,
                    clock: Callable[[], float] = time.monotonic
                    ) -> "SloEngine":
        return cls(
            enabled=bool(params.by_key("slo_enabled", True)),
            latency_p99_ms=float(params.by_key("slo_latency_p99_ms", 150.0)),
            availability=float(params.by_key("slo_availability", 99.9)),
            latency_quantile=float(
                params.by_key("slo_latency_quantile", 0.99)
            ),
            window_fast_s=float(params.by_key("slo_window_fast_s", 300.0)),
            window_slow_s=float(params.by_key("slo_window_slow_s", 3600.0)),
            burn_threshold_fast=float(
                params.by_key("slo_burn_threshold_fast", 14.4)
            ),
            burn_threshold_slow=float(
                params.by_key("slo_burn_threshold_slow", 6.0)
            ),
            metrics=metrics,
            clock=clock,
        )

    # -- recording ---------------------------------------------------------

    def record(self, duration_s: float, ok: bool, trace=None) -> None:
        """One pipeline request's outcome. Called by the HTTP middleware
        for pipeline routes only (health probes and /metrics scrapes must
        not dilute the SLI). Cheap: a dict-append under one lock plus an
        O(slices) burn check — well inside the <=2% cache-hit budget."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            sl = self._slice_for_locked(now)
            sl.total += 1
            if not ok:
                sl.bad += 1
            if duration_s > self.latency_objective_s:
                sl.slow += 1
            sl.lat[bucket_index(duration_s, BUCKET_BOUNDS)] += 1
            fast = self._burn_locked(now, self.window_fast_s)
            slow = self._burn_locked(now, self.window_slow_s)
            breached_now = (
                fast > self.burn_threshold_fast
                and slow > self.burn_threshold_slow
            )
            transition = breached_now != self._breached
            self._breached = breached_now
            if transition and breached_now:
                self._breaches_total += 1
                trace_id = getattr(trace, "trace_id", None)
                self._last_breach = {
                    "burn_rate_fast": round(fast, 3),
                    "burn_rate_slow": round(slow, 3),
                    "trace_id": trace_id,
                    "at_s": round(now, 3),
                }
        if not transition:
            return
        if breached_now:
            self._emit_breach(fast, slow, trace)
        else:
            logging.getLogger(SLO_LOGGER).info(
                "SLO recovered: burn rates back under thresholds",
                extra={
                    "event": "slo.recovered",
                    "burn_rate_fast": round(fast, 3),
                    "burn_rate_slow": round(slow, 3),
                },
            )

    def add_breach_listener(
        self, listener: Callable[[Dict[str, object]], None]
    ) -> None:
        """Register a callback fired once per edge-triggered breach
        (after the log/span/counter emission, outside the engine lock).
        The serving wiring uses this to dump the batch flight recorder
        at the moment the evidence is still in the ring."""
        self._breach_listeners.append(listener)

    def _emit_breach(self, fast: float, slow: float, trace) -> None:
        """Edge-triggered breach emission: one structured log line + a
        span event on the triggering trace (kept by the tail sampler —
        breaches are errors or slow, exactly what it always keeps) + a
        counter, so every signal plane agrees a breach happened."""
        trace_id = getattr(trace, "trace_id", None)
        if self._metrics is not None:
            self._metrics.counter(
                "flyimg_slo_breaches_total",
                "Multi-window SLO burn-rate breaches (edge-triggered)",
            ).inc()
        if trace is not None:
            # the log line below names this trace: pin it into the ring
            # whatever the sample rate — a breach trigger can be neither
            # an error nor "slow" by the tracing threshold (e.g. 200 ms
            # against a 150 ms objective under a 500 ms slow bar)
            trace.force_keep = True
            trace.add_event(
                "slo.breach",
                burn_rate_fast=round(fast, 3),
                burn_rate_slow=round(slow, 3),
                objective_latency_ms=self.latency_objective_s * 1000.0,
                objective_availability=self.availability,
            )
        logging.getLogger(SLO_LOGGER).error(
            "SLO breach: fast burn %.1f (> %.1f) and slow burn %.1f (> %.1f)",
            fast, self.burn_threshold_fast, slow, self.burn_threshold_slow,
            extra={
                "event": "slo.breach",
                "burn_rate_fast": round(fast, 3),
                "burn_rate_slow": round(slow, 3),
                "burn_threshold_fast": self.burn_threshold_fast,
                "burn_threshold_slow": self.burn_threshold_slow,
                "objective_latency_ms": self.latency_objective_s * 1000.0,
                "objective_availability": self.availability,
                "trace_id": trace_id,
            },
        )
        doc = {
            "event": "slo.breach",
            "burn_rate_fast": round(fast, 3),
            "burn_rate_slow": round(slow, 3),
            "trace_id": trace_id,
        }
        for listener in self._breach_listeners:
            try:
                listener(doc)
            except Exception:
                # a broken listener must not fail the request that
                # happened to tip the breach
                logging.getLogger(SLO_LOGGER).warning(
                    "SLO breach listener failed", exc_info=True
                )

    # -- window bookkeeping (caller holds the lock) ------------------------

    def _slice_for_locked(self, now: float) -> _Slice:
        index = int(now // self._slice_s)
        if self._slices and self._slices[-1].index == index:
            return self._slices[-1]
        sl = _Slice(index)
        self._slices.append(sl)
        # drop slices that left the slow window (bounded memory): a slice
        # is gone once its END predates the slow window's start
        horizon = now - self.window_slow_s
        keep_from = 0
        for i, old in enumerate(self._slices):
            if (old.index + 1) * self._slice_s > horizon:
                keep_from = i
                break
        if keep_from:
            del self._slices[:keep_from]
        return sl

    def _window_slices_locked(self, now: float, window_s: float
                              ) -> List[_Slice]:
        horizon = now - window_s
        return [
            sl for sl in self._slices
            if (sl.index + 1) * self._slice_s > horizon
        ]

    def _burn_locked(self, now: float, window_s: float) -> float:
        total = bad = slow = 0
        for sl in self._window_slices_locked(now, window_s):
            total += sl.total
            bad += sl.bad
            slow += sl.slow
        if total == 0:
            return 0.0
        return max(
            (bad / total) / self.error_budget_frac,
            (slow / total) / self.latency_budget_frac,
        )

    # -- evaluation surface ------------------------------------------------

    def burn_rate(self, window: str = "fast") -> float:
        """Current burn rate for 'fast' or 'slow' — the gauge callbacks."""
        if not self.enabled:
            return 0.0
        window_s = (
            self.window_fast_s if window == "fast" else self.window_slow_s
        )
        with self._lock:
            return self._burn_locked(self._clock(), window_s)

    def digest_fields(self) -> Dict[str, float]:
        """The burn of each window, raw and over its threshold, and the
        fast window's request count: the SLO block of a telemetry window
        record (runtime/telemetry.py)."""
        if not self.enabled:
            return {}
        fast = self.burn_rate("fast")
        slow = self.burn_rate("slow")
        with self._lock:
            requests = sum(
                sl.total for sl in self._window_slices_locked(
                    self._clock(), self.window_fast_s))
        return {
            "burn_fast": round(fast, 4),
            "burn_slow": round(slow, 4),
            "burn_fast_norm": round(fast / max(self.burn_threshold_fast, 1e-9), 4),
            "burn_slow_norm": round(slow / max(self.burn_threshold_slow, 1e-9), 4),
            "window_requests": float(requests),
        }

    def window_p99_s(self, window: str = "fast") -> float:
        window_s = (
            self.window_fast_s if window == "fast" else self.window_slow_s
        )
        with self._lock:
            counts = [0] * (len(BUCKET_BOUNDS) + 1)
            for sl in self._window_slices_locked(self._clock(), window_s):
                for i, c in enumerate(sl.lat):
                    counts[i] += c
        return quantile_from_counts(
            counts, BUCKET_BOUNDS, self.latency_quantile
        )

    def error_budget_remaining(self) -> float:
        """Fraction of the slow-window budget left (1 = untouched,
        0 = exhausted), against the WORSE of the error and latency
        budgets — the number an operator reads before shipping risk."""
        if not self.enabled:
            return 1.0
        with self._lock:
            now = self._clock()
            total = bad = slow = 0
            for sl in self._window_slices_locked(now, self.window_slow_s):
                total += sl.total
                bad += sl.bad
                slow += sl.slow
        if total == 0:
            return 1.0
        consumed = max(
            (bad / total) / self.error_budget_frac,
            (slow / total) / self.latency_budget_frac,
        )
        return max(0.0, 1.0 - consumed)

    @property
    def breached(self) -> bool:
        """Instantaneous breach state against the CURRENT clock — not the
        latched edge state from the last record(): once traffic stops and
        the windows drain, a scrape must see this fall back to 0 in step
        with the burn-rate gauges on the same page. (The latched
        ``_breached`` only drives edge-triggered breach/recovery logging,
        which by construction needs a record() to transition.)"""
        if not self.enabled:
            return False
        with self._lock:
            now = self._clock()
            fast = self._burn_locked(now, self.window_fast_s)
            slow = self._burn_locked(now, self.window_slow_s)
        return (
            fast > self.burn_threshold_fast
            and slow > self.burn_threshold_slow
        )

    def _window_doc(self, window: str) -> Dict[str, object]:
        window_s = (
            self.window_fast_s if window == "fast" else self.window_slow_s
        )
        threshold = (
            self.burn_threshold_fast if window == "fast"
            else self.burn_threshold_slow
        )
        with self._lock:
            now = self._clock()
            total = bad = slow = 0
            counts = [0] * (len(BUCKET_BOUNDS) + 1)
            for sl in self._window_slices_locked(now, window_s):
                total += sl.total
                bad += sl.bad
                slow += sl.slow
                for i, c in enumerate(sl.lat):
                    counts[i] += c
        error_burn = (
            (bad / total) / self.error_budget_frac if total else 0.0
        )
        latency_burn = (
            (slow / total) / self.latency_budget_frac if total else 0.0
        )
        p99 = quantile_from_counts(
            counts, BUCKET_BOUNDS, self.latency_quantile
        )
        return {
            "window_s": window_s,
            "requests": total,
            "errors": bad,
            "slow": slow,
            "p99_ms": (
                round(p99 * 1000.0, 3) if p99 != float("inf") else None
            ),
            "error_burn": round(error_burn, 4),
            "latency_burn": round(latency_burn, 4),
            "burn_rate": round(max(error_burn, latency_burn), 4),
            "burn_threshold": threshold,
        }

    def snapshot(self) -> Dict[str, object]:
        """The /debug/slo JSON document."""
        if not self.enabled:
            return {"enabled": False}
        return {
            "enabled": True,
            "objective": {
                "latency_p99_ms": self.latency_objective_s * 1000.0,
                "latency_quantile": self.latency_quantile,
                "availability_pct": self.availability,
                "error_budget_frac": self.error_budget_frac,
                "latency_budget_frac": self.latency_budget_frac,
            },
            "error_budget_remaining": round(
                self.error_budget_remaining(), 4
            ),
            "breached": self.breached,
            "breaches_total": self._breaches_total,
            "last_breach": self._last_breach,
            "windows": {
                "fast": self._window_doc("fast"),
                "slow": self._window_doc("slow"),
            },
        }

    def summary_fields(self) -> Dict[str, float]:
        """The compact fields MetricsRegistry.summary() folds in."""
        return {
            "burn_rate_fast": round(self.burn_rate("fast"), 4),
            "burn_rate_slow": round(self.burn_rate("slow"), 4),
            "error_budget_remaining": round(
                self.error_budget_remaining(), 4
            ),
            "breached": 1.0 if self.breached else 0.0,
        }

    def digest_fields(self) -> Dict[str, float]:
        """The compact burn fields the fleet observatory publishes in
        this replica's signal digest (runtime/observatory.py): raw and
        threshold-normalized burn per window (1.0 = this replica's own
        brownout threshold — normalization makes burns comparable
        across replicas with different objectives), plus the fast
        window's request count so the fleet rollup can request-weight
        the fleet-wide burn."""
        if not self.enabled:
            return {}
        fast = self.burn_rate("fast")
        slow = self.burn_rate("slow")
        with self._lock:
            requests = sum(
                sl.total for sl in self._window_slices_locked(
                    self._clock(), self.window_fast_s
                )
            )
        return {
            "burn_fast": round(fast, 4),
            "burn_slow": round(slow, 4),
            "burn_fast_norm": round(
                fast / max(self.burn_threshold_fast, 1e-9), 4
            ),
            "burn_slow_norm": round(
                slow / max(self.burn_threshold_slow, 1e-9), 4
            ),
            "window_requests": float(requests),
        }

    # -- metrics wiring ----------------------------------------------------

    def register_metrics(self, registry) -> None:
        """Export the flyimg_slo_* gauge family (render-time callbacks:
        a scrape always sees burn rates computed against the current
        clock, not the last request). No-op when disabled — a turned-off
        engine must not advertise objectives it is not evaluating."""
        if not self.enabled:
            return
        registry.gauge(
            "flyimg_slo_latency_objective_ms",
            "Declared latency objective at the configured quantile",
            fn=lambda: self.latency_objective_s * 1000.0,
        )
        registry.gauge(
            "flyimg_slo_availability_objective",
            "Declared availability objective (percent)",
            fn=lambda: self.availability,
        )
        registry.gauge(
            "flyimg_slo_burn_rate_fast",
            "Error-budget burn rate over the fast window",
            fn=lambda: self.burn_rate("fast"),
        )
        registry.gauge(
            "flyimg_slo_burn_rate_slow",
            "Error-budget burn rate over the slow window",
            fn=lambda: self.burn_rate("slow"),
        )
        registry.gauge(
            "flyimg_slo_error_budget_remaining",
            "Fraction of the slow-window error budget remaining",
            fn=self.error_budget_remaining,
        )
        registry.gauge(
            "flyimg_slo_breached",
            "1 while fast AND slow burn rates exceed their thresholds",
            fn=lambda: 1.0 if self.breached else 0.0,
        )
        for window in ("fast", "slow"):
            registry.gauge(
                "flyimg_slo_window_p99_ms"
                f'{{window="{escape_label_value(window)}"}}',
                "Windowed latency p-quantile at the objective quantile",
                fn=lambda w=window: self._p99_ms_gauge(w),
            )

    def _p99_ms_gauge(self, window: str) -> float:
        p = self.window_p99_s(window)
        # overflow-bucket quantile has no upper bound; NaN renders per
        # the exposition format instead of a fake number
        return p * 1000.0 if p != float("inf") else float("nan")
