"""Service metrics: counters, gauges, latency histograms and Prometheus
rendering.

The port of ``flyimg_tpu/runtime/metrics.py``. Family names, label strings
and help texts are the JAX package's byte for byte (a dashboard or alert
written against one scrapes the other), labels baked into the metric name
as it does (``'flyimg_device_transfer_seconds{direction="h2d"}'``). Served
by the ``/metrics`` route (service/app.py) in Prometheus text 0.0.4, or
OpenMetrics with exemplars when the scrape asks for it. The fleet tier's
families (``flyimg_fleet_*`` of the router, membership and the observatory,
``flyimg_tier_*``, ``flyimg_l2_*``) are registered by their modules, and
only while those are on.

Design notes:
- Histograms use fixed log-spaced buckets (120 us .. ~2 min), so quantile
  estimates need no per-sample storage and merging is integer adds.
- Everything is guarded by one lock per registry; recording is a few dict
  operations, far off the device's path.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# log-spaced latency buckets in seconds: 23 buckets, x1.8 apart,
# 120us .. ~113s — covers device-batch latencies through cold compiles.
_BUCKET_BASE = 0.00012
_BUCKET_FACTOR = 1.8
_N_BUCKETS = 23
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    _BUCKET_BASE * _BUCKET_FACTOR ** i for i in range(_N_BUCKETS)
)

# batch-efficiency histogram bounds: occupancy is a ratio in (0, 1], bucket sizes ride the
# power-of-two ladder — latency bounds would be meaningless for either
OCCUPANCY_BOUNDS: Tuple[float, ...] = (
    0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0
)
BATCH_SIZE_BOUNDS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64)

# cached module ref for exemplar trace-id lookup (lazy: metrics must stay
# importable/fast without dragging the tracing module in at import time)
_tracing_mod = None


def _ambient_trace_id() -> Optional[str]:
    """Trace id of the ambient request trace, for OpenMetrics exemplars.
    No active trace (or tracing not yet imported by anything) -> None in
    a few instructions — this sits on the record_stage hot path."""
    global _tracing_mod
    if _tracing_mod is None:
        from flyimg_tpu_torch.runtime import tracing as _t

        _tracing_mod = _t
    trace = _tracing_mod.current_trace()
    return trace.trace_id if trace is not None else None


def bucket_index(value: float, bounds: Tuple[float, ...]) -> int:
    """Index of the bucket ``value`` lands in (len(bounds) = overflow).
    THE bucketing rule — Histogram.observe and the SLO engine's window
    slices must agree or their quantiles drift apart."""
    for i, bound in enumerate(bounds):
        if value <= bound:
            return i
    return len(bounds)


def quantile_from_counts(counts: List[int], bounds: Tuple[float, ...],
                         q: float) -> float:
    """In-bucket linearly interpolated q-quantile over bucket counts (the
    histogram_quantile() rule). ONE copy shared by Histogram.quantile and
    the SLO engine's windowed p99, so the two never drift apart. Overflow-bucket quantiles are +inf (no upper
    bound to interpolate toward); empty counts -> 0."""
    n = sum(counts)
    if n == 0:
        return 0.0
    target = q * n
    acc = 0
    for i, c in enumerate(counts):
        prev = acc
        acc += c
        if acc >= target and c > 0:
            if i >= len(bounds):
                return float("inf")
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * ((target - prev) / c)
    return float("inf")


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping (exposition format allows \\\\ \\"
    \\n only). EVERY label whose value is not a literal in this module
    goes through here — route/stage/point/reason strings reach the
    registry from request paths and a crafted value must not corrupt the
    exposition format."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


class Counter:
    """Monotonic counter with optional labels baked into the name."""

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = name
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value: settable, inc/dec-able, or backed by a
    callback (``fn``) sampled at render time — the right shape for
    in-flight request counts, queue depths, and open-breaker counts,
    which are states, not monotonic totals."""

    def __init__(self, name: str, help_text: str = "",
                 fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self.help = help_text
        self._fn = fn
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                # a dead callback must not take /metrics down with it
                return float("nan")
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with quantile estimation and optional
    OpenMetrics exemplars. Default bounds are the log-spaced latency
    ladder; ``bounds`` overrides them for non-latency distributions
    (occupancy ratios, batch-size buckets)."""

    def __init__(self, name: str, help_text: str = "",
                 bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.help = help_text
        self.bounds: Tuple[float, ...] = (
            BUCKET_BOUNDS if bounds is None else tuple(bounds)
        )
        self._counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self._sum = 0.0
        self._n = 0
        # per-bucket exemplar: (observed value, trace_id, unix ts) — the
        # OpenMetrics hook that links a latency bucket to one concrete
        # trace in the ring (last observation wins, the standard policy)
        self._exemplars: Dict[int, Tuple[float, str, float]] = {}
        self._lock = threading.Lock()

    def observe(self, seconds: float, trace_id: Optional[str] = None) -> None:
        idx = bucket_index(seconds, self.bounds)
        with self._lock:
            self._counts[idx] += 1
            self._sum += seconds
            self._n += 1
            if trace_id:
                self._exemplars[idx] = (seconds, trace_id, time.time())

    def quantile(self, q: float) -> float:
        """Estimate of the q-quantile (0 < q <= 1), interpolated linearly
        within the winning bucket (the histogram_quantile() rule):
        returning the bucket's upper bound over-reported p50/p99 by up to
        one bucket factor (1.8x) whenever the mass sat near a bucket's
        lower edge. Overflow-bucket quantiles stay +inf — there is no
        upper bound to interpolate toward."""
        with self._lock:
            counts = list(self._counts)
        return quantile_from_counts(counts, self.bounds, q)

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._n

    def exemplars(self) -> Dict[int, Tuple[float, str, float]]:
        with self._lock:
            return dict(self._exemplars)


class BatchEfficiency:
    """Rolling batch-efficiency window for ONE controller: the last
    ``window`` launches' occupancy, padded-slot waste, queue-wait vs
    device-time share, and compile amortization. Counters answer
    "since boot"; operators tuning ``batch_deadline_ms``/``batch_max_size``
    need "lately" — this is the object behind ``/debug/perf`` and the
    batcher's ``stats()``."""

    def __init__(self, window: int = 256) -> None:
        self._lock = threading.Lock()
        # (images, capacity, queue_wait_s, device_s, compile_hit|None)
        self._entries: deque = deque(maxlen=max(1, int(window)))
        # monotone launches-ever-recorded counter: the rolling window
        # itself never expires by time, so consumers that need RECENCY
        # (the autotuner's since-last-evaluation launch delta) diff this
        self._recorded_total = 0

    def record(self, *, images: int, capacity: int, queue_wait_s: float,
               device_s: Optional[float],
               compile_hit: Optional[bool]) -> None:
        with self._lock:
            self._recorded_total += 1
            self._entries.append((
                int(images), int(capacity), max(float(queue_wait_s), 0.0),
                float(device_s) if device_s is not None else 0.0,
                compile_hit,
            ))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            entries = list(self._entries)
            recorded_total = self._recorded_total
        if not entries:
            return {
                "window_batches": 0, "mean_occupancy": 0.0,
                "padding_waste": 0.0, "queue_wait_share": 0.0,
                "batches_per_compile_miss": 0.0,
                "mean_queue_wait_ms": 0.0, "mean_device_ms": 0.0,
                "recorded_total": 0,
            }
        images = sum(e[0] for e in entries)
        slots = sum(e[1] for e in entries)
        queue_wait = sum(e[2] for e in entries)
        device = sum(e[3] for e in entries)
        # compile amortization counts only launches where a compile COULD
        # have happened (compile_hit is None for aux/host-codec launches);
        # zero misses in the window reports the window length — a floor,
        # not an exact amortization
        compiled = [e[4] for e in entries if e[4] is not None]
        misses = sum(1 for hit in compiled if not hit)
        occupancy = images / slots if slots else 0.0
        return {
            "window_batches": len(entries),
            "mean_occupancy": occupancy,
            "padding_waste": 1.0 - occupancy if slots else 0.0,
            "queue_wait_share": (
                queue_wait / (queue_wait + device)
                if (queue_wait + device) > 0 else 0.0
            ),
            "batches_per_compile_miss": (
                len(compiled) / misses if misses
                else float(len(compiled))
            ),
            "mean_queue_wait_ms": queue_wait / len(entries) * 1000.0,
            "mean_device_ms": device / len(entries) * 1000.0,
            "recorded_total": recorded_total,
        }


class PoolUtilization:
    """Rolling busy-ratio tracker for one host worker pool (the decode /
    encode codec pools). ``track()`` wraps each pool call; the gauge
    callback reads ``busy_ratio()`` — summed busy time overlapping the
    trailing window, divided by the window. Concurrent callers stack, so
    a ratio above 1.0 means the pool is oversubscribed (more wall-clock
    demand than one serial pool can supply) — exactly the saturation
    signal the host-codec pipelined-DAG work (ROADMAP item 4) needs to
    start from a measurement instead of a guess."""

    def __init__(self, window_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.window_s = max(float(window_s), 0.1)
        self._clock = clock
        self._lock = threading.Lock()
        self._intervals: deque = deque()  # (start, end) monotonic pairs

    def track(self):
        """Context manager around ONE pool call."""
        return _PoolTrack(self)

    def _record(self, start: float, end: float) -> None:
        with self._lock:
            self._intervals.append((start, end))
            self._prune_locked(end)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._intervals and self._intervals[0][1] < horizon:
            self._intervals.popleft()

    def busy_ratio(self) -> float:
        now = self._clock()
        horizon = now - self.window_s
        with self._lock:
            self._prune_locked(now)
            busy = sum(
                min(end, now) - max(start, horizon)
                for start, end in self._intervals
            )
        return max(busy, 0.0) / self.window_s


class _PoolTrack:
    __slots__ = ("_pool", "_t0")

    def __init__(self, pool: PoolUtilization) -> None:
        self._pool = pool

    def __enter__(self):
        self._t0 = self._pool._clock()
        return self

    def __exit__(self, *exc):
        self._pool._record(self._t0, self._pool._clock())
        return False


# process-wide host-pool trackers (like the native pools they watch —
# one decode pool per process, whatever the app count); apps export them
# through flyimg_host_pool_busy_ratio gauge callbacks (service/app.py)
_host_pools: Dict[str, PoolUtilization] = {}
_host_pools_lock = threading.Lock()


def host_pool(name: str) -> PoolUtilization:
    """Get-or-create the utilization tracker for one host pool
    ('decode' / 'encode'; the codec layer wraps its pool calls)."""
    with _host_pools_lock:
        pool = _host_pools.get(name)
        if pool is None:
            pool = PoolUtilization()
            _host_pools[name] = pool
        return pool


class MetricsRegistry:
    """Named metric store; one per app."""

    def __init__(self, *, exemplars: bool = True) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # OpenMetrics exemplars on latency-histogram buckets (the
        # `metrics_exemplars` appconfig knob): each bucket remembers the
        # last traced observation that landed in it, so an SLO breach
        # links straight from /metrics to /debug/traces/{id}
        self.exemplars_enabled = bool(exemplars)
        # rolling per-controller batch-efficiency windows (runtime/batcher)
        self._batch_eff: Dict[str, BatchEfficiency] = {}
        # SLO engine attached by the app (runtime/slo.py) so summary()
        # speaks the same vocabulary as /debug/slo
        self._slo = None
        self.started_at = time.time()

    def _exemplar_trace_id(self) -> Optional[str]:
        if not self.exemplars_enabled:
            return None
        return _ambient_trace_id()

    def counter(self, name: str, help_text: str = "") -> Counter:
        with self._lock:
            metric = self._counters.get(name)
            if metric is None:
                metric = Counter(name, help_text)
                self._counters[name] = metric
            return metric

    def gauge(self, name: str, help_text: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        """Get-or-create a gauge; ``fn`` (sampled at render time) wins on
        first creation and is re-armed on later calls that pass one — so
        wiring code can idempotently re-register a callback."""
        with self._lock:
            metric = self._gauges.get(name)
            if metric is None:
                metric = Gauge(name, help_text, fn=fn)
                self._gauges[name] = metric
            elif fn is not None:
                metric._fn = fn
            return metric

    def histogram(self, name: str, help_text: str = "",
                  bounds: Optional[Tuple[float, ...]] = None) -> Histogram:
        with self._lock:
            metric = self._histograms.get(name)
            if metric is None:
                metric = Histogram(name, help_text, bounds=bounds)
                self._histograms[name] = metric
            return metric

    def batch_efficiency(self, controller: str) -> BatchEfficiency:
        """Get-or-create the rolling efficiency window for one batch
        controller (keyed by its name: 'device', 'codec', ...)."""
        with self._lock:
            eff = self._batch_eff.get(controller)
            if eff is None:
                eff = BatchEfficiency()
                self._batch_eff[controller] = eff
            return eff

    def attach_slo(self, engine) -> None:
        """Attach the app's SLO engine so summary() carries its burn
        rates/budget alongside the batch-efficiency fields."""
        self._slo = engine

    def family_total(self, family: str) -> float:
        """Sum of every sample in one counter/gauge family across all
        label sets, without re-parsing exposition names. Dead gauge
        callbacks (NaN) are skipped, like the renderer tolerates them."""
        with self._lock:
            samples = list(self._counters.values()) + list(
                self._gauges.values()
            )
        total = 0.0
        for metric in samples:
            if _bare(metric.name) != family:
                continue
            value = metric.value
            if value == value:  # skip NaN
                total += float(value)
        return total

    # -- recording helpers used by the serving path ------------------------

    def record_request(self, route: str, status: int) -> None:
        # route can derive from a client-controlled path segment: escape
        # it like record_breaker escapes host, or a crafted segment could
        # corrupt the exposition format
        safe = escape_label_value(route)
        self.counter(
            f'flyimg_requests_total{{route="{safe}",status="{int(status)}"}}',
            "HTTP requests by route and status",
        ).inc()

    def record_stage(self, stage: str, seconds: float) -> None:
        self.histogram(
            f'flyimg_stage_seconds{{stage="{escape_label_value(stage)}"}}',
            "Per-stage pipeline latency",
        ).observe(seconds, trace_id=self._exemplar_trace_id())

    def record_device_batch_seconds(
        self, seconds: float, trace_id: Optional[str] = None
    ) -> None:
        """Wall time of one device batch from dispatch to completed
        device->host readback (runtime/batcher.py profiling hook).
        ``trace_id`` is a member request's trace for the bucket exemplar —
        drain threads have no ambient trace, so the batcher passes one."""
        self.histogram(
            "flyimg_device_seconds",
            "Per-batch device time, dispatch to completed readback",
        ).observe(
            seconds,
            trace_id=trace_id if self.exemplars_enabled else None,
        )

    def record_device_split(
        self,
        *,
        h2d_s: Optional[float] = None,
        dispatch_s: Optional[float] = None,
        sync_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        """The per-launch device-time split (runtime/batcher.py): host->
        device transfer and device->host readback sync land in
        ``flyimg_device_transfer_seconds{direction=}``, the asynchronous
        dispatch (the launch enqueue; the help text keeps the JAX
        package's wording) in ``flyimg_device_dispatch_seconds``.
        ``flyimg_device_seconds`` keeps its meaning as the total —
        these are its components, recorded per launch so the
        dispatch and readback costs stay visible separately."""
        exemplar = trace_id if self.exemplars_enabled else None
        if h2d_s is not None:
            self.histogram(
                'flyimg_device_transfer_seconds{direction="h2d"}',
                "Host<->device transfer time per batch launch, by direction",
            ).observe(max(float(h2d_s), 0.0), trace_id=exemplar)
        if dispatch_s is not None:
            self.histogram(
                "flyimg_device_dispatch_seconds",
                "Asynchronous dispatch (launch enqueue) time per batch; "
                "includes the synchronous XLA compile on a miss",
            ).observe(max(float(dispatch_s), 0.0), trace_id=exemplar)
        if sync_s is not None:
            self.histogram(
                'flyimg_device_transfer_seconds{direction="d2h"}',
                "Host<->device transfer time per batch launch, by direction",
            ).observe(max(float(sync_s), 0.0), trace_id=exemplar)

    def record_compile_event(self, cache_hit: bool) -> None:
        """Batched-program compile cache outcome per device batch."""
        result = "hit" if cache_hit else "miss"
        self.counter(
            f'flyimg_compile_events_total{{result="{result}"}}',
            "Device-program compile cache outcomes per batch",
        ).inc()

    def record_cache(self, hit: bool) -> None:
        self.counter(
            f'flyimg_cache_total{{result="{"hit" if hit else "miss"}"}}',
            "Output-cache lookups",
        ).inc()

    # -- resilience counters (runtime/resilience.py) -----------------------

    def record_retry(self, point: str) -> None:
        self.counter(
            f'flyimg_retries_total{{point="{escape_label_value(point)}"}}',
            "Transient-failure retries by pipeline point",
        ).inc()

    def record_breaker(self, host: str, state: str) -> None:
        # host derives from a client-controlled URL: escape it so a crafted
        # value cannot break the exposition format
        safe = escape_label_value(host)
        self.counter(
            f'flyimg_breaker_transitions_total{{host="{safe}",to="{state}"}}',
            "Circuit-breaker state transitions by upstream host",
        ).inc()

    def record_shed(self, reason: str) -> None:
        self.counter(
            f'flyimg_shed_total{{reason="{escape_label_value(reason)}"}}',
            "Requests shed by admission control / open circuits",
        ).inc()

    def record_deadline_hit(self, stage: str) -> None:
        self.counter(
            "flyimg_deadline_exceeded_total"
            f'{{stage="{escape_label_value(stage)}"}}',
            "Requests that exhausted their latency budget, by stage",
        ).inc()

    # -- batch failure-containment counters (runtime/batcher.py) ------------

    def record_batch_retry(self) -> None:
        self.counter(
            "flyimg_batch_retries_total",
            "Whole-batch re-executions after transient device failures",
        ).inc()

    def record_poison_isolated(self) -> None:
        self.counter(
            "flyimg_poison_isolated_total",
            "Poison batch members isolated by bisection (innocents saved)",
        ).inc()

    def record_quarantine_hit(self) -> None:
        self.counter(
            "flyimg_quarantine_hits_total",
            "Submissions short-circuited by the poison quarantine table",
        ).inc()

    def record_executor_restart(self, reason: str) -> None:
        self.counter(
            "flyimg_executor_restarts_total"
            f'{{reason="{escape_label_value(reason)}"}}',
            "Batch executor threads replaced by self-healing (dead/wedged)",
        ).inc()

    def record_cache_corrupt(self) -> None:
        self.counter(
            "flyimg_cache_corrupt_total",
            "Cached outputs that failed read-time integrity validation",
        ).inc()

    def record_batch(self, images: int, capacity: int) -> None:
        self.counter(
            "flyimg_batches_total", "Device batches executed"
        ).inc()
        self.counter(
            "flyimg_images_processed_total", "Images through the device"
        ).inc(images)
        self.counter(
            "flyimg_batch_slots_total", "Padded batch slots (occupancy denom)"
        ).inc(capacity)

    def record_batch_launch(
        self,
        controller: str,
        *,
        images: int,
        capacity: int,
        queue_wait_s: float,
        device_s: Optional[float] = None,
        compile_hit: Optional[bool] = None,
        trace_id: Optional[str] = None,
        aux: bool = False,
    ) -> None:
        """THE per-launch efficiency record (runtime/batcher.py, primary
        and recovery launches alike): feeds the global batch counters
        (transform launches only — aux items are counted by their own
        family), the per-controller occupancy/bucket/queue-wait
        histograms, and the rolling efficiency window behind
        ``/debug/perf``. ``compile_hit`` is None for launches with no
        compile step (aux runners)."""
        if not aux:
            self.record_batch(images, capacity)
        safe = escape_label_value(controller)
        self.histogram(
            f'flyimg_batch_occupancy_ratio{{controller="{safe}"}}',
            "Per-launch batch occupancy (images / padded slots)",
            bounds=OCCUPANCY_BOUNDS,
        ).observe(images / capacity if capacity else 0.0)
        self.histogram(
            f'flyimg_batch_bucket_size{{controller="{safe}"}}',
            "Padded batch-bucket sizes actually launched",
            bounds=BATCH_SIZE_BOUNDS,
        ).observe(float(capacity))
        self.histogram(
            f'flyimg_batch_queue_wait_seconds{{controller="{safe}"}}',
            "Oldest-member queue wait at launch time",
        ).observe(
            max(float(queue_wait_s), 0.0),
            trace_id=trace_id if self.exemplars_enabled else None,
        )
        self.batch_efficiency(controller).record(
            images=images, capacity=capacity, queue_wait_s=queue_wait_s,
            device_s=device_s, compile_hit=compile_hit,
        )

    # -- rendering ---------------------------------------------------------

    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition. Metric objects are stored per
        label-set, so rendering groups them into families (one HELP/TYPE
        block per bare metric name, all samples contiguous) as the
        exposition format requires.

        ``openmetrics=True`` (the Accept-negotiated scrape) additionally
        emits bucket exemplars and the ``# EOF`` terminator. The default
        text/plain rendering stays pure 0.0.4: the classic format has NO
        exemplar syntax, and a stock Prometheus text parser aborts the
        whole scrape on a trailing ``# {...}`` token — exemplars must
        only reach clients that negotiated for them (service/app.py)."""
        lines: List[str] = []
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())

        for family in _families(counters):
            head = family[0]
            if head.help:
                lines.append(f"# HELP {_bare(head.name)} {head.help}")
                lines.append(f"# TYPE {_bare(head.name)} counter")
            for c in family:
                lines.append(f"{c.name} {_fmt(c.value)}")

        for family in _families(gauges):
            head = family[0]
            if head.help:
                lines.append(f"# HELP {_bare(head.name)} {head.help}")
                lines.append(f"# TYPE {_bare(head.name)} gauge")
            for g in family:
                lines.append(f"{g.name} {_fmt(g.value)}")

        for family in _families(histograms):
            head = family[0]
            bare = _bare(head.name)
            if head.help:
                lines.append(f"# HELP {bare} {head.help}")
                lines.append(f"# TYPE {bare} histogram")
            for h in family:
                counts, total, n = h.snapshot()
                exemplars = (
                    h.exemplars()
                    if openmetrics and self.exemplars_enabled else {}
                )
                acc = 0
                for i, count in enumerate(counts):
                    acc += count
                    le = (
                        f"{h.bounds[i]:.6f}" if i < len(h.bounds) else "+Inf"
                    )
                    line = (
                        f'{_with_label(h.name, "le", le, suffix="_bucket")} '
                        f"{acc}"
                    )
                    ex = exemplars.get(i)
                    if ex is not None:
                        # OpenMetrics exemplar: ` # {labels} value ts` —
                        # bucket lines ONLY (the conformance test pins
                        # this); links the bucket to one kept trace
                        value, trace_id, ts = ex
                        line += (
                            f' # {{trace_id="{escape_label_value(trace_id)}"'
                            f"}} {_fmt(value)} {ts:.3f}"
                        )
                    lines.append(line)
                lines.append(f"{_suffixed(h.name, '_sum')} {_fmt(total)}")
                lines.append(f"{_suffixed(h.name, '_count')} {n}")
        lines.append("# HELP flyimg_uptime_seconds Process uptime")
        lines.append("# TYPE flyimg_uptime_seconds gauge")
        lines.append(
            f"flyimg_uptime_seconds {_fmt(time.time() - self.started_at)}"
        )
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def summary(self) -> Dict[str, float]:
        """Human/JSON view: key counters + p50/p99 per stage, plus the
        rolling batch-efficiency windows and (when an SLO engine is
        attached) the burn rates and budget — one vocabulary shared by
        bulk sweeps, /debug/perf, and /debug/slo."""
        out: Dict[str, float] = {}
        with self._lock:
            counters = dict(self._counters)
            histograms = dict(self._histograms)
            batch_eff = dict(self._batch_eff)
            slo = self._slo
        for name, c in counters.items():
            out[name] = c.value
        for name, h in histograms.items():
            out[f"{name}:p50"] = h.quantile(0.5)
            out[f"{name}:p99"] = h.quantile(0.99)
        slots = out.get("flyimg_batch_slots_total", 0.0)
        if slots:
            occupancy = (
                out.get("flyimg_images_processed_total", 0.0) / slots
            )
            out["flyimg_batch_occupancy"] = occupancy
            out["flyimg_batch_padding_waste"] = 1.0 - occupancy
        for name, eff in batch_eff.items():
            stats = eff.stats()
            for key in (
                "mean_occupancy", "padding_waste", "queue_wait_share",
                "batches_per_compile_miss",
            ):
                out[f"batch_efficiency:{name}:{key}"] = stats[key]
        if slo is not None and getattr(slo, "enabled", False):
            for key, value in slo.summary_fields().items():
                out[f"slo:{key}"] = value
        # per-plan cost ledger aggregates (runtime/costledger.py): the
        # same attribution vocabulary /debug/plans serves, folded in so
        # one summary carries the ledger's accounting
        try:
            from flyimg_tpu_torch.runtime.costledger import get_ledger

            for key, value in get_ledger().aggregates().items():
                out[f"plan_ledger:{key}"] = value
        except Exception:
            pass  # accounting must never fail a summary
        return out

    def perf_snapshot(self) -> Dict[str, object]:
        """The /debug/perf JSON document: per-controller rolling batch
        efficiency plus per-stage and device-time quantiles — the answers
        "Beyond Inference" says dominate vision-serving latency (queueing,
        padding, host codec), in one operator-readable place."""
        with self._lock:
            histograms = dict(self._histograms)
            batch_eff = dict(self._batch_eff)

        def _ms(seconds: float) -> Optional[float]:
            if seconds != seconds or seconds == float("inf"):
                return None  # overflow-bucket quantile: no upper bound
            return round(seconds * 1000.0, 3)

        stages: Dict[str, Dict[str, object]] = {}
        for name, h in histograms.items():
            match = re.match(r'flyimg_stage_seconds\{stage="([^"]*)"\}', name)
            if match is None:
                continue
            _, _, n = h.snapshot()
            stages[match.group(1)] = {
                "count": n,
                "p50_ms": _ms(h.quantile(0.5)),
                "p99_ms": _ms(h.quantile(0.99)),
            }
        device = histograms.get("flyimg_device_seconds")
        device_doc = None
        if device is not None:
            _, _, n = device.snapshot()
            device_doc = {
                "batches": n,
                "p50_ms": _ms(device.quantile(0.5)),
                "p99_ms": _ms(device.quantile(0.99)),
            }
        controllers = {}
        for name, eff in batch_eff.items():
            stats = eff.stats()
            controllers[name] = {
                key: (round(value, 4) if isinstance(value, float) else value)
                for key, value in stats.items()
            }
        return {
            "controllers": controllers,
            "stages": stages,
            "device": device_doc,
        }


def _families(metrics: Iterable) -> List[List]:
    """Group metric objects by bare family name, preserving first-seen
    order of families and of members within a family."""
    grouped: Dict[str, List] = {}
    for metric in metrics:
        grouped.setdefault(_bare(metric.name), []).append(metric)
    return list(grouped.values())


def _bare(name: str) -> str:
    return name.split("{", 1)[0]


def _suffixed(name: str, suffix: str) -> str:
    if "{" in name:
        head, rest = name.split("{", 1)
        return f"{head}{suffix}{{{rest}"
    return name + suffix


def _with_label(name: str, key: str, value: str, suffix: str = "") -> str:
    if "{" in name:
        head, rest = name.split("{", 1)
        rest = rest.rstrip("}")
        return f'{head}{suffix}{{{rest},{key}="{value}"}}'
    return f'{name}{suffix}{{{key}="{value}"}}'


def _fmt(value: float) -> str:
    if value != value:  # NaN (a dead gauge callback): int() would raise
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)
