"""End-to-end request tracing for the serving pipeline.

The port of ``flyimg_tpu/runtime/tracing.py``, unchanged in behaviour: the
metrics registry answers "how is the service doing", a trace "why was THIS
request slow" when the latency splits across fetch, decode, batch wait, a
*shared* device batch and encode.

- Each request gets a ``Trace``, honouring an inbound W3C ``traceparent``
  header when present and minting ids otherwise, holding a tree of
  ``Span``s (fetch, decode, batch_wait, device_execute, encode, storage).
- The batcher attributes the SHARED device-batch span back to every member
  request's trace (the same span id in each), carrying batch id,
  occupancy, padded slots and the device time split.
- Resilience events (retries, breaker transitions, deadline hits, sheds)
  land as span *events* on whichever span was active.
- Completed traces pass a **tail-based sampler**: errors (5xx), deadline
  hits and slow requests (``slow_threshold_s``) are always kept; the rest
  keep with probability ``sample_rate``. Kept traces land in a bounded
  in-process ring served by the debug-gated ``/debug/traces`` routes
  (service/app.py).

Ambient propagation is a ``threading.local``: request work runs on the
server's request threads, the host stage pools and the batchers' threads,
so each hands the trace on explicitly (``activate``), and everything below
reaches it through ``current_trace``/``add_event`` without signature
changes. With no trace active every helper returns in a few instructions.
"""

from __future__ import annotations

import random
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "activate",
    "current_trace",
    "current_span",
    "span",
    "add_event",
    "parse_traceparent",
    "format_traceparent",
    "server_timing",
]

# hard ceiling on spans held per trace: a pathological request (hundreds of
# GIF frames, each a batch member) must not grow one trace without bound;
# overflow is counted on the trace so the truncation is visible
MAX_SPANS_PER_TRACE = 256
# and on events per span (retry storms)
MAX_EVENTS_PER_SPAN = 64

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def _new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


def parse_traceparent(header: str) -> Optional[Dict[str, str]]:
    """Parse a W3C ``traceparent`` header -> {trace_id, parent_id, flags},
    or None when malformed / all-zero (the spec says treat those as
    absent and mint fresh ids)."""
    match = _TRACEPARENT_RE.match((header or "").strip().lower())
    if match is None:
        return None
    version, trace_id, parent_id, flags = match.groups()
    if version == "ff" or trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return {"trace_id": trace_id, "parent_id": parent_id, "flags": flags}


def format_traceparent(trace_id: str, span_id: str, sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


class Span:
    """One timed operation in a trace. Wall-clock anchored at ``start_s``
    (epoch, for display); durations measured on the monotonic clock."""

    __slots__ = (
        "name", "span_id", "parent_id", "start_s", "_t0",
        "duration_s", "attributes", "events", "status",
    )

    def __init__(self, name: str, parent_id: Optional[str] = None,
                 span_id: Optional[str] = None) -> None:
        self.name = name
        self.span_id = span_id or _new_span_id()
        self.parent_id = parent_id
        self.start_s = time.time()
        self._t0 = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.attributes: Dict[str, object] = {}
        self.events: List[Dict[str, object]] = []
        self.status = "ok"

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs) -> None:
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            return
        event = {"name": name, "t_s": time.time()}
        if attrs:
            event.update(attrs)
        self.events.append(event)

    def end(self, status: Optional[str] = None) -> None:
        if self.duration_s is None:
            self.duration_s = time.perf_counter() - self._t0
        if status is not None:
            self.status = status

    def as_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": self.start_s,
            "duration_s": self.duration_s,
            "status": self.status,
            "attributes": dict(self.attributes),
            "events": list(self.events),
        }


class Trace:
    """All spans of one request. Thread-safe: the request thread nests
    spans through its own stack while the batcher's drain thread attaches
    the shared device-batch span concurrently."""

    def __init__(
        self,
        trace_id: Optional[str] = None,
        *,
        parent_id: Optional[str] = None,
        name: str = "request",
    ) -> None:
        self.trace_id = trace_id or _new_trace_id()
        self._lock = threading.Lock()
        self.dropped_spans = 0
        self.root = Span(name, parent_id=parent_id)
        self.spans: List[Span] = [self.root]
        # per-activation span stack lives on the ambient threading.local
        # (one request thread at a time drives the pipeline); the trace
        # itself only stores completed structure
        self.deadline_hit = False
        # force_keep overrides the tail sampler's probability roll: set
        # by the SLO engine on the trace that tipped a breach, which may
        # be neither an error nor "slow" by the tracing threshold (e.g.
        # 200 ms against a 150 ms objective but a 500 ms slow bar) — the
        # breach log's trace id must stay retrievable regardless of
        # sample_rate
        self.force_keep = False
        self.finished = False

    # -- span management ---------------------------------------------------

    def start_span(self, name: str, parent_id: Optional[str] = None) -> Span:
        child = Span(name, parent_id=parent_id or self.root.span_id)
        self._append(child)
        return child

    def _append(self, span_obj: Span) -> bool:
        with self._lock:
            if len(self.spans) >= MAX_SPANS_PER_TRACE:
                self.dropped_spans += 1
                return False
            self.spans.append(span_obj)
            return True

    def attach_shared(self, shared: Span, parent_id: Optional[str]) -> None:
        """Attach a span SHARED with other traces (the device batch): same
        span id and timing everywhere, re-parented under this trace's own
        submitting span."""
        copy = Span(shared.name, parent_id=parent_id or self.root.span_id,
                    span_id=shared.span_id)
        copy.start_s = shared.start_s
        copy.duration_s = shared.duration_s
        copy.status = shared.status
        copy.attributes = dict(shared.attributes)
        copy.events = list(shared.events)
        self._append(copy)

    def add_event(self, name: str, span_obj: Optional[Span] = None, **attrs):
        target = span_obj or self.root
        if name == "deadline.exceeded":
            self.deadline_hit = True
        target.add_event(name, **attrs)

    # -- finishing / rendering --------------------------------------------

    def finish(self, status: Optional[str] = None) -> None:
        self.root.end(status)
        self.finished = True

    @property
    def duration_s(self) -> float:
        return self.root.duration_s or 0.0

    @property
    def is_error(self) -> bool:
        return self.root.status not in ("ok",) or self.deadline_hit

    def as_dict(self) -> Dict[str, object]:
        with self._lock:
            spans = [s.as_dict() for s in self.spans]
        by_id = {s["span_id"]: s for s in spans}
        roots: List[Dict[str, object]] = []
        for s in spans:
            s["children"] = []
        for s in spans:
            parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
            if parent is not None and parent is not s:
                parent["children"].append(s)
            else:
                roots.append(s)
        return {
            "trace_id": self.trace_id,
            "duration_s": self.duration_s,
            "status": self.root.status,
            "deadline_hit": self.deadline_hit,
            "dropped_spans": self.dropped_spans,
            "spans": roots,
        }

    def summary(self) -> Dict[str, object]:
        with self._lock:
            n_spans = len(self.spans)
        return {
            "trace_id": self.trace_id,
            "name": self.root.name,
            "route": self.root.attributes.get("route"),
            "status": self.root.status,
            "http_status": self.root.attributes.get("http.status"),
            "duration_ms": round(self.duration_s * 1000.0, 3),
            "deadline_hit": self.deadline_hit,
            "n_spans": n_spans,
            "start_s": self.root.start_s,
        }


# ---------------------------------------------------------------------------
# ambient propagation (threading.local — request work runs on executor
# threads, so asyncio contextvars would not cross the boundary anyway)

_local = threading.local()


def current_trace() -> Optional[Trace]:
    return getattr(_local, "trace", None)


def current_span() -> Optional[Span]:
    stack = getattr(_local, "stack", None)
    if stack:
        return stack[-1]
    trace = current_trace()
    return trace.root if trace is not None else None


@contextmanager
def activate(trace: Optional[Trace]):
    """Bind ``trace`` as this thread's ambient trace (None = no-op). The
    HTTP layer wraps the executor callable in this so every stage below
    sees the trace without signature changes."""
    if trace is None:
        yield None
        return
    prev_trace = getattr(_local, "trace", None)
    prev_stack = getattr(_local, "stack", None)
    _local.trace = trace
    _local.stack = [trace.root]
    try:
        yield trace
    finally:
        _local.trace = prev_trace
        _local.stack = prev_stack


@contextmanager
def span(name: str, **attrs):
    """Open a child span under the current one; no active trace -> a
    cheap no-op (the untraced fast path stays a getattr + compare)."""
    trace = current_trace()
    if trace is None:
        yield None
        return
    parent = current_span()
    child = trace.start_span(
        name, parent_id=parent.span_id if parent else None
    )
    if attrs:
        child.attributes.update(attrs)
    _local.stack.append(child)
    try:
        yield child
    except BaseException as exc:
        child.add_event("exception", type=type(exc).__name__, message=str(exc))
        child.end("error")
        raise
    finally:
        if child.duration_s is None:
            child.end()
        stack = getattr(_local, "stack", None)
        if stack and stack[-1] is child:
            stack.pop()


def add_event(name: str, **attrs) -> None:
    """Record an event on the active span (no trace -> no-op). The
    resilience layer calls this at every retry/breaker/deadline/shed so
    those defenses show up inside the affected request's trace."""
    trace = current_trace()
    if trace is None:
        return
    trace.add_event(name, span_obj=current_span(), **attrs)


# ---------------------------------------------------------------------------
# Server-Timing: the span tree flattened into one response header

# header metric names are RFC 8941 tokens: letters/digits/_- only
_ST_NAME_RE = re.compile(r"[^a-zA-Z0-9_-]+")


def server_timing(trace: Trace, max_entries: int = 16) -> str:
    """Flatten one finished trace into a ``Server-Timing`` header value:
    per-stage durations (fetch/decode/batch_wait/device/encode/...) in
    first-seen order, same-name spans summed (the two storage spans), the
    root appended as ``total``. Operators get the stage split from a bare
    ``curl -sD-`` without opening the trace ring — gated on the ``debug``
    server param by the HTTP layer (service/app.py), never on by default:
    stage timings are an internal detail, not a public response contract.
    """
    durations: Dict[str, float] = {}
    order: List[str] = []
    with trace._lock:
        spans = list(trace.spans)

    def _add(name: str, seconds: float) -> None:
        if name not in durations:
            order.append(name)
            durations[name] = 0.0
        durations[name] += seconds

    for span_obj in spans[1:]:  # [0] is the root, reported as `total`
        if span_obj.duration_s is None:
            continue
        name = (
            "device" if span_obj.name == "device_execute" else span_obj.name
        )
        name = _ST_NAME_RE.sub("_", name)
        _add(name, span_obj.duration_s)
        if span_obj.name == "device_execute":
            # the batcher's h2d / dispatch / readback-sync split rides
            # the shared span as attributes; surface it next to the
            # total so a bare curl shows where device time went
            for attr, st_name in (
                ("device.h2d_s", "device_h2d"),
                ("device.dispatch_s", "device_dispatch"),
                ("device.sync_s", "device_sync"),
            ):
                value = span_obj.attributes.get(attr)
                if isinstance(value, (int, float)):
                    _add(st_name, float(value))
    parts = [
        f"{name};dur={durations[name] * 1000.0:.2f}"
        for name in order[:max_entries]
    ]
    if trace.root.duration_s is not None:
        parts.append(f"total;dur={trace.root.duration_s * 1000.0:.2f}")
    return ", ".join(parts)


# ---------------------------------------------------------------------------
# tracer: trace factory + tail-sampled ring buffer


class Tracer:
    """Trace factory and bounded store with tail-based sampling.

    Keep decision happens at trace COMPLETION (tail-based): errors,
    deadline hits, and requests slower than ``slow_threshold_s`` always
    keep; the rest keep with probability ``sample_rate``. The ring holds
    at most ``buffer_size`` traces — memory stays bounded no matter the
    request rate.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        buffer_size: int = 256,
        sample_rate: float = 1.0,
        slow_threshold_s: float = 0.5,
        metrics=None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.buffer_size = max(1, int(buffer_size))
        self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)
        self.slow_threshold_s = float(slow_threshold_s)
        self._metrics = metrics
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._ring: List[Trace] = []
        self._by_id: Dict[str, Trace] = {}

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "Tracer":
        return cls(
            enabled=bool(params.by_key("tracing_enabled", True)),
            buffer_size=int(params.by_key("tracing_buffer_size", 256)),
            sample_rate=float(params.by_key("tracing_sample_rate", 1.0)),
            slow_threshold_s=float(
                params.by_key("tracing_slow_threshold_s", 0.5)
            ),
            metrics=metrics,
        )

    # -- trace lifecycle ---------------------------------------------------

    def start(self, traceparent: Optional[str] = None,
              name: str = "request") -> Optional[Trace]:
        """Mint a trace (or None when tracing is off). An inbound W3C
        ``traceparent`` is honored: its trace id is reused and its parent
        id becomes the root span's parent, so this service's spans join
        the caller's trace."""
        if not self.enabled:
            return None
        inbound = parse_traceparent(traceparent) if traceparent else None
        if inbound is not None:
            return Trace(
                inbound["trace_id"], parent_id=inbound["parent_id"], name=name
            )
        return Trace(name=name)

    def keep_reason(self, trace: Trace) -> Optional[str]:
        """Tail-sampling policy, in priority order. None = drop."""
        if trace.is_error:
            return "error"
        if trace.force_keep:
            return "forced"
        if trace.duration_s >= self.slow_threshold_s:
            return "slow"
        if self.sample_rate >= 1.0 or self._rng.random() < self.sample_rate:
            return "sampled"
        return None

    def finish(self, trace: Optional[Trace],
               status: Optional[str] = None) -> Optional[str]:
        """Close the root span, run the tail sampler, and (when kept)
        commit the trace to the ring. Returns the keep reason or None."""
        if trace is None:
            return None
        trace.finish(status)
        reason = self.keep_reason(trace)
        if self._metrics is not None:
            self._metrics.counter(
                f'flyimg_traces_total{{kept="{reason or "dropped"}"}}',
                "Completed traces by tail-sampling outcome",
            ).inc()
        if reason is None:
            return None
        trace.root.set_attribute("sampling.keep_reason", reason)
        with self._lock:
            evicted = None
            if len(self._ring) >= self.buffer_size:
                evicted = self._ring.pop(0)
            self._ring.append(trace)
            self._by_id[trace.trace_id] = trace
            if evicted is not None:
                # the id index must not outlive the ring slot (a re-used
                # inbound trace id could otherwise pin the old object)
                if self._by_id.get(evicted.trace_id) is evicted:
                    del self._by_id[evicted.trace_id]
        return reason

    # -- retrieval (the /debug/traces routes) ------------------------------

    def get(self, trace_id: str) -> Optional[Trace]:
        with self._lock:
            return self._by_id.get(trace_id)

    def list(self, limit: int = 100) -> List[Dict[str, object]]:
        with self._lock:
            traces = list(self._ring[-max(1, int(limit)):])
        return [t.summary() for t in reversed(traces)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
