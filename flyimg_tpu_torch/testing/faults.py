"""Deterministic fault injection for the serving pipeline.

The port's copy of ``flyimg_tpu/testing/faults.py``, with the injection
points the port fires. Resilience (retries, breakers, deadlines, load
shedding, batch isolation) cannot be proven with real network or device
flakiness: tests need faults that fire exactly N times, at exactly one
pipeline point, and then stop. The points:

    ``fetch.http``      one HTTP fetch attempt (service/input_source.py);
                        a plan may raise (a transport failure) or return
                        the body bytes (a success)
    ``batcher.execute`` the batch executor about to run a group: a
                        blocking plan wedges the executor; a raising plan
                        goes through the batcher's classify / retry /
                        bisect recovery
    ``batcher.member``  one member being assembled into a device launch
                        (primary and recovery launches), ctx ``key``/
                        ``index``/``image``: a plan raising for one member
                        models a poison input failing the whole launch,
                        which the batcher isolates by bisection
    ``batcher.drain``   one device -> host readback (primary and recovery
                        launches), ctx ``key``/``n``/``batch``: raising
                        models a transient readback failure, retried for
                        the whole batch
    ``batcher.oom``     one device launch about to run (primary and
                        recovery launches), ctx ``key``/``n``/``batch``: a
                        plan raising ``torch.OutOfMemoryError`` takes the
                        out-of-memory (OVERSIZE) recovery: the family's
                        capacity ceiling is halved and the members re-run
                        in smaller launches, never quarantined
    ``mem.rss``         one RSS watchdog sample (runtime/memgovernor.py
                        RssWatchdog.rss_bytes): a plan returning a number
                        overrides the sampled byte count
    ``warmstart.cache`` one read or write of a warm-start manifest
                        (runtime/warmstart.py), ctx ``op``/``name``: a
                        raising plan models the store refusing it
    ``autotune.signal`` one autotuner evaluation (runtime/autotuner.py): a
                        plan returning a dict replaces the signal window
                        and lifts the rate limit

With no injector installed ``fire`` returns ``PASS`` after one module-level
``None`` check. Tests install a ``FaultInjector`` directly
(``install``/``clear``) or through the server's ``fault_injector``
parameter (service/app.py), so an HTTP-level test injects faults into a
whole server without patching its internals. Every plan is a deterministic
script (``fail_n_then_succeed``, a fixed latency, an Event-gated wedge),
never random. Never inject a sticky CUDA error on a card: it poisons the
process's CUDA context for good.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

__all__ = [
    "PASS",
    "FaultInjector",
    "install",
    "clear",
    "fire",
    "fail_n_then_succeed",
    "latency_spike",
    "wedge_until",
    "poison_member",
]

#: sentinel: "no plan fired — run the real code path"
PASS = object()


class FaultInjector:
    """A set of scripted fault plans keyed by injection point.

    A plan is ``callable(**ctx) -> value | PASS`` and may raise. ``value``
    short-circuits the real code path (simulated success); ``PASS`` falls
    through to it; an exception is the injected fault. Plans fire on every
    hit of their point until removed — determinism lives inside the plan
    (e.g. a fail-counter), not in the harness.
    """

    def __init__(self) -> None:
        self._plans: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self.fired: Dict[str, int] = {}

    def plan(self, point: str, fn: Callable) -> "FaultInjector":
        with self._lock:
            self._plans[point] = fn
        return self

    def fire(self, point: str, **ctx):
        with self._lock:
            fn = self._plans.get(point)
            if fn is None:
                return PASS
            self.fired[point] = self.fired.get(point, 0) + 1
        return fn(**ctx)


_active: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Install ``injector`` process-wide (tests: pair with ``clear`` in a
    finally block, or use the ``fault_injector`` app param)."""
    global _active
    _active = injector
    return injector


def clear() -> None:
    global _active
    _active = None


def fire(point: str, **ctx):
    """Called by the pipeline at each injection point. Returns ``PASS``
    (run the real code) or an injected value; raises injected faults."""
    if _active is None:
        return PASS
    return _active.fire(point, **ctx)


# ---------------------------------------------------------------------------
# canned deterministic plans


def fail_n_then_succeed(n: int, exc_factory: Callable[[], BaseException],
                        result=PASS) -> Callable:
    """Raise ``exc_factory()`` for the first ``n`` hits, then return
    ``result`` (default ``PASS`` — fall through to the real path)."""
    remaining = [n]
    lock = threading.Lock()

    def plan(**_ctx):
        with lock:
            if remaining[0] > 0:
                remaining[0] -= 1
                raise exc_factory()
        return result

    return plan


def latency_spike(seconds: float, then=PASS) -> Callable:
    """Sleep ``seconds`` on every hit, then return ``then`` (default:
    fall through; an exception instance/class is raised instead). Models
    a slow upstream/stage — slow-then-alive or slow-then-dead."""

    def plan(**_ctx):
        time.sleep(seconds)
        if isinstance(then, BaseException) or (
            isinstance(then, type) and issubclass(then, BaseException)
        ):
            raise then
        return then

    return plan


def poison_member(match: Callable[..., bool],
                  exc_factory: Callable[[], BaseException]) -> Callable:
    """A ``batcher.member`` plan: raise ``exc_factory()`` whenever
    ``match(**ctx)`` is truthy (ctx carries ``key``/``index``/``image``),
    else fall through — THE deterministic poison pill. The raise happens
    at launch-assembly time, so the whole fused batch fails exactly like
    a real member-caused device error and the batcher must bisect to
    find the offender."""

    def plan(**ctx):
        if match(**ctx):
            raise exc_factory()
        return PASS

    return plan


def wedge_until(event: threading.Event, timeout_s: float = 30.0) -> Callable:
    """Block until the test sets ``event`` (bounded by ``timeout_s`` so an
    aborted test cannot wedge the suite). Installed at ``batcher.execute``
    this freezes the device executor thread — the wedged-executor scenario."""

    def plan(**_ctx):
        event.wait(timeout=timeout_s)
        return PASS

    return plan
