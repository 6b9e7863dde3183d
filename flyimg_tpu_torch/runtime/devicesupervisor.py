"""The device supervisor: device-loss detection, CPU failover and
re-promotion.

The port of ``flyimg_tpu/runtime/devicesupervisor.py``. The batcher
retries a TRANSIENT launch failure, but nothing acts on a storm of them: a
lost card keeps every miss paying ``resilience_batch_retries`` backoffs
before it fails. This is the JAX package's opt-in answer:

- **Storm detection.** The batchers' resolution sites feed it: a
  classified TRANSIENT launch failure counts, a launch resolved resets.
  ``device_storm_threshold`` consecutive failures within
  ``device_storm_window_s`` (both) trip the breaker.
- **Failover.** A worker thread holds new launches, drains the ones in
  flight (``device_failover_drain_s``; leftovers are timeout-stamped) and
  rebuilds every attached controller's executor on ``device="cpu"``: the
  transform batcher and the codec batcher, so the kernels' plain versions
  serve (K1-K3, K16-K19 do not launch while it holds). Misses still
  serve, tagged ``X-Flyimg-Degraded: cpu-fallback`` and never cached; hits
  never notice.
- **Re-promotion.** A prober tries the card every
  ``device_probe_interval_s``: an allocation and a synchronize on it,
  bounded by ``backend_probe_timeout_s`` (the ``device.backend`` fault
  point may decide the verdict). ``device_probe_hysteresis`` clean probes
  in a row rebuild the controllers on the card. A failover drops the
  transform batcher's data-parallel mesh; a re-promotion rebuilds it from
  the ``mesh_factory`` given to ``attach`` (asked anew each time, so the
  revived host's cards and not boot's), and a factory that raises leaves
  the batcher serving unsharded, with a warning.

``flyimg_device_health`` (1, 0, 1), ``flyimg_backend_failovers_total{to}``,
``flyimg_backend_probe_total{outcome}``, ``device.failover`` and
``device.repromote`` span events (on the next request), a structured log
line, ``/readyz``'s ``device`` field and ``/debug/device`` show it; the
brownout engine reads a failover as the BROWNOUT threshold.

Off by default (``device_supervisor_enable``): the batchers carry no
supervisor, no metrics register, no thread starts, and nothing on any path
leaves the card.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.resilience import TRANSIENT
from flyimg_tpu_torch.testing import faults

__all__ = ["DeviceSupervisor", "DEVICE", "CPU_FALLBACK", "probe_device"]

SUPERVISOR_LOGGER = "flyimg.device"

#: supervisor states: where the controllers launch right now
DEVICE, CPU_FALLBACK = "device", "cpu-fallback"

_CPU = torch.device("cpu")


def probe_device(device: torch.device, timeout_s: float) -> Tuple[bool, str]:
    """Is the card back: an allocation, a kernel and a synchronize on it,
    within ``timeout_s`` (on a thread of its own: a hung card must not
    hang the prober). ``(ok, detail)``, detail ``"up"``, ``"down"`` (no
    answer in time), ``"injected"`` (a ``device.backend`` fault plan's
    verdict) or ``"error:<type>"``. Never raises."""
    try:
        injected = faults.fire("device.backend")
        if injected is not faults.PASS and injected is not None:
            return bool(injected), "injected"
        verdict: Dict[str, object] = {}

        def run() -> None:
            try:
                x = torch.ones(256, device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                verdict["ok"] = float((x + 1).sum().item()) == 512.0
            except Exception as exc:    # the contract is catch-all
                verdict["error"] = type(exc).__name__

        thread = threading.Thread(target=run, name="flyimg-torch-device-probe", daemon=True)
        thread.start()
        thread.join(max(float(timeout_s), 0.0))
        if "error" in verdict:
            return False, f"error:{verdict['error']}"
        if thread.is_alive() or not verdict.get("ok"):
            return False, "down"
        return True, "up"
    except Exception as exc:
        return False, f"error:{type(exc).__name__}"


class DeviceSupervisor:
    """The storm breaker and the failover / re-promotion state machine."""

    def __init__(
        self,
        *,
        enabled: bool = False,
        storm_threshold: int = 5,
        storm_window_s: float = 30.0,
        probe_interval_s: float = 5.0,
        probe_timeout_s: float = 75.0,
        probe_hysteresis: int = 2,
        failover_drain_s: float = 10.0,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.enabled = bool(enabled)
        self.storm_threshold = max(1, int(storm_threshold))
        self.storm_window_s = max(float(storm_window_s), 0.001)
        self.probe_interval_s = max(float(probe_interval_s), 0.05)
        self.probe_timeout_s = float(probe_timeout_s)
        self.probe_hysteresis = max(1, int(probe_hysteresis))
        self.failover_drain_s = max(float(failover_drain_s), 0.0)
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._state = DEVICE
        self._state_since = clock()
        # consecutive TRANSIENT failures (a success resets) and their times
        # (the threshold must fall inside the window)
        self._consecutive = 0
        self._window: Deque[float] = collections.deque()
        self._failing_over = False
        self._repromoting = False
        self._clean_probes = 0
        self._last_probe_at: Optional[float] = None
        self._last_probe_outcome: Optional[str] = None
        self._probes_total = 0
        self._failovers = 0
        self._repromotions = 0
        # flap damping: a failover within flap_window_s of a re-promotion
        # doubles the clean probes the next one needs (at most 8x)
        self.flap_window_s = self.storm_window_s * 10.0
        self._hysteresis_mult = 1
        self._last_repromote_at: Optional[float] = None
        # span events of the worker and prober threads (no trace there),
        # drained onto the next request's trace
        self._pending_events: List[Dict[str, object]] = []
        self._batchers: Tuple = ()
        self._device: Optional[torch.device] = None
        self._mesh_factory: Optional[Callable[[], object]] = None
        self._prober: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._closed = False

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "DeviceSupervisor":
        clock = params.by_key("device_supervisor_clock") or time.monotonic
        return cls(
            enabled=bool(params.by_key("device_supervisor_enable", False)),
            storm_threshold=int(params.by_key("device_storm_threshold", 5)),
            storm_window_s=float(params.by_key("device_storm_window_s", 30.0)),
            probe_interval_s=float(params.by_key("device_probe_interval_s", 5.0)),
            probe_timeout_s=float(params.by_key("backend_probe_timeout_s", 75.0)),
            probe_hysteresis=int(params.by_key("device_probe_hysteresis", 2)),
            failover_drain_s=float(params.by_key("device_failover_drain_s", 10.0)),
            metrics=metrics,
            clock=clock,
        )

    # -- wiring ------------------------------------------------------------

    def attach(self, *, batchers: Sequence = (), device=None,
               mesh_factory: Optional[Callable[[], object]] = None) -> None:
        """The controllers it feeds on and fails over (the transform
        batcher first), the card they serve on (by default the first
        controller's), and the factory of the transform batcher's
        data-parallel mesh that a re-promotion rebuilds it from (None:
        unsharded)."""
        self._batchers = tuple(batchers)
        self._mesh_factory = mesh_factory
        if device is None and self._batchers:
            device = self._batchers[0].device
        self._device = torch.device(device) if device is not None else None

    def register_metrics(self, registry) -> None:
        registry.gauge(
            "flyimg_device_health",
            "Device backend health: 1 serving on the device backend, "
            "0 failed over to forced-CPU rendering",
            fn=lambda: 1.0 if self._state == DEVICE else 0.0,
        )

    # -- reads ---------------------------------------------------------------

    def cpu_forced(self) -> bool:
        """True while misses render on the CPU: the handler's tag and the
        brownout ``device_health`` signal."""
        return self.enabled and self._state == CPU_FALLBACK

    def state(self) -> str:
        return self._state

    def snapshot(self) -> Dict[str, object]:
        """The /debug/device document."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "state": self._state,
                "state_age_s": round(self._clock() - self._state_since, 3),
                "storm": {
                    "threshold": self.storm_threshold,
                    "window_s": self.storm_window_s,
                    "consecutive_transient_failures": self._consecutive,
                    "window_failures": len(self._window),
                },
                "probe": {
                    "interval_s": self.probe_interval_s,
                    "timeout_s": self.probe_timeout_s,
                    "hysteresis": self.probe_hysteresis,
                    "hysteresis_mult": self._hysteresis_mult,
                    "clean_probes": self._clean_probes,
                    "last_outcome": self._last_probe_outcome,
                    "total": self._probes_total,
                },
                "failovers": self._failovers,
                "repromotions": self._repromotions,
            }

    # -- the batchers' feed --------------------------------------------------

    def record_batch_success(self) -> None:
        """A launch resolved: the card answered, any storm resets."""
        if not self.enabled:
            return
        with self._lock:
            self._consecutive = 0
            self._window.clear()

    def record_batch_failure(self, kind: str) -> None:
        """A failed launch, classified by the batcher. Only TRANSIENT
        counts: poison belongs to an input, oversize to a footprint."""
        if not self.enabled or kind != TRANSIENT:
            return
        trip = False
        with self._lock:
            now = self._clock()
            self._consecutive += 1
            self._window.append(now)
            floor = now - self.storm_window_s
            while self._window and self._window[0] < floor:
                self._window.popleft()
            if (self._state == DEVICE and not self._failing_over
                    and self._consecutive >= self.storm_threshold
                    and len(self._window) >= self.storm_threshold):
                self._failing_over = True
                trip = True
        if trip:
            self._trip()

    # -- failover ------------------------------------------------------------

    def _trip(self) -> None:
        """The state flips now (new misses tag at once); the drain and the
        rebuild run on a worker thread, never on the batcher's drain thread
        that reported the last failure."""
        with self._lock:
            now = self._clock()
            self._state = CPU_FALLBACK
            self._state_since = now
            self._failovers += 1
            if (self._last_repromote_at is not None
                    and now - self._last_repromote_at < self.flap_window_s):
                self._hysteresis_mult = min(self._hysteresis_mult * 2, 8)
            else:
                self._hysteresis_mult = 1
            self._pending_events.append({"name": "device.failover", "to": "cpu",
                                         "consecutive_failures": self._consecutive})
        self._record_failover("cpu")
        logging.getLogger(SUPERVISOR_LOGGER).error(
            "device backend failure storm: failing over to CPU rendering",
            extra={"event": "device.failover", "to": "cpu",
                   "consecutive_failures": self._consecutive,
                   "storm_threshold": self.storm_threshold},
        )
        self._spawn(self._failover_worker, name="flyimg-torch-device-failover")

    def _spawn(self, target, name: str = "flyimg-torch-device-supervisor") -> None:
        """``target`` on a daemon thread (tests run it inline)."""
        threading.Thread(target=target, name=name, daemon=True).start()

    def _rebuild(self, device: torch.device, reason: str, mesh=None) -> None:
        """Hold launches on every controller, drain them, rebuild each on
        ``device`` (the transform batcher, the first, with ``mesh``);
        launches resume however it ends."""
        for batcher in self._batchers:
            batcher.pause_launches()
        try:
            for batcher in self._batchers:
                batcher.drain_inflight(self.failover_drain_s)
            for i, batcher in enumerate(self._batchers):
                batcher.failover_backend(device, mesh=mesh if i == 0 else None,
                                         drain_timeout_s=self.failover_drain_s,
                                         reason=reason)
        finally:
            for batcher in self._batchers:
                batcher.resume_launches()

    def _failover_worker(self) -> None:
        try:
            self._rebuild(_CPU, "device_failover")
        except Exception:
            logging.getLogger(SUPERVISOR_LOGGER).exception(
                "device failover rebuild failed; CPU fallback state stands")
        finally:
            with self._lock:
                self._failing_over = False
                self._clean_probes = 0
                self._last_probe_at = None
            self._ensure_prober()

    # -- probing and re-promotion ------------------------------------------------

    def _ensure_prober(self) -> None:
        """Start the prober unless one runs; it exits once the state is
        DEVICE again."""
        with self._lock:
            if self._closed or (self._prober is not None and self._prober.is_alive()):
                return
            thread = threading.Thread(target=self._probe_loop,
                                      name="flyimg-torch-device-prober", daemon=True)
            self._prober = thread
        thread.start()

    def _probe_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.probe_interval_s)
            self._wake.clear()
            if self._closed:
                return
            with self._lock:
                if self._state != CPU_FALLBACK or self._repromoting or self._failing_over:
                    if self._state == DEVICE:
                        return
                    continue
            self.probe_and_handle()

    def probe_and_handle(self) -> bool:
        """One probe and its hysteresis (the prober's body; tests call it
        directly). Never raises."""
        device = self._device if self._device is not None else torch.device("cuda")
        ok, detail = probe_device(device, self.probe_timeout_s)
        outcome = "ok" if ok else ("error" if detail.startswith("error:") else "dead")
        self._record_probe(outcome)
        repromote = False
        with self._lock:
            self._probes_total += 1
            self._last_probe_at = self._clock()
            self._last_probe_outcome = f"{outcome}:{detail}"
            if self._state != CPU_FALLBACK or self._repromoting or self._failing_over:
                return ok
            if ok:
                self._clean_probes += 1
                if self._clean_probes >= self.probe_hysteresis * self._hysteresis_mult:
                    self._repromoting = True
                    repromote = True
            else:
                self._clean_probes = 0
        if repromote:
            self._repromote()
        return ok

    def _repromote(self) -> None:
        """Rebuild every controller on the card, then flip the state."""
        log = logging.getLogger(SUPERVISOR_LOGGER)
        try:
            mesh = None
            if self._mesh_factory is not None:
                try:
                    mesh = self._mesh_factory()
                except Exception:
                    log.warning("mesh rebuild failed at re-promotion; serving unsharded",
                                exc_info=True)
            self._rebuild(self._device if self._device is not None else torch.device("cuda"),
                          "device_repromote", mesh)
            with self._lock:
                self._state = DEVICE
                self._state_since = self._clock()
                self._consecutive = 0
                self._window.clear()
                self._clean_probes = 0
                self._repromotions += 1
                self._last_repromote_at = self._clock()
                self._pending_events.append({"name": "device.repromote", "to": "device"})
            self._record_failover("device")
            log.warning("device backend revived: re-promoted from CPU fallback",
                        extra={"event": "device.repromote", "to": "device"})
        except Exception:
            log.exception("re-promotion failed; staying on CPU fallback")
        finally:
            with self._lock:
                self._repromoting = False

    # -- observability --------------------------------------------------------

    def evaluate(self) -> None:
        """Drain the queued span events onto this request's trace (one list
        check when idle, nothing when off)."""
        if not self.enabled or not self._pending_events:
            return
        with self._lock:
            pending, self._pending_events = self._pending_events, []
        for event in pending:
            name = str(event.pop("name"))
            tracing.add_event(name, **event)

    def _record_failover(self, to: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_backend_failovers_total{{to="{to}"}}',
            "Backend failovers by destination (cpu = storm tripped the "
            "breaker, device = re-promotion)",
        ).inc()

    def _record_probe(self, outcome: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_backend_probe_total{{outcome="{outcome}"}}',
            "Device-backend re-probe attempts by outcome",
        ).inc()

    def close(self) -> None:
        """Stop the prober (at shutdown)."""
        self._closed = True
        self._wake.set()
