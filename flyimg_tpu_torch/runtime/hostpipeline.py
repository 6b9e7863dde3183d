"""Host pipeline: bounded worker pools for the miss path's host stages
(fetch, decode, encode), with backpressure between them.

The port of ``flyimg_tpu/runtime/hostpipeline.py``. Without it every miss
runs fetch -> decode -> device -> encode inside its own HTTP thread, so N
concurrent misses run N concurrent decodes and encodes: CPU-bound codec
work oversubscribes the host while nothing bounds or counts the queueing.
Each stage gets its own pool of ``workers`` threads:

- the request thread parks on a stage future while the stage's workers run
  the work at a bounded parallelism, so the decode of one request overlaps
  the device work of another whatever the HTTP thread count;
- saturation is explicit: past ``workers + queue_depth`` pending tasks a
  stage sheds through the port's ``AdmissionGate`` (503 + Retry-After)
  instead of queueing without bound;
- each task's queue wait (submit to pickup) is kept in ``wait_s`` counters
  and, with a registry, in ``flyimg_host_pool_queue_wait_seconds{pool=}``;
  a wait of ``FLIGHT_WAIT_MIN_S`` or more is a ``host_stage`` row in the
  flight recorder;
- the submitting request's trace is activated inside the worker, so the
  spans and events of the stage's work land in that request's trace.

Self-healing follows the batch executor's (runtime/batcher.py): a DEAD
worker thread is replaced at the next submit, and a WEDGED one (inside one
task longer than ``wedge_timeout_s``) is abandoned and replaced, its task
failed with a ``TimeoutError`` so its caller unblocks and its admission
slot frees.

With ``host_pipeline_enable`` off the handler runs every stage inline
(``HostPipeline.run`` is a plain call): answers are byte-equal either way.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.metrics import escape_label_value
from flyimg_tpu_torch.runtime.resilience import AdmissionGate

__all__ = ["StagePool", "HostPipeline", "STAGES"]

#: the miss path's host stages, in pipeline order
STAGES = ("fetch", "decode", "encode")


class _Task:
    __slots__ = ("fn", "future", "enqueued_at", "trace")

    def __init__(self, fn: Callable, trace=None) -> None:
        self.fn = fn
        self.future: Future = Future()
        self.enqueued_at = time.monotonic()
        self.trace = trace


class StagePool:
    """One bounded worker pool for one host stage.

    ``submit`` admits through an ``AdmissionGate`` bounded at ``workers +
    queue_depth`` pending tasks and sheds past it with a 503. ``restarts``
    counts workers replaced by self-healing, by reason; ``waits`` and
    ``wait_s`` count the tasks picked up and their summed queue wait."""

    #: only queue waits at least this long get a flight-recorder row
    FLIGHT_WAIT_MIN_S = 0.005

    def __init__(
        self,
        name: str,
        *,
        workers: int = 2,
        queue_depth: int = 16,
        wedge_timeout_s: float = 60.0,
        shed_retry_after_s: float = 1.0,
        metrics=None,
        flight_recorder=None,
    ) -> None:
        self.name = name
        self.workers = max(1, int(workers))
        self.queue_depth = max(1, int(queue_depth))
        self.wedge_timeout_s = max(float(wedge_timeout_s), 0.0)
        self.metrics = metrics
        self.flight_recorder = flight_recorder
        self.admission = AdmissionGate(
            max_pending=self.workers + self.queue_depth,
            retry_after_s=shed_retry_after_s,
            name=f"host {name} pool",
            metrics=metrics,
        )
        self.restarts: Dict[str, int] = {"dead": 0, "wedged": 0}
        self.waits = 0
        self.wait_s = 0.0
        self._queue: "queue.Queue[Optional[_Task]]" = queue.Queue()
        self._lock = threading.Lock()
        self._stop = False
        # worker -> (busy-since, running task), or None when idle. A
        # replaced or retired worker is dropped from the dict; it notices at
        # its next pickup and exits. The running task rides along so that
        # abandoning a wedged worker can fail its future (the caller
        # unblocks and the admission slot frees).
        self._busy: Dict[threading.Thread, Optional[Tuple[float, _Task]]] = {}
        for _ in range(self.workers):
            self._spawn_worker()

    def _spawn_worker(self) -> threading.Thread:
        thread = threading.Thread(
            target=self._run, name=f"flyimg-torch-host-{self.name}", daemon=True
        )
        with self._lock:
            self._busy[thread] = None
        thread.start()
        return thread

    # -- worker loop -------------------------------------------------------

    def _run(self) -> None:
        me = threading.current_thread()
        while True:
            task = self._queue.get()
            superseded = False
            with self._lock:
                stopping = self._stop
                if me not in self._busy:
                    superseded = True
                elif self._stop and task is None:
                    self._busy.pop(me, None)
                    return
                elif task is not None:
                    self._busy[me] = (time.monotonic(), task)
            if superseded:
                # replaced by self-healing or retired by resize(): hand the
                # task to a live worker and exit. A None during shutdown is
                # one of close()'s stop sentinels, meant for a live worker:
                # put it back.
                if task is not None:
                    self._queue.put(task)
                elif stopping:
                    self._queue.put(None)
                return
            if task is None:
                continue
            wait_s = time.monotonic() - task.enqueued_at
            with self._lock:
                self.waits += 1
                self.wait_s += max(wait_s, 0.0)
            self._record_wait(task, wait_s)
            try:
                with tracing.activate(task.trace):
                    result = task.fn()
            except BaseException as exc:
                if not task.future.done():
                    task.future.set_exception(exc)
            else:
                if not task.future.done():
                    task.future.set_result(result)
            finally:
                with self._lock:
                    if me in self._busy:
                        self._busy[me] = None

    def _record_wait(self, task: _Task, wait_s: float) -> None:
        trace_id = task.trace.trace_id if task.trace is not None else None
        if self.metrics is not None:
            self.metrics.histogram(
                "flyimg_host_pool_queue_wait_seconds"
                f'{{pool="{escape_label_value(self.name)}"}}',
                "Host stage-pool queue wait, task submit to worker pickup",
            ).observe(max(wait_s, 0.0), trace_id=trace_id)
        if self.flight_recorder is not None and wait_s >= self.FLIGHT_WAIT_MIN_S:
            # backpressure evidence only: healthy pickups stay out of the
            # ring, which exists for the launches around an incident
            self.flight_recorder.record(
                controller=f"host:{self.name}", batch_id=None, plan_key=None,
                occupancy=1, capacity=1, queue_wait_s=wait_s,
                kind="host_stage", stage=self.name, trace_id=trace_id,
            )

    # -- submission --------------------------------------------------------

    def submit(self, fn: Callable) -> Future:
        """Queue ``fn`` for a worker; returns its Future. Sheds a 503 when
        the stage is saturated; heals dead and wedged workers first."""
        with self._lock:
            if self._stop:
                raise RuntimeError(f"host {self.name} pool is closed")
        self._heal_workers()
        self.admission.acquire()
        task = _Task(fn, tracing.current_trace())
        task.future.add_done_callback(lambda _f: self.admission.release())
        try:
            self._queue.put(task)
        except BaseException:
            if not task.future.done():
                self.admission.release()
            raise
        return task.future

    def _heal_workers(self) -> None:
        """Replace dead workers, abandon and replace wedged ones (inside one
        task longer than ``wedge_timeout_s``). Checked at submit, as the
        batch executor's heal is: no watchdog thread."""
        now = time.monotonic()
        respawn = 0
        wedged_tasks: List[_Task] = []
        with self._lock:
            if self._stop:
                return
            for thread in list(self._busy):
                entry = self._busy[thread]
                reason = None
                if not thread.is_alive():
                    reason = "dead"
                elif (
                    self.wedge_timeout_s > 0
                    and entry is not None
                    and now - entry[0] > self.wedge_timeout_s
                ):
                    reason = "wedged"
                if reason is None:
                    continue
                self._busy.pop(thread, None)
                respawn += 1
                self.restarts[reason] += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "flyimg_host_pool_worker_restarts_total"
                        f'{{pool="{escape_label_value(self.name)}",'
                        f'reason="{reason}"}}',
                        "Host stage-pool workers replaced by self-healing",
                    ).inc()
                tracing.add_event(
                    "host_pool.worker_restart", pool=self.name, reason=reason,
                )
                if reason == "wedged" and entry is not None:
                    wedged_tasks.append(entry[1])
        for task in wedged_tasks:
            # outside the lock (future callbacks run inline): the caller
            # unblocks and the done-callback releases the admission slot
            if not task.future.done():
                task.future.set_exception(TimeoutError(
                    f"host {self.name} pool worker wedged; task abandoned"
                ))
        for _ in range(respawn):
            self._spawn_worker()

    # -- live pool sizing --------------------------------------------------

    def resize(self, workers: int) -> int:
        """Change the worker count. Growth spawns at once; a shrink retires
        workers (idle ones first) by dropping them from the roster, and one
        wake-up sentinel per retiree gets parked ones out. The admission
        bound follows. Returns the applied count."""
        target = max(1, int(workers))
        retire: List[threading.Thread] = []
        spawn = 0
        with self._lock:
            if self._stop:
                return self.workers
            current = len(self._busy)
            if target > current:
                spawn = target - current
            elif target < current:
                ranked = sorted(self._busy, key=lambda t: self._busy[t] is not None)
                for thread in ranked[: current - target]:
                    self._busy.pop(thread, None)
                    retire.append(thread)
            self.workers = target
            self.admission.max_pending = target + self.queue_depth
        for _ in range(spawn):
            self._spawn_worker()
        for _ in retire:
            self._queue.put(None)
        if retire or spawn:
            tracing.add_event("host_pool.resize", pool=self.name, workers=target)
        return target

    # -- introspection -----------------------------------------------------

    @property
    def pending(self) -> int:
        """Admitted and unresolved tasks (queued or running)."""
        return self.admission.pending

    def stats(self) -> Dict[str, float]:
        with self._lock:
            busy = sum(1 for entry in self._busy.values() if entry is not None)
            workers = len(self._busy)
        return {
            "workers": float(workers),
            "busy": float(busy),
            "pending": float(self.pending),
            "bound": float(self.workers + self.queue_depth),
        }

    def close(self, drain_timeout_s: float = 10.0) -> None:
        """Stop taking work and drain: queued tasks complete within the
        budget, then workers exit on their stop sentinel. Tasks that never
        ran get a ``TimeoutError``."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            workers = list(self._busy)
        for _ in workers:
            self._queue.put(None)
        deadline = time.monotonic() + max(drain_timeout_s, 0.0)
        for thread in workers:
            thread.join(timeout=max(deadline - time.monotonic(), 0.0))
        while True:
            try:
                task = self._queue.get_nowait()
            except queue.Empty:
                break
            if task is not None and not task.future.done():
                task.future.set_exception(TimeoutError(
                    f"host {self.name} pool closed before the task ran"
                ))


class HostPipeline:
    """The stage pools (fetch, decode, encode) as one object. ``enabled``
    False holds no pools: every ``run`` is a plain call."""

    def __init__(
        self,
        *,
        enabled: bool = False,
        fetch_workers: int = 4,
        decode_workers: int = 2,
        encode_workers: int = 2,
        queue_depth: int = 16,
        wedge_timeout_s: float = 60.0,
        shed_retry_after_s: float = 1.0,
        metrics=None,
        flight_recorder=None,
    ) -> None:
        self.enabled = bool(enabled)
        self._pools: Dict[str, StagePool] = {}
        if not self.enabled:
            return
        for name, workers in (
            ("fetch", fetch_workers),
            ("decode", decode_workers),
            ("encode", encode_workers),
        ):
            self._pools[name] = StagePool(
                name, workers=workers, queue_depth=queue_depth,
                wedge_timeout_s=wedge_timeout_s,
                shed_retry_after_s=shed_retry_after_s,
                metrics=metrics, flight_recorder=flight_recorder,
            )

    @classmethod
    def from_params(cls, params, *, metrics=None,
                    flight_recorder=None) -> "HostPipeline":
        return cls(
            enabled=bool(params.by_key("host_pipeline_enable", False)),
            fetch_workers=int(params.by_key("host_pipeline_fetch_workers", 4)),
            decode_workers=int(params.by_key("host_pipeline_decode_workers", 2)),
            encode_workers=int(params.by_key("host_pipeline_encode_workers", 2)),
            queue_depth=int(params.by_key("host_pipeline_queue_depth", 16)),
            wedge_timeout_s=float(params.by_key("host_pipeline_wedge_timeout_s", 60.0)),
            shed_retry_after_s=float(params.by_key("shed_retry_after_s", 1.0)),
            metrics=metrics, flight_recorder=flight_recorder,
        )

    def pool(self, stage: str) -> Optional[StagePool]:
        return self._pools.get(stage)

    def pools(self) -> List[Tuple[str, StagePool]]:
        return list(self._pools.items())

    def pressure(self) -> float:
        """The most saturated stage's pending / bound (1.0: a stage is at
        its admission bound)."""
        worst = 0.0
        for pool in self._pools.values():
            bound = pool.workers + pool.queue_depth
            if bound > 0:
                worst = max(worst, pool.pending / bound)
        return worst

    def run(self, stage: str, fn: Callable, *, timeout: Optional[float]):
        """Run ``fn`` on the stage's pool and wait at most ``timeout`` for
        it (a plain call when the pipeline is off or the stage unknown). A
        timeout raises ``concurrent.futures.TimeoutError`` for the caller's
        deadline and wedge handling; the task keeps its worker until it
        ends, and the heal replaces the worker if it never does."""
        pool = self._pools.get(stage)
        if pool is None:
            return fn()
        future = pool.submit(fn)
        tracing.add_event("host_pipeline.staged", stage=stage, pending=pool.pending)
        return future.result(timeout=timeout)

    def apply_policy(self, stage_workers: Dict[str, int]) -> Dict[str, int]:
        """Resize stage pools online; unknown stages are ignored. Returns
        the applied counts."""
        applied: Dict[str, int] = {}
        for stage, workers in stage_workers.items():
            pool = self._pools.get(stage)
            if pool is not None:
                applied[stage] = pool.resize(workers)
        return applied

    def policy(self) -> Dict[str, int]:
        """The stages' worker counts."""
        return {name: pool.workers for name, pool in self._pools.items()}

    def close(self, drain_timeout_s: float = 10.0) -> None:
        for pool in self._pools.values():
            pool.close(drain_timeout_s)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: pool.stats() for name, pool in self._pools.items()}
