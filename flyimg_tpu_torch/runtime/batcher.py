"""BatchController: dynamic batching of concurrent transform requests.

The port of ``flyimg_tpu/runtime/batcher.py``, reduced to what the main
path needs. Requests are grouped by device-program identity — the key the
program cache uses: (input bucket shape, static resample output, pad
config, ``plan.device_plan()``, dynamic rotate, band widths) — so a group
runs as ONE batched program:

    uint8 [B, Hb, Wb, 3] + per-image spans/true sizes -> uint8 [B, Ho, Wo, 3]

A group flushes when it reaches ``max_batch`` members or its oldest member
has waited ``deadline_ms``, or at once when it is the only pending request
(the device is idle, so holding it buys no batching). Launch sizes ride a
power-of-two ladder capped at ``MAX_BATCH_BUCKET`` (pad slots repeat the
last member). Auxiliary groups (``submit_aux``, the smart-crop scoring
pass) batch the same way and run ``runner(payloads)``.

One executor thread assembles and dispatches; readbacks are pipelined.
On CUDA each launch stages its inputs in pinned host buffers, copies them
to the card on the controller's own stream, runs the program there,
enqueues the copy back into a pinned buffer and records an event; the
executor then hands the launch to a daemon drain thread and goes on to the
next group. The drain thread waits on the event, accounts the launch and
resolves the futures. At most ``pipeline_depth`` launches (default 2, the
``batch_pipeline_depth`` parameter) are in flight, from their assembly to
their completed readback: each takes a slot of a semaphore before it
assembles, and its drain gives it back to that same semaphore instance. At
depth 1 a launch assembles only after the last one has read back; at depth
2 it assembles while the last one runs. Aux groups run on the executor
thread, synchronously.

Self-healing (the JAX package's): a dead executor thread is replaced at the
next submission, and a wedged one (in one batch longer than
``executor_wedge_timeout_s`` without progress; the clock pauses while a
launch waits for a pipeline slot or builds its kernels) too, with a fresh
pipeline semaphore. The replacement takes over the queued groups; the old
thread exits when it comes back. ``restarts`` counts both.

Every completed transform launch is accounted in the cost ledger
(``runtime/costledger.py``) under its program key, device and padded
batch (one process may run a program on the card and on the CPU): the
first launch of a key as its build, with the allocator's measured peak,
and each launch's seconds from dispatch to completed readback. The memory
governor learns its per-member bytes from that peak on the drain side.

Failure containment (the JAX package's): sharing a batch must not mean
sharing its failures. A failed launch is classified
(``runtime/resilience.py classify_batch_error``):

- TRANSIENT (host IO) gets a bounded whole-batch retry with full-jitter
  backoff (``batch_retries``);
- POISON (a member's input) re-runs by recursive bisection down to single
  members (``bisect_enable``), so the innocent members succeed and only
  the poison one fails; its fingerprint (plan key + image digest) enters a
  TTL'd quarantine (``quarantine_ttl_s``), and a quarantined submission
  runs alone;
- OVERSIZE (``torch.OutOfMemoryError``: the launch's footprint, no
  member's fault) halves the plan family's capacity ceiling in the memory
  governor and re-runs the members in halves (also under
  ``bisect_enable``); a single member that still does not fit fails with a
  503 + Retry-After, never quarantined;
- FATAL (a sticky CUDA error: the process's CUDA context is lost and every
  later launch fails) fails the group at once, saying why: a retry or a
  bisection would only multiply failures.

With ``batch_retries`` 0, ``bisect_enable`` off, no quarantine, no
governor and no queue bound, a failed launch fails every member with its
error, as before containment. A failure seen by a drain thread (the
readback) is recovered on that thread. ``max_queue_depth`` bounds pending
submissions (503 + Retry-After past it); a ``governor``
(``runtime/memgovernor.py``) caps how many members a launch takes.
``close`` resolves every in-flight readback within its drain budget and
stamps what is left with a ``TimeoutError``.
"""

from __future__ import annotations

import gc
import hashlib
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field, replace
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    ServiceUnavailableException,
)
from flyimg_tpu_torch.ops.compose import (
    _bucket_dim,
    bucket_batch,
    check_ported,
    final_extent,
    geometry_rows,
    make_program_fn,
    plan_layout,
    program_args,
)
from flyimg_tpu_torch.ops.resample import kernel_mode, select_band_taps
from flyimg_tpu_torch.runtime import costledger
from flyimg_tpu_torch.runtime.resilience import (
    FATAL,
    OVERSIZE,
    POISON,
    TRANSIENT,
    AdmissionGate,
    QuarantineTable,
    RetryPolicy,
    classify_batch_error,
)
from flyimg_tpu_torch.spec.plan import TransformPlan
from flyimg_tpu_torch.testing import faults

MAX_BATCH_BUCKET = 64


def _round_batch(n: int) -> int:
    """The shared power-of-two occupancy ladder, capped."""
    return min(bucket_batch(n), MAX_BATCH_BUCKET)


def containment_params(params) -> dict:
    """The containment and pipelining keyword arguments of
    ``BatchController`` from the server parameters (the JAX package's
    ``resilience_*``, ``batch_max_queue_depth`` and
    ``batch_pipeline_depth`` keys)."""
    return dict(
        batch_retries=int(params.by_key("resilience_batch_retries", 2)),
        bisect_enable=bool(params.by_key("resilience_bisect_enable", True)),
        quarantine_ttl_s=float(params.by_key("resilience_quarantine_ttl", 300.0)),
        max_queue_depth=int(params.by_key("batch_max_queue_depth", 0)),
        shed_retry_after_s=float(params.by_key("shed_retry_after_s", 1.0)),
        executor_wedge_timeout_s=float(
            params.by_key("resilience_executor_wedge_timeout_s", 60.0)),
        pipeline_depth=int(params.by_key("batch_pipeline_depth", 2)),
    )


def _forget_frames(exc: BaseException, device: torch.device) -> None:
    """Free what an out-of-memory launch held before launching again: its
    frames, and the device tensors in them, live as long as the tracebacks
    of its error and of the errors that error chains, so drop them all and
    collect the reference cycles frames can form; then give the caching
    allocator's free segments back (a half-used segment of the failed
    launch's size cannot be released, and the smaller launch would run out
    of memory beside it)."""
    stack = [exc]
    seen = set()
    while stack:
        err = stack.pop()
        if err is None or id(err) in seen:
            continue
        seen.add(id(err))
        err.__traceback__ = None
        stack += [err.__cause__, err.__context__]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _image_digest(image) -> str:
    """The quarantine fingerprint's half for one member's pixels (computed
    only on the poison paths and for submissions whose plan key is in
    quarantine)."""
    return hashlib.blake2b(
        np.ascontiguousarray(image).tobytes(), digest_size=12
    ).hexdigest()


@dataclass(eq=False)
class _Pending:
    payload: object                 # [h, w, 3] uint8 image, or aux payload
    plan: Optional[TransformPlan]
    future: Future
    enqueued_at: float
    final_true: Tuple[int, int] = (0, 0)
    needs_slice: bool = False
    src_window: Optional[Tuple[int, int]] = None
    fp_digest: Optional[str] = None     # the image digest, once computed


@dataclass
class _Group:
    key: Tuple
    in_shape: Tuple[int, int] = (0, 0)
    resample_out: Optional[Tuple[int, int]] = None
    pad_canvas: Optional[Tuple[int, int]] = None
    pad_offset: Tuple[int, int] = (0, 0)
    device_plan: Optional[TransformPlan] = None
    rotate_dynamic: bool = False
    band_taps: Optional[Tuple[int, int]] = None
    runner: Optional[Callable] = None
    members: List[_Pending] = field(default_factory=list)
    # the program identity without a quarantine suffix: a quarantined
    # submission runs in a group of its own, and its fingerprint must stay
    # under the key later submissions look up
    base_key: Optional[Tuple] = None


@dataclass(eq=False)
class _Launch:
    """One dispatched transform launch until its readback: the host output
    (CPU), or the pinned buffer and the event after the copy back into it
    (CUDA), with the tensors that must live until then."""

    t_dispatch: float
    host: Optional[np.ndarray] = None
    pinned: Optional[torch.Tensor] = None
    event: Optional[object] = None
    peak: Optional[float] = None
    keep: Tuple = ()


def program_descriptor(group: _Group, batch: int,
                       device: torch.device) -> Dict[str, object]:
    """A readable identity of a group's program for the cost ledger: the
    stages, shapes, resample form and device."""
    plan = group.device_plan
    ops = ["resample"] if group.resample_out is not None else []
    if group.pad_canvas is not None:
        ops.append("extent_pad")
    for name in ("colorspace", "monochrome", "rotate", "unsharp", "sharpen", "blur"):
        if getattr(plan, name) not in (None, False):
            ops.append(name)
    desc: Dict[str, object] = {"ops": ops or ["copy"], "batch": int(batch),
                               "in_shape": list(group.in_shape), "device": str(device)}
    if group.resample_out is not None:
        desc["resample_out"] = list(group.resample_out)
        desc["kernel"] = "banded" if group.band_taps is not None else "dense"
    return desc


def transform_group(
    plan: TransformPlan,
    image_hw: Tuple[int, int],
    src_window: Optional[Tuple[int, int]] = None,
) -> Tuple[_Group, Tuple[int, int], bool]:
    """The JAX package's grouping policy for one member: ``(group with no
    members, final valid (h, w), whether the member's output is sliced to
    it)``. The group's ``key`` is the program identity.

    An arbitrary-angle rotate runs shape-bucketed with per-member geometry
    (``rotate_dynamic``) UNLESS an extent pad fixed the frame to a static
    canvas first, or a filter follows the rotate: on a bucketed frame the
    filter would blur the background fill across the valid-region edge,
    where the exact frame edge-replicates. Such a static rotate keeps the
    exact output (after a resample) or the exact frame (without one)."""
    h, w = int(image_hw[0]), int(image_hw[1])
    needs_resample = (
        plan.resize_to is not None
        or plan.extent is not None
        or plan.extract is not None
    )
    if src_window is not None:
        wx, wy = int(src_window[0]), int(src_window[1])
        if (
            wx < 0 or wy < 0
            or wx + w > plan.src_size[0] or wy + h > plan.src_size[1]
        ):
            raise ValueError(
                f"src_window {(wx, wy)} + image {(w, h)} exceeds "
                f"plan src {plan.src_size}"
            )
        if not needs_resample:
            raise ValueError("src_window requires a resample/extract plan")
    elif plan.src_size != (w, h):
        raise ValueError("plan src_size does not match image dims")
    check_ported(plan)
    layout = plan_layout(plan)
    rotate_dynamic = (
        plan.rotate is not None
        and layout.pad_canvas is None
        and plan.blur is None
        and plan.sharpen is None
        and plan.unsharp is None
    )
    final_true = final_extent(plan, layout)
    needs_slice = False
    band_taps = None
    if needs_resample:
        in_shape = (_bucket_dim(h), _bucket_dim(w))
        if plan.extent is not None or (
            plan.rotate is not None and not rotate_dynamic
        ):
            # crop/extent path: every member lands on the same extent; a
            # static rotate keeps the exact per-aspect output
            resample_out = layout.resample_out
        else:
            # fit path: output height varies with source aspect; bucket
            # the static output and slice each member's valid region (the
            # padding rows are edge-clamped samples, so a filter sees edge
            # padding; a dynamic rotate samples only the valid region)
            resample_out = (
                _bucket_dim(layout.resample_out[0], 64),
                _bucket_dim(layout.resample_out[1], 64),
            )
            needs_slice = rotate_dynamic or resample_out != layout.resample_out
        band_taps = select_band_taps(
            kernel_mode(), plan.filter_method, in_shape,
            layout.span_y, layout.span_x, layout.out_true,
        )
    elif plan.rotate is None or rotate_dynamic:
        # pixel-op-only and dynamic-rotate plans ride input buckets too
        # (edge-replicate fill in _execute keeps the filters right; a
        # dynamic rotate never samples padding)
        in_shape = (_bucket_dim(h), _bucket_dim(w))
        resample_out = None
        needs_slice = rotate_dynamic or in_shape != (h, w)
    else:
        # static rotate (filters follow) without resample: the exact frame
        in_shape = (h, w)
        resample_out = None
    device_plan = plan.device_plan()
    key = (
        in_shape, resample_out, layout.pad_canvas, layout.pad_offset,
        device_plan, rotate_dynamic, band_taps,
    )
    group = _Group(
        key=key, in_shape=in_shape, resample_out=resample_out,
        pad_canvas=layout.pad_canvas, pad_offset=layout.pad_offset,
        device_plan=device_plan, rotate_dynamic=rotate_dynamic,
        band_taps=band_taps,
    )
    return group, final_true, needs_slice


def assemble_batch(group: _Group, members: List[Tuple[np.ndarray, TransformPlan,
                                                       Optional[Tuple[int, int]]]],
                   batch: int, pin: bool = False):
    """Host tensors of one launch: u8 images [batch, Hb, Wb, 3] and f32
    geometry rows [batch, 8 | 10] for ``members`` (image, plan, src_window);
    pixel-op-only buckets are edge-replicate padded, pad slots repeat the
    last member."""
    n = len(members)
    bh, bw = group.in_shape
    images = torch.zeros((batch, bh, bw, 3), dtype=torch.uint8, pin_memory=pin)
    geo = torch.zeros((batch, 10 if group.rotate_dynamic else 8),
                      dtype=torch.float32, pin_memory=pin)
    img_np, geo_np = images.numpy(), geo.numpy()
    for i, (image, plan, src_window) in enumerate(members):
        h, w = image.shape[:2]
        if group.resample_out is None and (h, w) != (bh, bw):
            # pixel-op-only bucket: edge-replicate padding
            img_np[i] = np.pad(
                image, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge"
            )
        else:
            img_np[i, :h, :w] = image
        layout = plan_layout(plan)
        rot_hw = final_extent(plan, layout) if group.rotate_dynamic else None
        geo_np[i] = geometry_rows(plan, layout, (h, w), src_window, rot_hw)
    img_np[n:] = img_np[n - 1]
    geo_np[n:] = geo_np[n - 1]
    return images, geo


class BatchController:
    """Thread-safe dynamic batcher in front of one device."""

    def __init__(
        self,
        *,
        max_batch: int = 64,
        deadline_ms: float = 4.0,
        device: Union[str, torch.device] = "cuda",
        lone_flush: bool = True,
        pipeline_depth: int = 2,
        max_queue_depth: int = 0,
        shed_retry_after_s: float = 1.0,
        batch_retries: int = 2,
        bisect_enable: bool = True,
        quarantine_ttl_s: float = 0.0,
        executor_wedge_timeout_s: float = 0.0,
        governor=None,
    ) -> None:
        self.device = resolve_device(device)
        self.max_batch = max(1, min(int(max_batch), MAX_BATCH_BUCKET))
        self.deadline_s = float(deadline_ms) / 1000.0
        self.lone_flush = lone_flush
        self._stream = (
            torch.cuda.Stream(self.device)
            if self.device.type == "cuda" else None
        )
        #: (kind, members, padded batch) of recent launches, newest last
        #: (recovery launches included)
        self.launch_log: Deque[Tuple[str, int, int]] = deque(maxlen=4096)
        #: pending = submitted and not yet resolved (queued or running);
        #: past ``max_queue_depth`` a submission sheds with a 503
        self.admission = AdmissionGate(
            max_pending=int(max_queue_depth),
            retry_after_s=shed_retry_after_s, name="batch queue",
        )
        self.batch_retries = max(0, int(batch_retries))
        self.bisect_enable = bool(bisect_enable)
        self.quarantine = (
            QuarantineTable(quarantine_ttl_s)
            if quarantine_ttl_s and quarantine_ttl_s > 0 else None
        )
        # the backoff of batch retries (full jitter); tests stub .sleep
        self._retry_policy = RetryPolicy(max_attempts=self.batch_retries + 1)
        #: the memory governor (runtime/memgovernor.py), or None
        self.governor = governor
        self._ledger = costledger.get_ledger()
        #: containment counters: batch retries, poison members isolated,
        #: submissions that hit quarantine
        self.stats = {"retries": 0, "poison_isolated": 0, "quarantine_hits": 0}
        #: executors replaced by self-healing, by reason
        self.restarts = {"dead": 0, "wedged": 0}
        #: the most launches that were ever in flight (from a pipeline slot
        #: taken to the readback done) at once
        self.inflight_peak = 0
        # self-healing: a dead executor is always replaced at the next
        # submission, a wedged one (in one batch longer than this without
        # progress) when the bound is > 0
        self.executor_wedge_timeout_s = float(executor_wedge_timeout_s)
        self._busy_since: Optional[float] = None
        self._busy_owner: Optional[threading.Thread] = None
        # the in-flight window: at most pipeline_depth launches between
        # their assembly and their completed readback. Each
        # readback runs on a daemon drain thread of its own, as in the JAX
        # package: a hung read must block neither close() nor exit.
        self._pipeline_depth = max(1, int(pipeline_depth))
        self._inflight = threading.Semaphore(self._pipeline_depth)
        self._inflight_batches: List[List[_Pending]] = []
        self._launches_inflight = 0
        # True between installing a replacement executor and its first turn
        # in _run (an installed, unstarted thread is not alive: without this
        # a concurrent submitter would heal again)
        self._executor_pending = False
        self._quarantine_seq = itertools.count()
        self._groups: Dict[Tuple, _Group] = {}
        self._lock = threading.Condition()
        self._stop = False
        self._spawn_executor().start()

    def _spawn_executor(self) -> threading.Thread:
        """Install (or, healing, replace) THE executor thread and return it
        unstarted: callers start it outside the lock. ``self._thread`` is
        the baton: a replaced thread sees ``self._thread is not me`` and
        exits."""
        self._thread = threading.Thread(
            target=self._run, name="flyimg-torch-batcher", daemon=True
        )
        self._executor_pending = True
        return self._thread

    # ------------------------------------------------------------------

    def submit(
        self,
        image: np.ndarray,
        plan: TransformPlan,
        src_window: Optional[Tuple[int, int]] = None,
    ) -> Future:
        """Queue one image+plan; resolves to the uint8 output array.
        ``src_window``: the image is the window of the plan's source at this
        (x, y) offset, threaded to the program as a span shift. Work whose
        fingerprint is in quarantine runs in a group of its own."""
        template, final_true, needs_slice = transform_group(
            plan, image.shape[:2], src_window
        )
        base_key = template.key
        pending = _Pending(
            payload=image, plan=plan, future=Future(),
            enqueued_at=time.monotonic(), final_true=final_true,
            needs_slice=needs_slice, src_window=src_window,
        )
        key = base_key
        if self.quarantine is not None and self.quarantine.has_prefix(base_key):
            pending.fp_digest = _image_digest(image)
            if self.quarantine.hit((base_key, pending.fp_digest)):
                self._count("quarantine_hits")
                key = base_key + (("__quarantine__", next(self._quarantine_seq)),)
        template.key, template.base_key = key, base_key
        self._enqueue(key, pending, lambda: template)
        return pending.future

    def submit_aux(self, key: Tuple, payload, runner: Callable) -> Future:
        """Queue one item for a batched auxiliary program: concurrent
        submissions sharing ``(runner, key)`` run as ONE
        ``runner(payloads)`` call on the executor thread. ``runner`` must be
        a stable callable (it is part of the group key) returning one
        result per payload, in order."""
        pending = _Pending(
            payload=payload, plan=None, future=Future(),
            enqueued_at=time.monotonic(),
        )
        full_key = ("aux", runner, key)
        self._enqueue(full_key, pending, lambda: _Group(
            key=full_key, runner=runner, base_key=full_key,
        ))
        return pending.future

    def _enqueue(self, key, pending: _Pending, make_group) -> None:
        """Admission first (past the bound this raises the 503 in the
        submitter's thread; the slot frees when the future resolves, however
        it resolves), then the heal check, then the group's get-or-create
        and append. A replacement executor starts outside the lock (a thread
        start blocks, and under the lock it would hold every submitter)."""
        self.admission.acquire()
        pending.future.add_done_callback(lambda _f: self.admission.release())
        replacement = None
        try:
            with self._lock:
                if self._stop:
                    raise RuntimeError("batcher is closed")
                replacement = self._maybe_heal_executor_locked()
                group = self._groups.get(key)
                if group is None:
                    group = self._groups[key] = make_group()
                group.members.append(pending)
                self._lock.notify()
        except BaseException:
            if not pending.future.done():
                self.admission.release()
            raise
        finally:
            # in a finally, so an enqueue failure never strands an
            # installed, unstarted executor
            if replacement is not None:
                try:
                    replacement.start()
                except BaseException:
                    with self._lock:
                        self._executor_pending = False
                    raise

    def _maybe_heal_executor_locked(self) -> Optional[threading.Thread]:
        """Executor self-healing, checked at every submission (the lock
        held): a DEAD executor is always replaced; a WEDGED one (in one
        batch longer than ``executor_wedge_timeout_s`` without progress)
        when that bound is set. The replacement takes over every queued
        group (``self._groups`` is shared, not the thread's); the replaced
        thread, if it ever comes back, sees ``self._thread is not me`` and
        exits, its futures resolving as usual. Returns the replacement,
        unstarted, or None."""
        if self._stop or self._executor_pending:
            return None
        reason = None
        if not self._thread.is_alive():
            reason = "dead"
        elif (
            self.executor_wedge_timeout_s > 0
            and self._busy_since is not None
            and time.monotonic() - self._busy_since > self.executor_wedge_timeout_s
        ):
            reason = "wedged"
        if reason is None:
            return None
        self.restarts[reason] += 1
        if reason == "wedged":
            # a thread wedged after taking a pipeline slot never gives it
            # back: leave the old semaphore to it, so the replacement has
            # the whole depth (every release goes to the instance its
            # launch took, so a late one lands on the old object)
            self._inflight = threading.Semaphore(self._pipeline_depth)
        self._busy_since = None
        self._busy_owner = None
        return self._spawn_executor()

    def _touch_busy(self) -> None:
        """Progress: restart the wedge clock. It bounds time without
        progress, not a whole batch (a long recovery is healthy). Only the
        clock's owner touches it: recovery launches on drain threads must
        not hide a wedged executor."""
        me = threading.current_thread()
        with self._lock:
            if self._busy_owner is me:
                self._busy_since = time.monotonic()

    def _suspend_busy(self) -> None:
        """Pause the wedge clock: across a wait for a pipeline slot (that is
        backpressure, not a wedge) and a program's first launch (its
        kernels may build there, for seconds). The next touch re-arms it."""
        me = threading.current_thread()
        with self._lock:
            if self._busy_owner is me:
                self._busy_since = None

    def _clear_busy(self, me: threading.Thread) -> None:
        with self._lock:
            if self._busy_owner is me:
                self._busy_since = None
                self._busy_owner = None

    def close(self, drain_timeout_s: float = 30.0) -> None:
        """Stop taking work, run what is queued, join the executor (a wedged
        one is not waited for past 5 s), then resolve every in-flight
        readback within ``drain_timeout_s``: what is left then gets a
        ``TimeoutError``."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        try:
            self._thread.join(timeout=min(5.0, max(drain_timeout_s, 0.1)))
        except RuntimeError:
            pass    # a replacement installed but not started: nothing to join
        # every in-flight batch (dispatching, wedged or reading back)
        deadline = time.monotonic() + max(float(drain_timeout_s), 0.0)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight_batches:
                    return
            time.sleep(0.05)
        with self._lock:
            leftovers = [m for batch in self._inflight_batches for m in batch]
            self._inflight_batches = []
        for member in leftovers:
            if not member.future.done():
                try:
                    member.future.set_exception(TimeoutError(
                        "batcher closed while a device readback hung"))
                except Exception:
                    pass    # a drain thread resolved it meanwhile

    def _count(self, name: str) -> None:
        with self._lock:
            self.stats[name] += 1

    # ------------------------------------------------------------------

    def _ready(self, group: _Group, now: float, total: int) -> bool:
        if len(group.members) >= self.max_batch:
            return True
        if self._stop or now - group.members[0].enqueued_at >= self.deadline_s:
            return True
        return self.lone_flush and total == 1

    def _pop_ready_locked(self) -> Optional[_Group]:
        now = time.monotonic()
        total = sum(len(g.members) for g in self._groups.values())
        best = None
        for key, group in self._groups.items():
            if group.members and self._ready(group, now, total):
                if best is None or len(group.members) > len(
                    self._groups[best].members
                ):
                    best = key
        if best is None:
            return None
        group = self._groups[best]
        take_n = min(self.max_batch, len(group.members))
        if group.runner is None and self.governor is not None:
            # memory admission: cap the take so the padded launch fits the
            # device budget and the family's ceiling; the rest stays queued
            cap = self.governor.member_cap(
                group.base_key, group.in_shape, take_n, _round_batch,
            )
            if cap is not None and cap < take_n:
                take_n = cap
                self.governor.record_presplit()
        take = group.members[:take_n]
        group.members = group.members[take_n:]
        if not group.members:
            del self._groups[best]
        return replace(group, members=take)

    def _next_wait_locked(self) -> Optional[float]:
        now = time.monotonic()
        waits = [
            g.members[0].enqueued_at + self.deadline_s - now
            for g in self._groups.values() if g.members
        ]
        return max(min(waits), 0.0) if waits else None

    def _run(self) -> None:
        me = threading.current_thread()
        with self._lock:
            if self._thread is me:
                self._executor_pending = False
        while True:
            with self._lock:
                while True:
                    if self._thread is not me:
                        # replaced: pass the wakeup on (a submit's notify
                        # wakes ONE waiter; if that was this thread, the
                        # live executor would sleep with work queued)
                        self._lock.notify()
                        return
                    group = self._pop_ready_locked()
                    if group is not None:
                        break
                    if self._stop and not self._groups:
                        return
                    self._lock.wait(timeout=self._next_wait_locked())
                self._busy_since = time.monotonic()
                self._busy_owner = me
                # in flight from the pop on: close() must see (and stamp) a
                # batch whose dispatch is still running or wedged
                self._inflight_batches.append(group.members)
            handed_off = False
            try:
                handed_off = self._execute(group)
            except Exception as exc:  # the last line keeping the executor alive
                self._fail_members(group.members, exc)
            except BaseException as exc:
                # the thread dies, but its batch must not die silently; the
                # next submission's heal check replaces the executor
                self._fail_members(group.members, RuntimeError(
                    f"batch executor died: {exc!r}"))
                self._clear_busy(me)
                raise
            finally:
                if not handed_off:
                    # resolved on this thread; a handed-off batch stays in
                    # flight until its drain thread ends
                    self._forget_batch(group.members)
            self._clear_busy(me)

    def _forget_batch(self, members: List[_Pending]) -> None:
        with self._lock:
            if members in self._inflight_batches:
                self._inflight_batches.remove(members)

    def _execute(self, group: _Group) -> bool:
        """Run one popped group. A transform group is dispatched and handed
        to a drain thread (returns True); an aux group runs here, and a
        failure before the hand-off goes to ``_recover`` on this thread."""
        members = group.members
        try:
            # a blocking plan here wedges the executor; a raising one goes
            # through the same recovery as a failed launch
            faults.fire("batcher.execute", key=group.key, n=len(members))
            if group.runner is not None:
                self._resolve_members(group, members,
                                      self._run_members(group, members))
                return False
            return self._dispatch(group, members)
        except Exception as exc:
            self._recover(group, members, exc)
            return False

    def _dispatch(self, group: _Group, members: List[_Pending]) -> bool:
        """Take a pipeline slot, assemble, launch, and hand the readback to
        a drain thread. The slot is taken before the assembly, so that a
        launch's pinned staging counts against the window as its device
        tensors do, and depth 1 is the strict order (assemble, launch, read
        back, then the next); at depth 2 the next group assembles while the
        last one runs and reads back. The slot is the semaphore INSTANCE
        taken here: a wedge heal may swap ``self._inflight``, and the
        release must go to this one."""
        n = len(members)
        inflight = self._inflight
        self._suspend_busy()
        inflight.acquire()
        self._note_inflight(1)
        self._touch_busy()
        try:
            batch, images, geo, fn, key = self._prepare(group, members)
            measure = not costledger.launched(key)
            if measure:
                self._suspend_busy()
            self.launch_log.append(("transform", n, batch))
            launch = self._launch(fn, images, geo, measure)
            first = measure and costledger.first_launch(key)
            self._touch_busy()
            # the launch rides in a box the drain empties: the thread's own
            # argument tuple would keep its tensors alive through a recovery
            # on the drain thread
            threading.Thread(
                target=self._drain,
                args=(group, members, [launch], key, batch, first, inflight),
                name="flyimg-torch-batcher-drain", daemon=True,
            ).start()
            return True
        except BaseException:
            self._note_inflight(-1)
            inflight.release()
            raise

    def _note_inflight(self, step: int) -> None:
        with self._lock:
            self._launches_inflight += step
            self.inflight_peak = max(self.inflight_peak, self._launches_inflight)

    def _drain(self, group: _Group, members: List[_Pending], box: list, key,
               batch: int, first: bool, inflight: threading.Semaphore) -> None:
        """Wait for one dispatched launch, read it back, account it and
        resolve its members (a daemon drain thread). A failure here goes to
        ``_recover`` on this thread."""
        n = len(members)
        launch = box.pop()
        try:
            faults.fire("batcher.drain", key=group.key, n=n, batch=batch)
            host = self._read_back(launch)
            device_s = time.perf_counter() - launch.t_dispatch
            peak = launch.peak
            launch = None
            self._account(group, key, batch, n, device_s, first, peak)
            self._resolve_members(group, members, host)
        except Exception as exc:
            launch = None   # its device tensors go before recovery launches
            self._recover(group, members, exc)
        finally:
            self._note_inflight(-1)
            inflight.release()
            self._forget_batch(members)

    def _prepare(self, group: _Group, members: List[_Pending]):
        """Host side of one transform launch: the padded batch, its host
        tensors (pinned on CUDA), the program, and the program's ledger
        key. Fires ``batcher.member`` for each member (a raising plan models
        a poison member failing the launch) and ``batcher.oom``."""
        n = len(members)
        for i, member in enumerate(members):
            faults.fire("batcher.member", key=group.key, index=i, image=member.payload)
        batch = _round_batch(n)
        images, geo = assemble_batch(
            group, [(m.payload, m.plan, m.src_window) for m in members],
            batch, pin=self._stream is not None,
        )
        faults.fire("batcher.oom", key=group.key, n=n, batch=batch)
        fn = make_program_fn(
            group.resample_out, group.pad_canvas, group.pad_offset,
            group.device_plan, group.rotate_dynamic, group.band_taps,
        )
        return batch, images, geo, fn, (("batched", str(self.device), batch)
                                        + tuple(group.base_key))

    def _launch(self, fn, images, geo, measure_peak: bool) -> _Launch:
        """Enqueue one launch: on CUDA the copy up, the program and the copy
        back into a pinned buffer, on the controller's stream, with an
        event after them (nothing waits here); on the CPU the program runs
        here. ``measure_peak``: the allocator's peak over the enqueue, less
        what was allocated before (a program's first launch)."""
        t_dispatch = time.perf_counter()
        if self._stream is None:
            return _Launch(t_dispatch, host=fn(images, *program_args(geo)).numpy())
        dev = self.device
        before = None
        with torch.cuda.stream(self._stream):
            if measure_peak:
                before = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            d_img = images.to(dev, non_blocking=True)
            d_geo = geo.to(dev, non_blocking=True)
            out = fn(d_img, *program_args(d_geo))
            pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            pinned.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        peak = None
        if before is not None:
            peak = float(torch.cuda.max_memory_allocated(dev) - before)
        # the tensors live until the readback: the staging buffers until
        # the copies up end, the device ones until the copy back does
        return _Launch(t_dispatch, pinned=pinned, event=done, peak=peak,
                       keep=(images, geo, d_img, d_geo, out))

    @staticmethod
    def _read_back(launch: _Launch) -> np.ndarray:
        if launch.event is None:
            return launch.host
        launch.event.synchronize()
        return launch.pinned.numpy()

    def _account(self, group: _Group, key, batch: int, n: int,
                 device_s: float, first: bool, peak: Optional[float]) -> None:
        """After a completed readback: the ledger's build record (a first
        launch) and launch record, and the governor's lesson (the family's
        bytes per member from the ledger's peak; a clean launch at a
        ceiling counts toward its raise)."""
        if first:
            self._ledger.record_compile(
                key, descriptor=program_descriptor(group, batch, self.device),
                compile_s=device_s, peak_memory_bytes=peak,
            )
        self._ledger.record_launch(key, device_s=device_s, images=n)
        if self.governor is not None:
            self.governor.observe(group.base_key, batch, self._ledger.peak_memory(key))
            self.governor.record_success(group.base_key, n)

    def _run_members(self, group: _Group, members: List[_Pending]):
        """ONE synchronous launch of ``members`` (assemble -> run -> read
        back) for an aux group and for every recovery launch; raises on
        failure, returns the outputs for ``_resolve_members``."""
        self._touch_busy()      # a recovery launch is progress
        n = len(members)
        if group.runner is not None:
            for i, member in enumerate(members):
                faults.fire("batcher.member", key=group.key, index=i,
                            image=member.payload)
            self.launch_log.append(("aux", n, n))
            outputs = group.runner([m.payload for m in members])
            if len(outputs) != n:
                raise RuntimeError(
                    f"aux runner returned {len(outputs)} results for {n} payloads"
                )
            faults.fire("batcher.drain", key=group.key, n=n, batch=n)
            return outputs
        batch, images, geo, fn, key = self._prepare(group, members)
        measure = not costledger.launched(key)
        if measure:
            self._suspend_busy()
        self.launch_log.append(("transform", n, batch))
        launch = self._launch(fn, images, geo, measure)
        first = measure and costledger.first_launch(key)
        faults.fire("batcher.drain", key=group.key, n=n, batch=batch)
        host = self._read_back(launch)
        device_s = time.perf_counter() - launch.t_dispatch
        self._touch_busy()
        self._account(group, key, batch, n, device_s, first, launch.peak)
        return host

    def _resolve_members(self, group: _Group, members: List[_Pending],
                         outputs) -> None:
        """Resolve every member's future from one launch's outputs (a
        future already settled is skipped)."""
        for i, member in enumerate(members):
            result = outputs[i]
            if group.runner is None:
                if member.needs_slice:
                    th, tw = member.final_true
                    result = result[: int(th), : int(tw)]
                result = np.ascontiguousarray(result)
            if not member.future.done():
                member.future.set_result(result)

    @staticmethod
    def _fail_members(members: List[_Pending], exc: BaseException) -> None:
        for member in members:
            if not member.future.done():
                member.future.set_exception(exc)

    # ------------------------------------------------------------------
    # failure containment: classify -> retry (transient) / bisect (poison)
    # / split (oversize) / fail at once (fatal)

    def _recover(self, group: _Group, members: List[_Pending],
                 exc: Exception) -> None:
        """Containment of one failed launch, on the thread that saw the
        failure: the executor (assembly, dispatch, an aux group) or the
        launch's drain thread (the readback).
        Recovery launches are bounded: ``batch_retries`` for a transient
        error, at most 2·ceil(log2 n) for a bisection. A sticky CUDA error
        met during recovery stops it and fails every member still
        waiting."""
        live = [m for m in members if not m.future.done()]
        if not live:
            return
        try:
            kind = classify_batch_error(exc)
            if kind == OVERSIZE and self.bisect_enable:
                self._recover_oversize(group, live, exc)
                return
            if kind == TRANSIENT and self.batch_retries > 0:
                exc = self._retry_batch(group, live, exc)
                if exc is None:
                    return      # a retry resolved every member
                kind = classify_batch_error(exc)
            if kind == POISON and self.bisect_enable:
                if len(live) == 1:
                    self._fail_poison(group, live[0], exc)
                else:
                    self._bisect(group, live)
                return
        except Exception as err:
            if classify_batch_error(err) != FATAL:
                raise
            exc, kind = err, FATAL
        if kind == FATAL:
            failure = ExecFailedException(
                "a sticky CUDA error lost this process's CUDA context, so "
                "the batch is failed without a retry or a bisection (every "
                f"later launch fails too): {exc}"
            )
            failure.__cause__ = exc
            exc = failure
        self._fail_members(live, exc)

    def _retry_batch(self, group: _Group, members: List[_Pending],
                     first_exc: Exception) -> Optional[Exception]:
        """Bounded whole-batch retry with full-jitter backoff. Returns None
        when a retry resolved the members, else the error to go on with
        (the last transient one, or the first of another class); a sticky
        CUDA error raises."""
        last = first_exc
        for attempt in range(1, self.batch_retries + 1):
            delay = self._retry_policy.backoff(attempt)
            self._count("retries")
            if delay > 0:
                self._retry_policy.sleep(delay)
            try:
                outputs = self._run_members(group, members)
            except Exception as exc:
                last = exc
                kind = classify_batch_error(exc)
                if kind == FATAL:
                    raise
                if kind != TRANSIENT:
                    return exc
                continue
            self._resolve_members(group, members, outputs)
            return None
        return last

    def _recover_oversize(self, group: _Group, live: List[_Pending],
                          exc: Exception) -> None:
        """An out-of-memory launch indicts its footprint, not a member: cap
        the plan family's ceiling (the governor halves it) and re-run the
        same members in halves. A single member that still does not fit
        fails with a 503 + Retry-After and is never quarantined."""
        _forget_frames(exc, self.device)
        if self.governor is not None:
            self.governor.record_oom(group.base_key, len(live))
        if len(live) == 1:
            self._fail_oversize(live[0], exc)
            return
        self._split_oversize(group, live)

    @staticmethod
    def _fail_oversize(member: _Pending, exc: Exception) -> None:
        if member.future.done():
            return
        failure = ServiceUnavailableException(
            "device memory exhausted at the smallest possible launch; the "
            "plan family's capacity ceiling was capped: retry shortly"
        )
        failure.__cause__ = exc
        member.future.set_exception(failure)

    def _split_oversize(self, group: _Group, members: List[_Pending]) -> None:
        """Halving re-launch of an out-of-memory batch. Not a search: every
        member is presumed innocent; a half that still runs out of memory
        halves again (the ceiling with it), down to single members. Another
        error class from a smaller launch goes to the retry / bisection."""
        mid = len(members) // 2
        for part in (members[:mid], members[mid:]):
            live = [m for m in part if not m.future.done()]
            if not live:
                continue
            try:
                outputs = self._run_members(group, live)
            except Exception as sub_exc:
                kind = classify_batch_error(sub_exc)
                if kind == FATAL:
                    raise
                if kind == OVERSIZE:
                    _forget_frames(sub_exc, self.device)
                    if self.governor is not None:
                        self.governor.record_oom(group.base_key, len(live))
                    if len(live) > 1:
                        self._split_oversize(group, live)
                    else:
                        self._fail_oversize(live[0], sub_exc)
                    continue
                if kind == TRANSIENT and self.batch_retries > 0:
                    sub_exc = self._retry_batch(group, live, sub_exc)
                    if sub_exc is None:
                        continue
                    kind = classify_batch_error(sub_exc)
                if kind == POISON:
                    if len(live) > 1:
                        self._bisect(group, live)
                    else:
                        self._fail_poison(group, live[0], sub_exc)
                    continue
                self._fail_members(live, sub_exc)
                continue
            self._resolve_members(group, live, outputs)

    def _bisect(self, group: _Group, members: List[_Pending]) -> None:
        """Recursive bisection: re-run a failed batch as two halves,
        recursing into a half that fails, down to single members. The
        innocent members resolve on the first passing launch and only the
        poison ones fail: at most 2·ceil(log2 n) more launches for one
        poison member in n."""
        mid = len(members) // 2
        for part in (members[:mid], members[mid:]):
            live = [m for m in part if not m.future.done()]
            if not live:
                continue
            try:
                outputs = self._run_members(group, live)
            except Exception as exc:
                kind = classify_batch_error(exc)
                if kind == FATAL:
                    raise
                if len(live) > 1:
                    self._bisect(group, live)
                    continue
                if kind == TRANSIENT and self.batch_retries > 0:
                    # a hiccup while re-running an innocent member must not
                    # fail it: the same bounded retry a batch gets
                    exc = self._retry_batch(group, live, exc)
                    if exc is None:
                        continue
                self._fail_poison(group, live[0], exc)
                continue
            self._resolve_members(group, live, outputs)

    def _fail_poison(self, group: _Group, member: _Pending,
                     exc: Exception) -> None:
        """The terminal isolation of ONE member: only its future fails,
        with the original error, and poison work is fingerprinted into
        quarantine (aux members carry no pixels contract and never are)."""
        if classify_batch_error(exc) == POISON:
            self._count("poison_isolated")
            if self.quarantine is not None and member.plan is not None:
                if member.fp_digest is None:
                    member.fp_digest = _image_digest(member.payload)
                self.quarantine.add((group.base_key, member.fp_digest))
        if not member.future.done():
            member.future.set_exception(exc)
