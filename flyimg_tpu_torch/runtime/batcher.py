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

One executor thread owns the device. On CUDA each launch stages its
inputs in pinned host buffers, copies them to the card on the
controller's own stream, runs the program on that stream and reads the
result back through a pinned buffer.

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
error, as before containment. ``max_queue_depth`` bounds pending
submissions (503 + Retry-After past it); a ``governor``
(``runtime/memgovernor.py``) caps how many members a launch takes. Not
ported yet (ROADMAP Queue A 2): pipelined readback, executor self-healing
and the cost ledger.
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
    """The containment keyword arguments of ``BatchController`` from the
    server parameters (the JAX package's ``resilience_*`` keys)."""
    return dict(
        batch_retries=int(params.by_key("resilience_batch_retries", 2)),
        bisect_enable=bool(params.by_key("resilience_bisect_enable", True)),
        quarantine_ttl_s=float(params.by_key("resilience_quarantine_ttl", 300.0)),
        max_queue_depth=int(params.by_key("batch_max_queue_depth", 0)),
        shed_retry_after_s=float(params.by_key("shed_retry_after_s", 1.0)),
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
        max_queue_depth: int = 0,
        shed_retry_after_s: float = 1.0,
        batch_retries: int = 2,
        bisect_enable: bool = True,
        quarantine_ttl_s: float = 0.0,
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
        #: containment counters: batch retries, poison members isolated,
        #: submissions that hit quarantine
        self.stats = {"retries": 0, "poison_isolated": 0, "quarantine_hits": 0}
        self._quarantine_seq = itertools.count()
        self._groups: Dict[Tuple, _Group] = {}
        self._lock = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="flyimg-torch-batcher", daemon=True
        )
        self._thread.start()

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
        it resolves), then the group's get-or-create and append."""
        self.admission.acquire()
        pending.future.add_done_callback(lambda _f: self.admission.release())
        try:
            with self._lock:
                if self._stop:
                    raise RuntimeError("batcher is closed")
                group = self._groups.get(key)
                if group is None:
                    group = self._groups[key] = make_group()
                group.members.append(pending)
                self._lock.notify()
        except BaseException:
            self.admission.release()
            raise

    def close(self, timeout: float = 10.0) -> None:
        """Stop taking work, run what is queued, and join the executor."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout)

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
        while True:
            with self._lock:
                while True:
                    group = self._pop_ready_locked()
                    if group is not None:
                        break
                    if self._stop and not self._groups:
                        return
                    self._lock.wait(timeout=self._next_wait_locked())
            try:
                self._execute(group)
            except BaseException as exc:  # the last line keeping the executor alive
                self._fail_members(group.members, exc)

    def _execute(self, group: _Group) -> None:
        """Run one popped group; a failed launch goes to ``_recover``."""
        members = group.members
        try:
            # a blocking plan here wedges the executor; a raising one goes
            # through the same recovery as a failed launch
            faults.fire("batcher.execute", key=group.key, n=len(members))
            outputs = self._run_members(group, members)
        except Exception as exc:
            self._recover(group, members, exc)
            return
        self._resolve_members(group, members, outputs)

    def _run_members(self, group: _Group, members: List[_Pending]):
        """ONE synchronous launch of ``members`` (assemble -> run -> read
        back), for the primary launch and every recovery launch alike;
        raises on failure, returns the outputs for ``_resolve_members``."""
        n = len(members)
        for i, member in enumerate(members):
            # a raising plan models a poison member failing the whole launch
            faults.fire("batcher.member", key=group.key, index=i, image=member.payload)
        if group.runner is not None:
            self.launch_log.append(("aux", n, n))
            outputs = group.runner([m.payload for m in members])
            if len(outputs) != n:
                raise RuntimeError(
                    f"aux runner returned {len(outputs)} results for {n} payloads"
                )
            faults.fire("batcher.drain", key=group.key, n=n, batch=n)
            return outputs
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
        self.launch_log.append(("transform", n, batch))
        if self._stream is None:
            host = fn(images, *program_args(geo)).numpy()
            faults.fire("batcher.drain", key=group.key, n=n, batch=batch)
        else:
            with torch.cuda.stream(self._stream):
                d_img = images.to(self.device, non_blocking=True)
                d_geo = geo.to(self.device, non_blocking=True)
                out = fn(d_img, *program_args(d_geo))
                pinned = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
                pinned.copy_(out, non_blocking=True)
            faults.fire("batcher.drain", key=group.key, n=n, batch=batch)
            self._stream.synchronize()
            host = pinned.numpy()
        if self.governor is not None:
            self.governor.record_success(group.base_key, n)
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
        """Containment of one failed launch, on the executor thread.
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
