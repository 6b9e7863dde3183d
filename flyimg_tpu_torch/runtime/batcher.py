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

Not ported yet (ROADMAP): failure isolation (bisection, quarantine),
pipelined readback, admission control, autotuning and OOM recovery. A
failed launch fails every member of its batch; nothing is classified as
poison, and ``classify_error`` maps ``torch.OutOfMemoryError`` to
``"oversize"`` (capacity, never the member's fault).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
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
from flyimg_tpu_torch.spec.plan import TransformPlan

MAX_BATCH_BUCKET = 64


def _round_batch(n: int) -> int:
    """The shared power-of-two occupancy ladder, capped."""
    return min(bucket_batch(n), MAX_BATCH_BUCKET)


def classify_error(exc: BaseException) -> str:
    """``"oversize"`` for a device out-of-memory (the batch was too big for
    the card: capacity, not a poison member), else ``"error"``."""
    if isinstance(exc, torch.OutOfMemoryError):
        return "oversize"
    return "error"


@dataclass(eq=False)
class _Pending:
    payload: object                 # [h, w, 3] uint8 image, or aux payload
    plan: Optional[TransformPlan]
    future: Future
    enqueued_at: float
    final_true: Tuple[int, int] = (0, 0)
    needs_slice: bool = False
    src_window: Optional[Tuple[int, int]] = None


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
        self.launch_log: Deque[Tuple[str, int, int]] = deque(maxlen=4096)
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
        (x, y) offset, threaded to the program as a span shift."""
        template, final_true, needs_slice = transform_group(
            plan, image.shape[:2], src_window
        )
        key = template.key
        pending = _Pending(
            payload=image, plan=plan, future=Future(),
            enqueued_at=time.monotonic(), final_true=final_true,
            needs_slice=needs_slice, src_window=src_window,
        )
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
            key=full_key, runner=runner,
        ))
        return pending.future

    def _enqueue(self, key, pending: _Pending, make_group) -> None:
        with self._lock:
            if self._stop:
                raise RuntimeError("batcher is closed")
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = make_group()
            group.members.append(pending)
            self._lock.notify()

    def close(self, timeout: float = 10.0) -> None:
        """Stop taking work, run what is queued, and join the executor."""
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout)

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
        take = group.members[: self.max_batch]
        group.members = group.members[self.max_batch:]
        if not group.members:
            del self._groups[best]
        return _Group(
            key=group.key, in_shape=group.in_shape,
            resample_out=group.resample_out, pad_canvas=group.pad_canvas,
            pad_offset=group.pad_offset, device_plan=group.device_plan,
            rotate_dynamic=group.rotate_dynamic, band_taps=group.band_taps,
            runner=group.runner, members=take,
        )

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
            except BaseException as exc:  # every member learns why
                for member in group.members:
                    if not member.future.done():
                        member.future.set_exception(exc)

    def _execute(self, group: _Group) -> None:
        members = group.members
        if group.runner is not None:
            self.launch_log.append(("aux", len(members), len(members)))
            results = group.runner([m.payload for m in members])
            for member, result in zip(members, results):
                if not member.future.done():
                    member.future.set_result(result)
            return
        n = len(members)
        batch = _round_batch(n)
        self.launch_log.append(("transform", n, batch))
        images, geo = assemble_batch(
            group, [(m.payload, m.plan, m.src_window) for m in members],
            batch, pin=self._stream is not None,
        )
        fn = make_program_fn(
            group.resample_out, group.pad_canvas, group.pad_offset,
            group.device_plan, group.rotate_dynamic, group.band_taps,
        )
        if self._stream is None:
            host = fn(images, *program_args(geo)).numpy()
        else:
            with torch.cuda.stream(self._stream):
                d_img = images.to(self.device, non_blocking=True)
                d_geo = geo.to(self.device, non_blocking=True)
                out = fn(d_img, *program_args(d_geo))
                pinned = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
                pinned.copy_(out, non_blocking=True)
            self._stream.synchronize()
            host = pinned.numpy()
        for i, member in enumerate(members):
            result = host[i]
            if member.needs_slice:
                th, tw = member.final_true
                result = result[: int(th), : int(tw)]
            if not member.future.done():
                member.future.set_result(np.ascontiguousarray(result))
