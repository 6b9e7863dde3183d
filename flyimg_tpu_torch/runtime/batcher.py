"""BatchController: dynamic batching of concurrent transform requests.

The port of ``flyimg_tpu/runtime/batcher.py``, reduced to what the main
path needs. Requests are grouped by device-program identity — the key the
program cache uses: (input bucket shape, static resample output, pad
config, ``plan.device_plan()``, dynamic rotate, band widths) — so a group
runs as ONE batched program:

    uint8 [B, Hb, Wb, 3] + per-image spans/true sizes -> uint8 [B, Ho, Wo, 3]

A group flushes when it reaches ``max_batch`` members or its oldest member
has waited ``deadline_ms``, or at once when it is the only pending request
(the device is idle, so holding it buys no batching). The pair is the
controller's live policy: ``apply_policy`` (the autotuner's write path)
swaps it as one tuple under the lock and wakes the executor, so a shorter
deadline re-arms its wait at once and no flush reads half a policy.
Launch sizes ride a power-of-two ladder capped at ``MAX_BATCH_BUCKET``
(pad slots repeat the last member). Auxiliary groups (``submit_aux``, the smart-crop scoring
pass) batch the same way and run ``runner(payloads)``.

With a ``mesh`` (the JAX package's data-parallel serving), transform
launches shard over its ``data`` axis: a launch's batch is padded to the
power-of-two ladder rounded up to a multiple of the axis
(``_padded_batch``, which the memory governor's admission reads too), cut
into one equal chunk a rank, and chunk r runs through the single-device
batched program on rank r's device and stream, inside
``torch.cuda.device`` of that rank (the kernels launch on the current
device); the chunks read back in rank order. Ranks may share a device (a
virtual mesh). Aux groups stay unsharded, as in the JAX batcher. The
mesh is part of a program's identity (``build_batched_program``): a
sharded and an unsharded program of one plan never share a handle or a
ledger row.

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

A launch's program comes from ``build_batched_program``, an lru cache of
256 ``ProgramHandle``s (``ops/compose.py``) keyed on the group's program
key, its device, its padded batch (one process may run a program on the
card and on the CPU) and the mesh; ``handle.is_compiled`` is the launch's compile hit
(metrics, the span's ``program.compile_cache``, the flight record). A
failover empties the cache. Every completed transform launch is accounted
in the cost ledger (``runtime/costledger.py``) under the handle's key: a
program's first completed launch (unless ``precompile`` ran it) as its
build, with the allocator's measured peak, and each launch's seconds from
dispatch to completed readback. The memory governor learns its per-member
bytes from that peak on the drain side.

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

With a ``supervisor`` (``runtime/devicesupervisor.py``, opt-in) each
transform launch resolved reports a success and each failed launch or
retry its class; the supervisor's failover rebuilds the controller on the
CPU (``pause_launches``, ``drain_inflight``, ``failover_backend``) and its
re-promotion on the card. Without one nothing leaves the controller's
device.

Observability (the JAX batcher's): ``stats()`` is the JAX method, the
launch counts of the metrics registry beside the controller's rolling
efficiency window; ``containment_counts`` counts retries, poison members
isolated and quarantine hits. Each launch gets a batch id. A launch
whose members carry request traces mints ONE shared span
(``device_execute``, ``aux_execute`` or ``batch_recovery``) that is
attached to every member's trace under the span that member had open at
submit. Every launch resolution (primary, aux, recovery, failure) is one
flight-recorder record and one ``record_batch_launch`` into the metrics
registry. The device split keeps the JAX meanings: ``h2d_s`` the enqueue of
the copies up, ``dispatch_s`` the enqueue of the program and the copy back,
``sync_s`` the drain thread's wait for the readback, and ``device_s`` from
dispatch to the completed readback; nothing here synchronizes the launch
thread. Each launch runs inside ``torch.profiler.record_function(
"flyimg:batch:<id>")`` between the profiler's ``on_batch_start`` and
``on_batch_end``, so a capture, a trace and a flight record name the same
batch id.
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
from functools import lru_cache, partial
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    ExecFailedException,
    ServiceUnavailableException,
)
from flyimg_tpu_torch.ops.compose import (
    ProgramHandle,
    _bucket_dim,
    bucket_batch,
    check_ported,
    final_extent,
    geometry_rows,
    invalidate_program_caches,
    make_handle,
    plan_layout,
    program_args,
    program_descriptor,
)
from flyimg_tpu_torch.ops.resample import kernel_mode, select_band_taps
from flyimg_tpu_torch.parallel.mesh import (
    Mesh,
    gather_shards,
    leading_shards,
    mesh_identity,
    on_device,
    shard_size,
)
from flyimg_tpu_torch.runtime import costledger, tracing, warmstart
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry, escape_label_value
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


class ShardedProgramHandle(ProgramHandle):
    """A batched program sharded over a mesh's ``data`` axis (the JAX
    program under ``NamedSharding(mesh, P("data"))``): the padded batch cut
    into one equal chunk a rank, chunk r through the single-device batched
    program on rank r's device, the outputs joined in rank order. ``ranks``
    is each rank's (device, program); ranks on one device (a virtual mesh)
    share its program. Called, it runs the ranks one after another (the
    CPU's form, and ``precompile``'s); the batcher's launch on the card
    enqueues each rank on a stream of its own instead."""

    __slots__ = ("ranks",)

    def __init__(self, key, descriptor: Dict[str, object], *, device: str,
                 shape: Tuple[int, int, int],
                 ranks: Tuple[Tuple[torch.device, ProgramHandle], ...]) -> None:
        first = ranks[0][1]
        super().__init__(self._run_ranks, key, descriptor, device=device, shape=shape,
                         kernels=first.kernels, frame=first._frame)
        self.ranks = ranks

    def _run_ranks(self, images, *args):
        chunks = zip(*(leading_shards(t, len(self.ranks)) for t in (images, *args)))
        outs = []
        for (dev, program), chunk in zip(self.ranks, chunks):
            with on_device(dev):
                outs.append(program(*(t.to(dev) for t in chunk)))
        return gather_shards(outs, images.device)

    def warm(self, shape: Tuple[int, int, int]) -> Optional[float]:
        """Each device's program run once on a zero chunk (``shape``'s batch
        over the ranks); the peaks of the devices summed."""
        b, h, w = shape
        per = shard_size(b, len(self.ranks))
        peaks = []
        for dev, program in dict(self.ranks).items():
            with on_device(dev):
                peaks.append(program.warm((per, h, w)))
        return None if peaks[0] is None else float(sum(peaks))

    def mark_compiled(self) -> None:
        super().mark_compiled()
        for _dev, program in self.ranks:
            program.mark_compiled()


def build_batched_program(
    batch: int,
    in_shape: Tuple[int, int],
    resample_out: Optional[Tuple[int, int]],
    pad_canvas: Optional[Tuple[int, int]],
    pad_offset: Tuple[int, int],
    plan: TransformPlan,
    device: str,
    rotate_dynamic: bool = False,
    band_taps: Optional[Tuple[int, int]] = None,
    mesh: Optional[Mesh] = None,
) -> ProgramHandle:
    """The batched program of one group at one padded batch on ``device``
    (``str`` of a ``torch.device``), sharded over ``mesh``'s ``data`` axis
    when one is given (``batch`` a multiple of that axis), cached: one
    entry, one handle, however the arguments are spelled. Its key is the
    cost ledger's, ``("batched", device, batch) + group.base_key``, with
    ``("mesh", axes, devices)`` after it for a sharded program (where the
    JAX key has ``mesh.shape``)."""
    return _batched_program(batch, in_shape, resample_out, pad_canvas, pad_offset, plan,
                            device, rotate_dynamic, band_taps, mesh)


@lru_cache(maxsize=256)
def _batched_program(batch, in_shape, resample_out, pad_canvas, pad_offset, plan, device,
                     rotate_dynamic, band_taps, mesh) -> ProgramHandle:
    key = ("batched", device, batch, in_shape, resample_out, pad_canvas, pad_offset,
           plan, rotate_dynamic, band_taps)
    devices = mesh.axis_devices("data") if mesh is not None else ()
    if mesh is not None:
        per = shard_size(batch, len(devices))
    # warm start's recorder (a no-op unless installed): once a program, the
    # device and the mesh left out (a seeding server builds on its own)
    warmstart.record_batched(batch, in_shape, resample_out, pad_canvas, pad_offset,
                             plan, rotate_dynamic, mesh is not None, band_taps)
    if mesh is None:
        return make_handle(key, batch, in_shape, resample_out, pad_canvas, pad_offset,
                           plan, device, rotate_dynamic, band_taps)
    programs: Dict[torch.device, ProgramHandle] = {}
    for dev in devices:
        if dev not in programs:
            programs[dev] = make_handle(
                ("batched", str(dev), per) + key[3:], per, in_shape, resample_out,
                pad_canvas, pad_offset, plan, str(dev), rotate_dynamic, band_taps)
    descriptor = program_descriptor(plan, in_shape, batch, resample_out, pad_canvas,
                                    band_taps, device)
    descriptor["mesh"] = {"data": len(devices), "devices": [str(d) for d in devices]}
    return ShardedProgramHandle(
        key + (("mesh",) + mesh_identity(mesh),), descriptor, device=device,
        shape=(batch, *in_shape), ranks=tuple((dev, programs[dev]) for dev in devices))


build_batched_program.cache_info = _batched_program.cache_info
build_batched_program.cache_clear = _batched_program.cache_clear


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
    # the submitting request's trace and the span it had open at submit:
    # the shared batch span is attached there
    trace: Optional[object] = None
    parent_span_id: Optional[str] = None


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
    (CPU), or the pinned buffers and the events after the copies back into
    them (CUDA; one of each, or one a rank of a sharded launch), with the
    tensors that must live until then."""

    t_dispatch: float
    h2d_s: Optional[float] = None
    dispatch_s: Optional[float] = None
    host: Optional[np.ndarray] = None
    #: the pinned buffers and their events, one a rank in rank order
    pinned: Tuple = ()
    events: Tuple = ()
    peak: Optional[float] = None
    keep: Tuple = ()


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


def _runner_name(runner) -> str:
    """An aux runner's name for flight records and spans (a partial is
    named after its function)."""
    return getattr(runner, "__name__", None) or getattr(
        getattr(runner, "func", None), "__name__", "aux")


def _bind_trace(pending: _Pending) -> None:
    """Record the submitting request's trace and open span on a pending
    member (nothing when no trace is active)."""
    trace = tracing.current_trace()
    if trace is not None:
        span = tracing.current_span()
        pending.trace = trace
        pending.parent_span_id = span.span_id if span is not None else None


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
        metrics=None,
        name: str = "device",
        flight_recorder=None,
        profiler=None,
        batch_ids=None,
        supervisor=None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.name = name
        #: the data-parallel mesh transform launches shard over, or None
        self.mesh: Optional[Mesh] = None
        self._n_devices = 1
        self._rank_streams: Tuple = ()
        self._set_mesh(mesh, self.device)
        #: the device supervisor (runtime/devicesupervisor.py) fed by every
        #: transform launch's resolution, or None
        self.supervisor = supervisor
        # the server's registry, or a private one standalone
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        #: the flight recorder (one record per launch resolution) and the
        #: on-demand profiler (poked around every launch), or None
        self.flight_recorder = flight_recorder
        self.profiler = profiler
        # batch ids: the controllers of one server share one counter, so an
        # id names one launch in the flight recorder, the traces and a
        # profiler capture alike
        self._batch_ids = batch_ids if batch_ids is not None else itertools.count(1)
        self._batch_seq = 0
        # the live flush policy, ONE (max_batch, deadline_s) tuple: a flush
        # reads it with one reference load, so apply_policy is never seen
        # half-applied
        self._policy: Tuple[int, float] = (
            max(1, min(int(max_batch), MAX_BATCH_BUCKET)), float(deadline_ms) / 1000.0)
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
            metrics=self.metrics,
        )
        self.metrics.gauge(
            "flyimg_batcher_queue_depth"
            f'{{controller="{escape_label_value(name)}"}}',
            "Pending (queued or executing) submissions per controller",
            fn=lambda: self.admission.pending,
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
        self.containment_counts = {"retries": 0, "poison_isolated": 0, "quarantine_hits": 0}
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
        # the recovery span each thread has open (events of the retry,
        # split and bisection paths land there)
        self._tls = threading.local()
        self._groups: Dict[Tuple, _Group] = {}
        self._lock = threading.Condition()
        self._stop = False
        # launches hold while a backend switch runs (pause_launches)
        self._paused = False
        self._spawn_executor().start()

    # -- the live flush policy (runtime/autotuner.py writes here) -----------

    @property
    def max_batch(self) -> int:
        return self._policy[0]

    @property
    def deadline_s(self) -> float:
        return self._policy[1]

    def policy(self) -> Tuple[int, float]:
        """The current ``(max_batch, deadline_s)``, read as one tuple."""
        return self._policy

    def apply_policy(self, max_batch: Optional[int] = None,
                     deadline_ms: Optional[float] = None) -> Tuple[int, float]:
        """Install a new flush policy: both fields swap as ONE tuple under
        the lock, and the executor wakes, so a shorter deadline re-arms its
        wait at once. ``max_batch`` is clamped to [1, MAX_BATCH_BUCKET],
        the deadline to 0 or more; how far and how fast a policy may move
        is the autotuner's envelope, not this method's."""
        with self._lock:
            cur_batch, cur_deadline = self._policy
            self._policy = (
                max(1, min(int(max_batch), MAX_BATCH_BUCKET))
                if max_batch is not None else cur_batch,
                max(float(deadline_ms), 0.0) / 1000.0
                if deadline_ms is not None else cur_deadline,
            )
            self._lock.notify_all()
            return self._policy

    # -- the data-parallel mesh ----------------------------------------------

    @staticmethod
    def _check_mesh(mesh: Optional[Mesh], device: torch.device) -> None:
        """A batcher mesh needs a ``data`` axis whose ranks lie on the
        controller's kind of device."""
        if mesh is None:
            return
        if "data" not in mesh.axis_names:
            raise ValueError("batcher mesh needs a 'data' axis")
        kinds = {d.type for d in mesh.axis_devices("data")}
        if kinds != {device.type}:
            raise ValueError(f"batcher mesh on {sorted(kinds)} for a controller on "
                             f"{device.type}")

    def _set_mesh(self, mesh: Optional[Mesh], device: torch.device) -> None:
        """Install ``mesh`` (checked) with a stream a rank on the card."""
        self._check_mesh(mesh, device)
        self.mesh = mesh
        self._n_devices = int(mesh.shape["data"]) if mesh is not None else 1
        self._rank_streams = (
            tuple(torch.cuda.Stream(d) for d in mesh.axis_devices("data"))
            if mesh is not None and device.type == "cuda" else ())

    def _padded_batch(self, n: int) -> int:
        """The padded batch a launch of ``n`` members dispatches: the
        power-of-two ladder, rounded up to a multiple of the data axis (a
        sharded batch divides over it, and device counts need not be
        powers of two). The memory governor's admission predicts against
        the same size."""
        nd = self._n_devices
        return -(-_round_batch(n) // nd) * nd

    def stats(self) -> Dict[str, float]:
        """The JAX method: launch counts from the metrics registry (batches,
        images, and the occupancy those counters give since boot) beside
        this controller's rolling efficiency window (occupancy, padding
        waste, queue-wait share, batches per compile miss), the vocabulary
        /debug/perf and the bulk runner report."""
        summary = self.metrics.summary()
        images = summary.get("flyimg_images_processed_total", 0.0)
        slots = summary.get("flyimg_batch_slots_total", 0.0)
        eff = self.metrics.batch_efficiency(self.name).stats()
        return {
            "batches": summary.get("flyimg_batches_total", 0.0),
            "images": images,
            "mean_occupancy": eff["mean_occupancy"],
            "cumulative_occupancy": images / slots if slots else 0.0,
            "padding_waste": eff["padding_waste"],
            "queue_wait_share": eff["queue_wait_share"],
            "batches_per_compile_miss": eff["batches_per_compile_miss"],
        }

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
        _bind_trace(pending)
        key = base_key
        if self.quarantine is not None and self.quarantine.has_prefix(base_key):
            pending.fp_digest = _image_digest(image)
            if self.quarantine.hit((base_key, pending.fp_digest)):
                self._count("quarantine_hits")
                self.metrics.record_quarantine_hit()
                tracing.add_event("quarantine.hit", controller=self.name,
                                  digest=pending.fp_digest)
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
        _bind_trace(pending)
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
        self.metrics.record_executor_restart(reason)
        tracing.add_event("executor_restart", reason=reason, controller=self.name)
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
        self.drain_inflight(drain_timeout_s, "batcher closed while a device readback hung")

    def drain_inflight(self, drain_timeout_s: float,
                       message: str = "device batch abandoned during backend failover"
                       ) -> None:
        """THE bounded in-flight drain (``close`` and the device
        supervisor's failover and re-promotion share it): wait for every
        in-flight batch to resolve; past the budget the rest get a
        ``TimeoutError`` with ``message`` and leave the registry."""
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
                    member.future.set_exception(TimeoutError(message))
                except Exception:
                    pass    # a drain thread resolved it meanwhile

    def pause_launches(self) -> None:
        """Hold new launches (submissions keep queueing) while a backend
        switch runs; pair with ``resume_launches`` in a finally."""
        with self._lock:
            self._paused = True

    def resume_launches(self) -> None:
        with self._lock:
            self._paused = False
            self._lock.notify_all()

    def failover_backend(self, device, *, mesh: Optional[Mesh] = None,
                         drain_timeout_s: float = 10.0,
                         reason: str = "failover") -> None:
        """Rebuild the controller on ``device`` and ``mesh`` online (the
        device supervisor's failover to the CPU, which drops the mesh, and
        re-promotion to the card, which rebuilds it): launches hold, the
        in-flight ones drain (bounded), then the device, the mesh, the
        streams, a fresh pipeline semaphore and a replacement executor go
        in together under the lock; queued groups launch on the new
        backend, and aux runners bound to a device follow it
        (``_on_device``). A mesh without a ``data`` axis raises before
        anything changes."""
        device = resolve_device(device)
        self._check_mesh(mesh, device)
        self.pause_launches()
        replacement = None
        try:
            self.drain_inflight(drain_timeout_s)
            # before a replacement executor can launch: a handle whose
            # first launch completed on the old device must not count as
            # compiled on the new one
            invalidate_program_caches()
            stream = torch.cuda.Stream(device) if device.type == "cuda" else None
            with self._lock:
                self.device = device
                self._stream = stream
                self._set_mesh(mesh, device)
                # a batch wedged on the lost device keeps its slot: leave it
                # the old semaphore
                self._inflight = threading.Semaphore(self._pipeline_depth)
                self._busy_since = None
                self._busy_owner = None
                if not self._stop and not self._executor_pending:
                    replacement = self._spawn_executor()
        finally:
            self.resume_launches()
        self.metrics.record_executor_restart(reason)
        tracing.add_event("executor_restart", reason=reason, controller=self.name)
        if replacement is not None:
            try:
                replacement.start()
            except BaseException:
                with self._lock:
                    self._executor_pending = False
                raise

    def _on_device(self, runner):
        """An aux runner bound to a device (a partial with a ``device``
        keyword) runs on this controller's device: after a failover, the
        CPU."""
        if isinstance(runner, partial) and "device" in runner.keywords:
            bound = runner.keywords["device"]
            if bound is not None and torch.device(bound) != self.device:
                return partial(runner, device=self.device)
        return runner

    def _count(self, name: str) -> None:
        with self._lock:
            self.containment_counts[name] += 1

    # ------------------------------------------------------------------

    def _ready(self, group: _Group, now: float, total: int,
               policy: Tuple[int, float]) -> bool:
        max_batch, deadline_s = policy
        if len(group.members) >= max_batch:
            return True
        if self._stop or now - group.members[0].enqueued_at >= deadline_s:
            return True
        return self.lone_flush and total == 1

    def _pop_ready_locked(self) -> Optional[_Group]:
        now = time.monotonic()
        policy = self._policy
        total = sum(len(g.members) for g in self._groups.values())
        best = None
        for key, group in self._groups.items():
            if group.members and self._ready(group, now, total, policy):
                if best is None or len(group.members) > len(
                    self._groups[best].members
                ):
                    best = key
        if best is None:
            return None
        group = self._groups[best]
        take_n = min(policy[0], len(group.members))
        if group.runner is None and self.governor is not None:
            # memory admission: cap the take so the padded launch fits the
            # device budget and the family's ceiling; the rest stays queued
            cap = self.governor.member_cap(
                group.base_key, group.in_shape, take_n, self._padded_batch,
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
        deadline_s = self._policy[1]
        waits = [
            g.members[0].enqueued_at + deadline_s - now
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
                    group = None if self._paused else self._pop_ready_locked()
                    if group is not None:
                        break
                    if self._stop and not self._groups:
                        return
                    # paused, the deadlines do not matter: resume wakes it
                    self._lock.wait(
                        timeout=None if self._paused else self._next_wait_locked())
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

    # -- observability ------------------------------------------------------

    def _next_seq(self) -> int:
        """A launch's batch id, taken under the lock: recovery launches on
        drain threads share the counter."""
        with self._lock:
            self._batch_seq = next(self._batch_ids)
            return self._batch_seq

    @staticmethod
    def _member_trace_id(members: List[_Pending]) -> Optional[str]:
        """The first traced member's trace id: the exemplar and the flight
        record's join key."""
        for member in members:
            if member.trace is not None:
                return member.trace.trace_id
        return None

    @staticmethod
    def _attach_batch_span(members: List[_Pending], span_obj) -> None:
        """Fan the SHARED batch span into every member's trace (one span
        id everywhere), under the span each member had open at submit."""
        if span_obj is None:
            return
        for member in members:
            if member.trace is not None:
                member.trace.attach_shared(span_obj, member.parent_span_id)

    def _start_batch_span(self, name: str, n: int, batch: int,
                          members: List[_Pending], seq: int):
        """The shared span of one launch, minted only when a member is
        traced (the untraced path stays free)."""
        if not any(m.trace is not None for m in members):
            return None
        span_obj = tracing.Span(name)
        span_obj.set_attribute("batch.id", seq)
        span_obj.set_attribute("batch.controller", self.name)
        span_obj.set_attribute("batch.occupancy", n)
        span_obj.set_attribute("batch.size", batch)
        span_obj.set_attribute("batch.padded_slots", batch - n)
        oldest = min(m.enqueued_at for m in members)
        span_obj.set_attribute(
            "batch.queue_wait_s", round(time.monotonic() - oldest, 6))
        return span_obj

    def _fail_span(self, span_obj, members: List[_Pending], exc: Exception) -> None:
        """An errored launch's span still reaches the member traces (the
        tail sampler keeps exactly these)."""
        if span_obj is not None and span_obj.duration_s is None:
            span_obj.add_event("exception", type=type(exc).__name__,
                               message=str(exc))
            span_obj.end("error")
            self._attach_batch_span(members, span_obj)

    def _recovery_event(self, name: str, **attrs) -> None:
        """An event on the recovery span this thread has open, if any."""
        span_obj = getattr(self._tls, "recovery_span", None)
        if span_obj is not None:
            span_obj.add_event(name, **attrs)

    def _record_flight(self, group: _Group, members: List[_Pending], *,
                       n: int, batch: int, seq: Optional[int],
                       queue_wait_s: float, key=None,
                       h2d_s: Optional[float] = None,
                       dispatch_s: Optional[float] = None,
                       sync_s: Optional[float] = None,
                       device_s: Optional[float] = None,
                       compile_hit: Optional[bool] = None,
                       kind: str = "primary",
                       error: Optional[str] = None,
                       mem_event: Optional[str] = None) -> None:
        """One flight-recorder record per launch resolution (primary,
        aux, recovery and failures alike); nothing without a recorder.
        The plan key is the cost ledger's (``/debug/plans``) for a
        transform launch, ``aux:<runner>`` for an aux group."""
        if self.flight_recorder is None:
            return
        if group.runner is not None:
            plan_key = f"aux:{_runner_name(group.runner)}"
        else:
            plan_key = key
        predicted = budget = None
        if self.governor is not None and self.governor.enabled and group.runner is None:
            predicted = self.governor.predict_bytes(
                group.base_key, batch, group.in_shape)
            budget = self.governor.device_budget_bytes or None
        self.flight_recorder.record(
            controller=self.name, batch_id=seq, plan_key=plan_key,
            occupancy=n, capacity=batch, queue_wait_s=queue_wait_s,
            h2d_s=h2d_s, dispatch_s=dispatch_s, sync_s=sync_s,
            device_s=device_s, compile_hit=compile_hit, kind=kind,
            trace_id=self._member_trace_id(members), error=error,
            predicted_bytes=predicted, budget_bytes=budget,
            mem_event=mem_event,
        )

    def _record_failure(self, group: _Group, members: List[_Pending],
                        exc: Exception, **fields) -> None:
        self._record_flight(
            group, members, error=type(exc).__name__,
            mem_event="oversize" if classify_batch_error(exc) == OVERSIZE else None,
            **fields)

    def _profiler_start(self) -> bool:
        if self.profiler is None:
            return False
        self.profiler.on_batch_start()
        return True

    def _observe_launch(self, group: _Group, members: List[_Pending], *,
                        seq: int, n: int, batch: int, queue_wait_s: float,
                        key, h2d_s, dispatch_s, sync_s, device_s,
                        compile_hit, span_obj=None, kind: str = "primary",
                        mem_event: Optional[str] = None) -> None:
        """After a transform launch's completed readback, before its
        members resolve: the device time (a primary launch's), its split,
        the shared span, the efficiency record and the flight record."""
        trace_id = self._member_trace_id(members)
        if kind == "primary":
            self.metrics.record_device_batch_seconds(device_s, trace_id=trace_id)
        self.metrics.record_device_split(
            h2d_s=h2d_s, dispatch_s=dispatch_s, sync_s=sync_s, trace_id=trace_id)
        if span_obj is not None:
            span_obj.end()
            span_obj.set_attribute("device.seconds", round(device_s, 6))
            if h2d_s is not None:
                span_obj.set_attribute("device.h2d_s", round(h2d_s, 6))
            if dispatch_s is not None:
                span_obj.set_attribute("device.dispatch_s", round(dispatch_s, 6))
            span_obj.set_attribute("device.sync_s", round(sync_s, 6))
            self._attach_batch_span(members, span_obj)
        self.metrics.record_batch_launch(
            self.name, images=n, capacity=batch, queue_wait_s=queue_wait_s,
            device_s=device_s, compile_hit=compile_hit, trace_id=trace_id,
        )
        self._record_flight(
            group, members, n=n, batch=batch, seq=seq, queue_wait_s=queue_wait_s,
            key=key, h2d_s=h2d_s, dispatch_s=dispatch_s, sync_s=sync_s,
            device_s=device_s, compile_hit=compile_hit, kind=kind,
            mem_event=mem_event,
        )

    # -- launches -----------------------------------------------------------

    def _execute(self, group: _Group) -> bool:
        """Run one popped group. A transform group is dispatched and handed
        to a drain thread (returns True); an aux group runs here, and a
        failure before the hand-off goes to ``_recover`` on this thread."""
        members = group.members
        seq = self._next_seq()
        queue_wait_s = time.monotonic() - min(m.enqueued_at for m in members)
        try:
            # a blocking plan here wedges the executor; a raising one goes
            # through the same recovery as a failed launch
            faults.fire("batcher.execute", key=group.key, n=len(members))
        except Exception as exc:
            self._recover(group, members, exc)
            return False
        if group.runner is not None:
            self._execute_aux(group, members, seq, queue_wait_s)
            return False
        try:
            return self._dispatch(group, members, seq, queue_wait_s)
        except Exception as exc:
            self._recover(group, members, exc)
            return False

    def _execute_aux(self, group: _Group, members: List[_Pending], seq: int,
                     queue_wait_s: float) -> None:
        """One aux group on the executor thread, under its shared
        ``aux_execute`` span."""
        n = len(members)
        span_obj = self._start_batch_span("aux_execute", n, n, members, seq)
        if span_obj is not None:
            span_obj.set_attribute("batch.runner", _runner_name(group.runner))
        try:
            t_aux = time.perf_counter()
            outputs = self._aux_launch(group, members, seq)
            aux_s = time.perf_counter() - t_aux
        except Exception as exc:
            self._fail_span(span_obj, members, exc)
            self._record_flight(group, members, n=n, batch=n, seq=seq,
                                queue_wait_s=queue_wait_s, kind="aux",
                                error=type(exc).__name__)
            self._recover(group, members, exc)
            return
        # aux items are requests already counted by their transform
        # launch: counters of their own keep images_processed meaning
        # "images through the transform program"
        self.metrics.counter(
            "flyimg_aux_batches_total",
            "Batched auxiliary (scoring/detection) launches",
        ).inc()
        self.metrics.counter(
            "flyimg_aux_items_total", "Items through batched auxiliary programs",
        ).inc(n)
        self.metrics.record_batch_launch(
            self.name, images=n, capacity=n, queue_wait_s=queue_wait_s,
            device_s=aux_s, compile_hit=None,
            trace_id=self._member_trace_id(members), aux=True,
        )
        self._record_flight(group, members, n=n, batch=n, seq=seq,
                            queue_wait_s=queue_wait_s, device_s=aux_s, kind="aux")
        if span_obj is not None:
            span_obj.end()
            self._attach_batch_span(members, span_obj)
        self._resolve_members(group, members, outputs)

    def _aux_launch(self, group: _Group, members: List[_Pending], seq: int):
        """ONE synchronous ``runner(payloads)`` call of an aux group (its
        kernels launch and read back inside), in the batch's profiler
        range; raises on failure."""
        n = len(members)
        for i, member in enumerate(members):
            faults.fire("batcher.member", key=group.key, index=i,
                        image=member.payload)
        self.launch_log.append(("aux", n, n))
        poked = self._profiler_start()
        try:
            with torch.profiler.record_function(f"flyimg:batch:{seq}"):
                outputs = self._on_device(group.runner)([m.payload for m in members])
        finally:
            if poked:
                self.profiler.on_batch_end()
        if len(outputs) != n:
            raise RuntimeError(
                f"aux runner returned {len(outputs)} results for {n} payloads"
            )
        faults.fire("batcher.drain", key=group.key, n=n, batch=n, device=str(self.device))
        return outputs

    def _dispatch(self, group: _Group, members: List[_Pending], seq: int,
                  queue_wait_s: float) -> bool:
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
        span_obj = None
        batch, key, compile_hit, poked = n, None, None, False
        try:
            batch, images, geo, handle = self._prepare(group, members)
            key, compile_hit = handle.ledger_key, handle.is_compiled
            self.metrics.record_compile_event(compile_hit)
            span_obj = self._start_batch_span("device_execute", n, batch, members, seq)
            if span_obj is not None:
                span_obj.set_attribute(
                    "program.compile_cache", "hit" if compile_hit else "miss")
                span_obj.set_attribute("program.in_shape", str(group.in_shape))
            measure = not compile_hit
            if measure:
                self._suspend_busy()
            self.launch_log.append(("transform", n, batch))
            poked = self._profiler_start()
            launch = self._launch(handle, images, geo, measure, seq)
            first = measure and handle.claim_build()
            self._touch_busy()
            # the launch rides in a box the drain empties: the thread's own
            # argument tuple would keep its tensors alive through a recovery
            # on the drain thread
            threading.Thread(
                target=self._drain,
                args=(group, members, [launch], handle, batch, first, inflight,
                      seq, queue_wait_s, span_obj, compile_hit),
                name="flyimg-torch-batcher-drain", daemon=True,
            ).start()
            return True
        except BaseException as exc:
            self._note_inflight(-1)
            inflight.release()
            if poked:
                self.profiler.on_batch_end()
            if isinstance(exc, Exception):
                self._fail_span(span_obj, members, exc)
                self._record_failure(group, members, exc, n=n, batch=batch,
                                     seq=seq, queue_wait_s=queue_wait_s,
                                     key=key, compile_hit=compile_hit)
            raise

    def _note_inflight(self, step: int) -> None:
        with self._lock:
            self._launches_inflight += step
            self.inflight_peak = max(self.inflight_peak, self._launches_inflight)

    def _drain(self, group: _Group, members: List[_Pending], box: list,
               handle: ProgramHandle, batch: int, first: bool,
               inflight: threading.Semaphore,
               seq: int, queue_wait_s: float, span_obj,
               compile_hit: Optional[bool]) -> None:
        """Wait for one dispatched launch, read it back, account it and
        resolve its members (a daemon drain thread). A failure here goes to
        ``_recover`` on this thread."""
        n = len(members)
        launch = box.pop()
        h2d_s, dispatch_s = launch.h2d_s, launch.dispatch_s
        key = handle.ledger_key
        try:
            faults.fire("batcher.drain", key=group.key, n=n, batch=batch,
                        device=str(self.device))
            t_sync = time.perf_counter()
            host = self._read_back(launch)
            sync_s = time.perf_counter() - t_sync
            device_s = time.perf_counter() - launch.t_dispatch
            peak = launch.peak
            launch = None
            self._account(group, handle, batch, n, device_s, first, peak)
            self._observe_launch(
                group, members, seq=seq, n=n, batch=batch,
                queue_wait_s=queue_wait_s, key=key, h2d_s=h2d_s,
                dispatch_s=dispatch_s, sync_s=sync_s, device_s=device_s,
                compile_hit=compile_hit, span_obj=span_obj,
            )
            if self.supervisor is not None:
                # the card answered: a storm in progress resets
                self.supervisor.record_batch_success()
            self._resolve_members(group, members, host)
        except Exception as exc:
            launch = None   # its device tensors go before recovery launches
            self._fail_span(span_obj, members, exc)
            self._record_failure(group, members, exc, n=n, batch=batch, seq=seq,
                                 queue_wait_s=queue_wait_s, key=key,
                                 h2d_s=h2d_s, dispatch_s=dispatch_s,
                                 compile_hit=compile_hit)
            self._recover(group, members, exc)
        finally:
            if self.profiler is not None:
                self.profiler.on_batch_end()
            self._note_inflight(-1)
            inflight.release()
            self._forget_batch(members)

    def _prepare(self, group: _Group, members: List[_Pending]):
        """Host side of one transform launch: the padded batch, its host
        tensors (pinned on CUDA) and the program's handle. Fires
        ``batcher.member`` for each member (a raising plan models a poison
        member failing the launch) and ``batcher.oom``."""
        n = len(members)
        for i, member in enumerate(members):
            faults.fire("batcher.member", key=group.key, index=i, image=member.payload)
        batch = self._padded_batch(n)
        images, geo = assemble_batch(
            group, [(m.payload, m.plan, m.src_window) for m in members],
            batch, pin=self._stream is not None,
        )
        handle = build_batched_program(
            batch, group.in_shape, group.resample_out, group.pad_canvas,
            group.pad_offset, group.device_plan, str(self.device),
            group.rotate_dynamic, group.band_taps, self.mesh,
        )
        faults.fire("batcher.oom", key=group.key, n=n, batch=batch)
        return batch, images, geo, handle

    def _launch(self, fn, images, geo, measure_peak: bool, seq: int) -> _Launch:
        """Enqueue one launch inside its ``flyimg:batch:<seq>`` profiler
        range. On CUDA, for each rank (one: the controller's device and
        stream; a ``ShardedProgramHandle``: its ranks, each on a stream of
        its own inside ``torch.cuda.device`` of its rank) its chunk of the
        batch goes up (``h2d_s``), through its program and back into a
        pinned buffer of its own (``dispatch_s``), with an event after it
        (nothing waits here); on the CPU the program runs here.
        ``measure_peak``: the allocator's peak over the enqueue, less what
        was allocated before (a program's first launch), summed over the
        devices."""
        t_h2d = time.perf_counter()
        with torch.profiler.record_function(f"flyimg:batch:{seq}"):
            if self._stream is None:
                t_dispatch = time.perf_counter()
                host = fn(images, *program_args(geo)).numpy()
                return _Launch(t_dispatch, h2d_s=t_dispatch - t_h2d,
                               dispatch_s=time.perf_counter() - t_dispatch,
                               host=host)
            if isinstance(fn, ShardedProgramHandle):
                ranks, streams = fn.ranks, self._rank_streams
            else:
                ranks, streams = ((self.device, fn),), (self._stream,)
            if len(streams) != len(ranks):
                raise RuntimeError(f"a program of {len(ranks)} ranks on a controller "
                                   f"of {len(streams)}")
            devices = list(dict(ranks))
            before = None
            if measure_peak:
                before = [torch.cuda.memory_allocated(d) for d in devices]
                for d in devices:
                    torch.cuda.reset_peak_memory_stats(d)
            h2d_s = dispatch_s = 0.0
            t_dispatch = None
            pinned, events, keep = [], [], [images, geo]
            chunks = zip(leading_shards(images, len(ranks)), leading_shards(geo, len(ranks)))
            for (dev, program), stream, (img, g) in zip(ranks, streams, chunks):
                with on_device(dev), torch.cuda.stream(stream):
                    t0 = time.perf_counter()
                    d_img = img.to(dev, non_blocking=True)
                    d_geo = g.to(dev, non_blocking=True)
                    t1 = time.perf_counter()
                    out = program(d_img, *program_args(d_geo))
                    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                    h2d_s += t1 - t0
                    dispatch_s += time.perf_counter() - t1
                t_dispatch = t1 if t_dispatch is None else t_dispatch
                pinned.append(host)
                events.append(done)
                # the tensors live until the readback: the staging buffers
                # until the copies up end, the device ones until the copy
                # back does
                keep += [d_img, d_geo, out]
        peak = None
        if before is not None:
            peak = float(sum(torch.cuda.max_memory_allocated(d) - b
                             for d, b in zip(devices, before)))
        return _Launch(t_dispatch, h2d_s=h2d_s, dispatch_s=dispatch_s,
                       pinned=tuple(pinned), events=tuple(events), peak=peak,
                       keep=tuple(keep))

    @staticmethod
    def _read_back(launch: _Launch) -> np.ndarray:
        """The launch's host output; a sharded one's chunks in rank order."""
        if not launch.events:
            return launch.host
        for event in launch.events:
            event.synchronize()
        if len(launch.pinned) == 1:
            return launch.pinned[0].numpy()
        return np.concatenate([p.numpy() for p in launch.pinned])

    def _account(self, group: _Group, handle: ProgramHandle, batch: int, n: int,
                 device_s: float, first: bool, peak: Optional[float]) -> None:
        """After a completed readback: the handle is compiled from now on;
        the ledger's build record (the launch that claimed the build) and
        launch record, and the governor's lesson (the family's bytes per
        member from the ledger's peak; a clean launch at a ceiling counts
        toward its raise)."""
        handle.mark_compiled()
        key = handle.ledger_key
        if first:
            self._ledger.record_compile(
                key, descriptor=handle.descriptor,
                compile_s=device_s, peak_memory_bytes=peak,
            )
        self._ledger.record_launch(key, device_s=device_s, images=n)
        if self.governor is not None:
            self.governor.observe(group.base_key, batch, self._ledger.peak_memory(key))
            self.governor.record_success(group.base_key, n)

    def _run_members(self, group: _Group, members: List[_Pending]):
        """ONE synchronous recovery launch of ``members`` (assemble -> run
        -> read back), under a batch id of its own, recorded as a
        ``recovery`` launch; raises on failure, returns the outputs for
        ``_resolve_members``."""
        self._touch_busy()      # a recovery launch is progress
        seq = self._next_seq()
        n = len(members)
        queue_wait_s = time.monotonic() - min(m.enqueued_at for m in members)
        if group.runner is not None:
            t_aux = time.perf_counter()
            outputs = self._aux_launch(group, members, seq)
            aux_s = time.perf_counter() - t_aux
            self.metrics.record_batch_launch(
                self.name, images=n, capacity=n, queue_wait_s=queue_wait_s,
                device_s=aux_s, compile_hit=None,
                trace_id=self._member_trace_id(members), aux=True,
            )
            self._record_flight(group, members, n=n, batch=n, seq=seq,
                                queue_wait_s=queue_wait_s, device_s=aux_s,
                                kind="recovery")
            return outputs
        batch, images, geo, handle = self._prepare(group, members)
        key, compile_hit = handle.ledger_key, handle.is_compiled
        self.metrics.record_compile_event(compile_hit)
        measure = not compile_hit
        if measure:
            self._suspend_busy()
        self.launch_log.append(("transform", n, batch))
        poked = self._profiler_start()
        try:
            launch = self._launch(handle, images, geo, measure, seq)
            first = measure and handle.claim_build()
            faults.fire("batcher.drain", key=group.key, n=n, batch=batch,
                        device=str(self.device))
            t_sync = time.perf_counter()
            host = self._read_back(launch)
            sync_s = time.perf_counter() - t_sync
        finally:
            if poked:
                self.profiler.on_batch_end()
        device_s = time.perf_counter() - launch.t_dispatch
        self._touch_busy()
        self._account(group, handle, batch, n, device_s, first, launch.peak)
        mem_event = None
        if self.governor is not None and self.governor.has_ceiling(group.base_key):
            mem_event = "ceiling"
        self._observe_launch(
            group, members, seq=seq, n=n, batch=batch, queue_wait_s=queue_wait_s,
            key=key, h2d_s=launch.h2d_s, dispatch_s=launch.dispatch_s,
            sync_s=sync_s, device_s=device_s, compile_hit=compile_hit,
            kind="recovery", mem_event=mem_event,
        )
        if self.supervisor is not None:
            self.supervisor.record_batch_success()
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
        kind = classify_batch_error(exc)
        if self.supervisor is not None:
            # one outcome a failed launch: TRANSIENT ones make a storm
            self.supervisor.record_batch_failure(kind)
        span_obj = self._start_batch_span(
            "batch_recovery", len(live), len(live), live, self._batch_seq)
        if span_obj is not None:
            span_obj.set_attribute("recovery.error", type(exc).__name__)
            span_obj.set_attribute("recovery.class", kind)
        outer, self._tls.recovery_span = (
            getattr(self._tls, "recovery_span", None), span_obj)
        try:
            self._contain(group, live, exc, kind)
        finally:
            self._tls.recovery_span = outer
            if span_obj is not None:
                span_obj.end("ok" if all(
                    m.future.done() and m.future.exception() is None
                    for m in live) else "error")
                self._attach_batch_span(live, span_obj)

    def _contain(self, group: _Group, live: List[_Pending], exc: Exception,
                 kind: str) -> None:
        try:
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
            self.metrics.record_batch_retry()
            self._recovery_event("batch_retry", attempt=attempt,
                                 backoff_s=round(delay, 4),
                                 error=type(last).__name__)
            if delay > 0:
                self._retry_policy.sleep(delay)
            try:
                outputs = self._run_members(group, members)
            except Exception as exc:
                last = exc
                kind = classify_batch_error(exc)
                if self.supervisor is not None:
                    # each failed retry is storm evidence too
                    self.supervisor.record_batch_failure(kind)
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
        cap = None
        if self.governor is not None:
            cap = self.governor.record_oom(group.base_key, len(live))
        self._recovery_event("mem.ceiling", cap=cap, size=len(live),
                             error=type(exc).__name__)
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
        self._recovery_event("mem.split", size=len(members))
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
        self._recovery_event("batch_bisect", size=len(members))
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
            self.metrics.record_poison_isolated()
            if self.quarantine is not None and member.plan is not None:
                if member.fp_digest is None:
                    member.fp_digest = _image_digest(member.payload)
                self.quarantine.add((group.base_key, member.fp_digest))
            self._recovery_event("poison_isolated", error=type(exc).__name__,
                                 digest=member.fp_digest)
        if not member.future.done():
            member.future.set_exception(exc)
