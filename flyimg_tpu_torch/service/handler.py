"""ImageHandler: the request pipeline of the PyTorch package.

The port of the miss path of ``flyimg_tpu/service/handler.py`` for the main
path: options parse -> source fetch -> output naming + cache check ->
decode -> plan -> batched device transform -> smart-crop post-pass -> face
post-passes (blur, then crop) -> encode (with the source's metadata under
``st_0``) -> store -> serve bytes. Concurrent
misses for one output name are coalesced so one render serves them all.

Every device stage of the reference's program runs here (resample, extent
pad, grayscale, monochrome, rotate, unsharp, sharpen, blur), and the face
options: detection through the ``face_backend`` parameter's backend
(models/faces.py), batched as an aux group where the backend has a batched
path; a detection that fails fails the request, never answering with the
faces unblurred. A tall input (``TILE_MIN_ROWS`` rows or more) on a
handler with an ``sp_mesh`` takes the reference's spatially tiled route
instead of the batcher when its plan is exactly a full-frame resample, or
exactly one of rotate, blur, sharpen and unsharp (``parallel/tiling.py``).
Sources decode from PNG, JPEG, WebP (lossy, lossless, with alpha,
animated), GIF (still and animated), BMP, ICO and TIFF; answers encode to
PNG, JPEG (``q_``, ``moz_``, ``sf_``), WebP (lossy at ``q_``, lossless with
``webpl_1``) and GIF (codecs/); ``o_auto`` answers WebP to a client that
accepts it (``accepts_webp``), as the reference does. A GIF answer of an
animated source (GIF or WebP) keeps every frame: all frames are submitted
to the batcher before any wait, so one animation runs as batched launches
of the same kernels; a transparent animation's alpha planes ride as extra
frames under a geometry-only plan and are thresholded at 128 for the GIF's
transparent index. A still answer of an animated source renders frame
``gf_``. ``clsp_CMYK`` answers a CMYK JPEG. The fetch, the decode and the
encode run on the host stage pools when the server has them
(``host_pipeline_*``). Signed URLs and domain restrictions are checked
first, before any option is parsed (``service/security.py``), as the JAX
handler does.

Observability (the JAX handler's): the stages run in spans of the
request's trace (``fetch``, ``storage``, ``coalesced_wait``, ``decode``,
``batch_wait``, ``smartcrop``, ``faces``, ``encode``; the batchers attach
their shared launch spans under them), with ``cache.hit`` and
``cache.corrupt`` events, and every request records its cache outcome and
stage timings in the metrics registry (``flyimg_cache_total``,
``flyimg_stage_seconds``).

The JAX handler's opt-in modules, each off by default and then inert:

- brownout (``runtime/brownout.py``): at DEGRADED a cache hit past
  ``brownout_stale_ttl_s`` serves stale (``Warning: 110``,
  ``X-Flyimg-Degraded: stale``) while one background refresh re-renders it
  through the single-flight table; at BROWNOUT a miss renders
  ``degrade_plan``'s plan, the host entropy crop in place of the smart-crop
  scoring (K2 and K3 do not launch), the quality clamped to
  ``brownout_quality``, served direct and never stored; at SHED a miss
  answers 503 with Retry-After before any decode or launch (the output is
  named from the source, fetched first unless the origin cache or the
  variant index has it, as in the JAX handler);
- derivative reuse (``runtime/variantindex.py``): a miss whose source has a
  stored reuse-safe ancestor (``spec.plan.rewrite_for_reuse``) decodes and
  resamples the ancestor's bytes instead of fetching the origin, and a
  stored pure resample is recorded in the index (``reuse_hit`` stage,
  ``flyimg_reuse_hits_total{outcome}``);
- the device supervisor (``runtime/devicesupervisor.py``): while it holds
  the CPU failover every render runs on the CPU, is tagged
  ``X-Flyimg-Degraded: cpu-fallback`` and is never stored;
- telemetry (``runtime/telemetry.py``): each answer's outcome feeds the
  traffic-mix classifier;
- the cross-replica lease (``storage/tiered.py`` ``L2Lease``, on with
  ``l2_enable``): on a miss in both tiers the first replica leases the
  name in the shared L2 and renders; the others poll for its artifact at
  ``l2_lease_poll_ms`` (504 past their budget, 503 past
  ``l2_lease_wait_cap_s``), steal a lease that expired or was released
  without an artifact, and discard a torn artifact from both tiers to
  render it once the lease frees. ``rf_1`` skips the wait and still
  writes through. The lease is released however the render ends.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import jpeg_enc, metadata
from flyimg_tpu_torch.codecs.exif import jpeg_orientation
from flyimg_tpu_torch.codecs.sniff import JPEG_MIME
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    AppException,
    DeadlineExceededException,
    ExecFailedException,
    InvalidArgumentException,
    PayloadTooLargeException,
    ServiceUnavailableException,
    UnsupportedMediaException,
)
from flyimg_tpu_torch.models import smartcrop
from flyimg_tpu_torch.models.faces import make_face_backend
from flyimg_tpu_torch.ops.compose import plan_layout, run_plan
from flyimg_tpu_torch.parallel.mesh import Mesh
from flyimg_tpu_torch.parallel.tiling import (
    TilingInfeasible,
    tiled_filter,
    tiled_rotate,
    tiled_transform,
)
from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.runtime.hostpipeline import HostPipeline
from flyimg_tpu_torch.runtime.memgovernor import HostByteAccountant
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.runtime.resilience import Deadline
from flyimg_tpu_torch.runtime.variantindex import VariantFacts, VariantIndex
from flyimg_tpu_torch.service.input_source import FetchPolicy, load_source
from flyimg_tpu_torch.service.output_image import OutputSpec, resolve_output
from flyimg_tpu_torch.service.security import SecurityHandler
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import (
    TransformPlan,
    build_plan,
    decode_roi_window,
    decode_target_hint,
    degrade_plan,
    lossy_output,
    parse_colorspace,
    reuse_frame_key,
    rewrite_for_reuse,
)
from flyimg_tpu_torch.testing import faults
from flyimg_tpu_torch.storage import Storage, make_storage
from flyimg_tpu_torch.storage.tiered import L2Lease


class _SingleFlight:
    """Coalesce concurrent cache misses for one output name: the first
    thread in computes, followers wait on its future."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._inflight: Dict[str, Future] = {}

    def begin(self, key: str) -> Tuple[bool, Future]:
        with self._lock:
            fut = self._inflight.get(key)
            if fut is not None:
                return False, fut
            fut = self._inflight[key] = Future()
            return True, fut

    def done(self, key: str, result=None, exc: Optional[BaseException] = None):
        with self._lock:
            fut = self._inflight.pop(key, None)
        if fut is None:
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)


@dataclass
class ProcessedImage:
    """What a request resolves to."""

    content: bytes
    spec: OutputSpec
    options: OptionsBag
    from_cache: bool = False
    timings: Dict[str, float] = field(default_factory=dict)
    modified_at: Optional[float] = None
    degraded: Tuple[str, ...] = ()
    stale: bool = False
    #: the stored ancestor this render was derived from (reuse), else None
    reused_from: Optional[str] = None


_CPU = torch.device("cpu")

#: the outputs this package encodes, by extension
_ENCODED = {"png": "image/png", "jpg": "image/jpeg", "webp": "image/webp",
            "gif": "image/gif"}


def _cache_entry_valid(content: bytes, spec: OutputSpec) -> bool:
    """A stored entry must sniff as the container its name promises (a
    torn or damaged entry re-renders instead of serving garbage under image
    headers)."""
    return codecs.media_info(content).mime == _ENCODED.get(spec.extension)


def _require_cmyk_container(spec: OutputSpec) -> None:
    """The clsp_CMYK container rule: only JPEG stores CMYK samples, so any
    other output is refused before decode and device work."""
    if spec.extension not in ("jpg", "jpeg"):
        raise InvalidArgumentException(
            "clsp_CMYK requires a JPEG output container (o_jpg); "
            f"{spec.extension!r} cannot store CMYK samples"
        )


def graft_metadata(content: bytes, source: bytes, source_mime: str,
                   spec: OutputSpec, options: OptionsBag) -> bytes:
    """``st_0``: the reference keeps all source metadata when ``-strip`` is
    off, so the source's EXIF (orientation reset to 1: the pixels are
    upright), ICC profile and XMP go into a JPEG, PNG or WebP answer. Under
    ``clsp_CMYK`` the source's RGB profile is dropped (it must not describe
    CMYK samples); EXIF and XMP still carry."""
    if options.truthy("strip") or spec.extension not in ("jpg", "png", "webp"):
        return content
    meta = metadata.collect(source, source_mime)
    if meta and parse_colorspace(options) == "cmyk":
        meta.icc = None
    return metadata.inject(content, spec.extension, meta) if meta else content


def _webp_lossless(options: OptionsBag) -> bool:
    return bool(options.truthy("webp-lossless"))


def _sampling_factor(options: OptionsBag) -> str:
    return str(options.get_option("sampling-factor") or "1x1")


def _flatten(rgb: np.ndarray, alpha: np.ndarray, background) -> np.ndarray:
    """``rgb`` over the bg_ colour (white by default) through ``alpha``."""
    a = alpha[..., None].astype(np.float32) / 255.0
    bg = np.asarray(background or (255, 255, 255), np.float32)
    return np.round(rgb.astype(np.float32) * a + bg * (1.0 - a)).astype(np.uint8)


@contextmanager
def _device_failures(what: str):
    """Map a failure of device work to the HTTP layer's classes: an
    out-of-memory is capacity (503, Retry-After), not the request's fault;
    anything else fails the request naming ``what`` (500)."""
    try:
        yield
    except torch.OutOfMemoryError as exc:
        raise ServiceUnavailableException(f"device out of memory: {exc}") from exc
    except AppException:
        raise
    except Exception as exc:
        raise ExecFailedException(f"{what} failed: {exc}") from exc


class ImageHandler:
    """One per app. ``batcher`` None runs every transform as a batch-1
    program in the calling thread (``run_plan``). With ``sp_mesh`` (a mesh
    with an "sp" axis) tall inputs may take the tiled route.

    Every request has a ``Deadline`` (``request_deadline_s``; 0 is
    unbounded): the fetch, each wait on the device and the encode check
    it, and a spent budget answers 504. Each wait on the batcher's result
    (the transform, smart-crop scoring, face detection) is bounded by
    ``device_result_timeout_s`` too: past it the request runs the direct
    single-image program in its own thread, on the handler's device with
    the same kernels (``wedged_executor_fallback``, counted in
    ``wedged_fallbacks``), or answers 503 with that off; the launch runs on
    and its result is dropped.

    With a ``host_pipeline`` (runtime/hostpipeline.py, enabled) the fetch,
    the decode and the encode run on its stage pools: a stage that sheds
    answers its 503; a fetch that does not finish in time answers 503, a
    decode or an encode runs inline instead (counted as a wedge).

    A source whose header declares more than ``mem_max_source_pixels``
    pixels answers 413 before any decode. ``mem_host_budget_bytes`` > 0
    charges each decode's predicted bytes (w x h x 3) against a host
    budget (503 + Retry-After past it).

    ``metrics``: the server's registry (a private one by default);
    ``storage``: the output store (by default ``make_storage(params)``);
    ``brownout``, ``device_supervisor`` and ``telemetry``: the server's
    engines, or None (off). ``device`` is the device renders run on: the
    configured one, or the CPU while the supervisor holds a failover."""

    #: inputs at least this tall consider the spatially tiled programs
    TILE_MIN_ROWS = 2048

    def __init__(
        self,
        params: Optional[AppParameters] = None,
        *,
        device: Union[str, torch.device] = "cuda",
        batcher: Optional[BatchController] = None,
        face_backend=None,
        sp_mesh: Optional[Mesh] = None,
        host_pipeline: Optional[HostPipeline] = None,
        codec_batcher: Optional[BatchController] = None,
        metrics: Optional[MetricsRegistry] = None,
        storage: Optional[Storage] = None,
        brownout=None,
        device_supervisor=None,
        telemetry=None,
    ) -> None:
        self.params = params or AppParameters()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.security = SecurityHandler(self.params)
        self._device = resolve_device(device)
        self.brownout = brownout
        self.device_supervisor = device_supervisor
        self.telemetry = telemetry
        self.batcher = batcher
        self.codec_batcher = codec_batcher
        # ROI decode (the JAX package's decode_roi): crop/extract-dominant
        # plans decode only the source window they sample
        self.decode_roi = bool(self.params.by_key("decode_roi", True))
        self.sp_mesh = sp_mesh
        self.host_pipeline = host_pipeline
        self._face_backend = face_backend
        self._cpu_face_backend = None
        self._face_lock = threading.Lock()
        self.storage = (storage if storage is not None
                        else make_storage(self.params, metrics=self.metrics))
        # derivative reuse: inert (no lookup, no record, no manifest) off
        self.reuse_enable = bool(self.params.by_key("reuse_enable", False))
        self.reuse_min_scale = float(self.params.by_key("reuse_min_scale", 2.0))
        self.reuse_max_generations = int(self.params.by_key("reuse_max_generations", 1))
        self.reuse_degraded_min_scale = float(
            self.params.by_key("reuse_degraded_min_scale", 1.3))
        self.variants = VariantIndex.from_params(self.params, storage=self.storage.shared)
        # the cross-replica lease: None (l2_enable off) keeps the miss path
        self.l2lease = None
        if (bool(self.params.by_key("l2_enable", False))
                and bool(self.params.by_key("l2_lease_enable", True))):
            self.l2lease = L2Lease.from_params(self.params, storage=self.storage.shared)
        self.tmp_dir = self.params.by_key("tmp_dir")
        self.fetch_policy = FetchPolicy.from_params(self.params, metrics=self.metrics)
        self.default_deadline_s = float(self.params.by_key("request_deadline_s") or 0.0)
        self.device_result_timeout_s = float(self.params.by_key("device_result_timeout_s"))
        self.wedged_fallback = bool(self.params.by_key("wedged_executor_fallback", True))
        self.max_source_pixels = int(self.params.by_key("mem_max_source_pixels", 0) or 0)
        accountant = HostByteAccountant.from_params(self.params, metrics=self.metrics)
        self.mem_accountant = accountant if accountant.enabled else None
        self._flight = _SingleFlight()
        # stable runners: the batcher groups aux work by runner identity and
        # runs a runner bound to a device on its own device
        self._smc_runner = partial(
            smartcrop.find_best_crops_batched, device=self._device
        )
        self._jpeg_decode_runner = partial(codecs.batch_jpeg_decode, device=self._device)
        self._jpeg_encode_runner = partial(codecs.batch_jpeg_encode, device=self._device)

    @property
    def device(self) -> torch.device:
        """Where renders run now: the CPU while the device supervisor
        holds a failover, else the handler's device."""
        return _CPU if self._device_down() else self._device

    def _device_down(self) -> bool:
        sup = self.device_supervisor
        return sup is not None and sup.cpu_forced()

    def _direct(self, runner):
        """A device-bound runner called here (no batcher, or a wedged
        wait) on the current device."""
        if self._device_down():
            return partial(runner, device=_CPU)
        return runner

    def _record_mix(self, options: OptionsBag, image_src: str,
                    source_key: Optional[str], outcome: str) -> None:
        """One answer's outcome into the telemetry classifier (one check
        with telemetry off)."""
        if self.telemetry is None:
            return
        self.telemetry.record_request(
            options=options,
            source_key=source_key or OptionsBag.hash_original_image_url(image_src),
            outcome=outcome)

    # -- the counters of the JAX handler's families ------------------------

    _COUNTERS = {
        "tiled_resamples": (
            "flyimg_tiled_resamples_total",
            "Large inputs resampled via sp-axis spatial tiling"),
        "tiled_single_ops": (
            "flyimg_tiled_single_ops_total",
            "Tall single-op plans run via sp-axis tiling (ring rotate / "
            "halo conv)"),
        "wedged_fallbacks": (
            "flyimg_wedged_fallbacks_total",
            "Batched waits that timed out and ran the direct "
            "single-image path instead"),
    }

    def _count(self, name: str) -> None:
        family, help_text = self._COUNTERS[name]
        self.metrics.counter(family, help_text).inc()

    def _counted(self, name: str) -> int:
        family, help_text = self._COUNTERS[name]
        return int(self.metrics.counter(family, help_text).value)

    @property
    def tiled_resamples(self) -> int:
        return self._counted("tiled_resamples")

    @property
    def tiled_single_ops(self) -> int:
        return self._counted("tiled_single_ops")

    @property
    def wedged_fallbacks(self) -> int:
        return self._counted("wedged_fallbacks")

    def process_image(
        self, options_str: str, image_src: str, *, accepts_webp: bool = False,
        deadline: Optional[Deadline] = None,
    ) -> ProcessedImage:
        """One image request (the reference handler's ``process_image``);
        ``accepts_webp``: the client's Accept header names image/webp, so
        ``o_auto`` answers WebP. ``deadline``: the request's budget, by
        default ``request_deadline_s`` from now. A signed token is
        decrypted, and the source's domain checked, before anything else.
        With reuse on and the source indexed, the output is named, looked
        up and, where an ancestor is reuse-safe, rendered without touching
        the origin."""
        t0 = time.perf_counter()
        if deadline is None:
            deadline = Deadline(self.default_deadline_s, metrics=self.metrics)
        options_str, image_src = self.security.check_security_hash(
            options_str, image_src)
        self.security.check_restricted_domains(image_src)
        timings: Dict[str, float] = {}
        options = OptionsBag(
            options_str,
            options_keys=self.params.by_key("options_keys"),
            default_options=self.params.by_key("default_options"),
            separator=self.params.by_key("options_separator", ","),
        )
        refresh = options.wants_refresh()
        source_key = (OptionsBag.hash_original_image_url(image_src)
                      if self.reuse_enable else None)
        reuse_on = self.reuse_enable and not refresh
        reuse_entry = source = spec = None
        if reuse_on:
            reuse_entry = self.variants.lookup(source_key)
            if reuse_entry is not None and reuse_entry.source_mime:
                spec = resolve_output(options, image_src, reuse_entry.source_mime,
                                      accepts_webp=accepts_webp)
        if spec is None:
            source = self._load_source(image_src, options, timings, deadline)
            spec = resolve_output(options, image_src, source.info.mime,
                                  accepts_webp=accepts_webp)
        if parse_colorspace(options) == "cmyk":
            _require_cmyk_container(spec)
        if spec.extension not in _ENCODED:
            raise UnsupportedMediaException(
                f"{spec.extension} output is not ported to the PyTorch "
                "package yet (png, jpg, webp and gif only)"
            )
        # refused before decode and device work, as the output container is
        codecs.require_encodable(spec.extension,
                                 sampling_factor=_sampling_factor(options))
        if refresh:
            self.storage.delete(spec.name)
            if source_key is not None:
                self.variants.discard(source_key, spec.name)
        with tracing.span("storage", op="fetch"):
            cached = None if refresh else self.storage.fetch_hedged(spec.name)
        if cached is not None and not _cache_entry_valid(cached[0], spec):
            # a torn or damaged entry re-renders instead of serving garbage
            tracing.add_event("cache.corrupt", key=spec.name, bytes=len(cached[0]))
            self.metrics.record_cache_corrupt()
            self.storage.delete(spec.name)
            if source_key is not None:
                self.variants.discard(source_key, spec.name)
            cached = None
        engine = self.brownout
        if cached is not None:
            content, stat = cached
            tracing.add_event("cache.hit", key=spec.name)
            stale = self._stale_hit(spec, options, image_src, stat, source, reuse_entry)
            self.metrics.record_cache(hit=True)
            self.metrics.record_stage("cache_hit", time.perf_counter() - t0)
            self._record_mix(options, image_src, source_key, "stale" if stale else "hit")
            return ProcessedImage(
                content=content, spec=spec, options=options,
                from_cache=True, timings=timings, modified_at=stat.mtime, stale=stale,
            )
        if engine is not None and engine.shed_active():
            # SHED: a miss is refused before any decode or launch
            engine.record_degraded("shed")
            tracing.add_event("brownout.shed", key=spec.name)
            self._record_mix(options, image_src, source_key, "shed")
            exc = ServiceUnavailableException(
                "shedding cache-miss work under overload (brownout level "
                "shed); cached outputs still serve")
            exc.retry_after_s = max(1, int(engine.shed_retry_after_s))
            raise exc

        leader, fut = self._flight.begin(spec.name)
        if not leader:
            # a generous multiple of one device wait: only a stuck leader
            # sheds its followers, and the follower's own budget caps it
            try:
                with tracing.span("coalesced_wait", key=spec.name):
                    content, mtime, degraded = fut.result(
                        timeout=deadline.timeout(5 * self.device_result_timeout_s))
            except FutureTimeout:
                deadline.check("coalesced")
                raise ServiceUnavailableException(
                    "timed out waiting for the in-flight pipeline computing "
                    "this output") from None
            timings["coalesced"] = time.perf_counter() - t0
            timings["total"] = timings["coalesced"]
            # served without running a pipeline: a hit for the traffic
            # accounting, and the coalesce counter
            self.metrics.record_cache(hit=True)
            self.metrics.record_stage("coalesced", timings["coalesced"])
            self.metrics.counter(
                "flyimg_requests_coalesced_total",
                "Cache-miss requests served by an in-flight duplicate",
            ).inc()
            self._record_mix(options, image_src, source_key, "coalesced")
            return ProcessedImage(
                content=content, spec=spec, options=options,
                timings=timings, modified_at=mtime, degraded=degraded,
            )
        modes: List[str] = []
        reused = None
        lease_token: Optional[str] = None
        try:
            # the fleet's single flight: a follower serves the leader's
            # artifact here (no fetch, no decode, no launch) and settles its
            # own coalesced waiters with it; rf_1 renders without waiting
            if self.l2lease is not None and not refresh:
                verdict = self._l2_coalesce(spec, deadline)
                if verdict[0] == "serve":
                    _, content, mtime = verdict
                    self._flight.done(spec.name, result=(content, mtime, ()))
                    timings["l2_coalesced"] = time.perf_counter() - t0
                    timings["total"] = timings["l2_coalesced"]
                    self.metrics.record_cache(hit=True)
                    self.metrics.record_stage("l2_coalesced", timings["l2_coalesced"])
                    self._record_mix(options, image_src, source_key, "coalesced")
                    return ProcessedImage(
                        content=content, spec=spec, options=options,
                        from_cache=True, timings=timings, modified_at=mtime,
                    )
                lease_token = verdict[1]
            # BROWNOUT: the cheaper plan, the entropy crop, the quality clamp
            degrade = engine if engine is not None and engine.plan_degrade_active() else None
            content = None
            reuse_generation = 0
            render_info: Dict[str, object] = {}
            if reuse_on and not spec.is_gif:
                if reuse_entry is None:
                    self._record_reuse("miss")
                else:
                    hit = self._try_reuse(reuse_entry, options, spec, timings, deadline,
                                          degrade, modes, render_info)
                    if hit is not None:
                        content, reused, reuse_generation = hit
            if content is None:
                if source is None:
                    # no safe ancestor: the origin is fetched now, by the
                    # leader only
                    source = self._load_source(image_src, options, timings, deadline)
                render_info = {}
                content = self._process_admitted(
                    source.data, source.data_info, options, spec, timings, deadline,
                    degrade=degrade, degraded_out=modes, render_info=render_info)
            # checked again at write time: a failover in mid-render moved
            # the render to the CPU, and a CPU render must not be stored
            if self._device_down() and "cpu-fallback" not in modes:
                modes.append("cpu-fallback")
            if modes:
                # degraded answers are served direct, never stored
                mtime = None
                for mode in modes:
                    if engine is not None:
                        engine.record_degraded(mode)
                tracing.add_event("brownout.degraded_render", key=spec.name,
                                  modes=",".join(modes))
            else:
                t = time.perf_counter()
                with tracing.span("storage", op="write", bytes=len(content)):
                    mtime = self.storage.write(spec.name, content)
                timings["store"] = time.perf_counter() - t
                if source_key is not None:
                    self._record_variant(
                        source_key,
                        source.info.mime if source is not None else reuse_entry.source_mime,
                        spec, options, render_info, generations=reuse_generation,
                        ancestor=reused)
        except BaseException as exc:
            if lease_token is not None:
                # before the local waiters: a polling replica steals the
                # freed lease at once instead of waiting out its TTL
                self.l2lease.release(spec.name, lease_token)
            self._flight.done(spec.name, exc=exc)
            raise
        if lease_token is not None:
            # after the write, so a follower that sees the lease freed finds
            # the bytes (after a degraded, unstored render it renders itself)
            self.l2lease.release(spec.name, lease_token)
        self._flight.done(spec.name, result=(content, mtime, tuple(modes)))
        timings["total"] = time.perf_counter() - t0
        if reused is not None:
            timings["reuse_hit"] = timings["total"]
        self.metrics.record_cache(hit=False)
        for stage, seconds in timings.items():
            self.metrics.record_stage(stage, seconds)
        self._record_mix(options, image_src, source_key,
                         "degraded" if modes else "reuse" if reused is not None else "miss")
        return ProcessedImage(
            content=content, spec=spec, options=options, timings=timings,
            modified_at=mtime, degraded=tuple(modes),
            reused_from=reused.name if reused is not None else None,
        )

    # -- the cross-replica lease ------------------------------------------------

    def _l2_coalesce(self, spec: OutputSpec, deadline: Deadline):
        """This replica's part in a miss in both tiers: ``("lead", token)``
        when it renders (``token`` releases the lease after; None when the
        lease IO itself failed, and the render goes uncoalesced), or
        ``("serve", content, mtime)`` with a remote leader's artifact.

        A follower polls every ``l2_lease_poll_ms``, bounded by its budget
        (504) and by the wait cap (503). A lease that expired or was freed
        without an artifact (a crashed leader, a degraded render) is
        stolen. A torn artifact is discarded from both tiers and rendered
        here once the lease frees."""
        lease = self.l2lease
        with tracing.span("l2.lease", key=spec.name) as lease_span:
            token = lease.acquire(spec.name)
            if token is not None:
                # a previous leader may have stored the artifact after this
                # request's fetch missed and before its release let us in
                cached = self.storage.fetch_hedged(spec.name)
                if cached is not None and _cache_entry_valid(cached[0], spec):
                    lease.release(spec.name, token)
                    return self._lease_serve(lease_span, cached)
                self._lease_role(lease_span, "lead", "leader")
                tracing.add_event("l2.lease_acquired", key=spec.name)
                return ("lead", token)
            tracing.add_event("l2.lease_wait", key=spec.name,
                              holder=lease.holder(spec.name) or "")
            # a follower counts in lease.waiters, the brownout engine's
            # l2_lease pressure: a fleet-wide stampede parks them here
            lease.begin_wait()
            try:
                waited = 0.0
                while True:
                    deadline.check("l2_lease")
                    if waited >= lease.wait_cap_s:
                        self._lease_role(lease_span, "timeout", "timeout")
                        raise ServiceUnavailableException(
                            "timed out waiting for the fleet leader rendering "
                            "this output")
                    step = max(deadline.timeout(lease.poll_s) or lease.poll_s, 0.001)
                    lease._sleep(step)
                    waited += step
                    cached = self.storage.fetch_hedged(spec.name)
                    if cached is not None:
                        if _cache_entry_valid(cached[0], spec):
                            return self._lease_serve(lease_span, cached)
                        # torn under an active lease: it serves nowhere in
                        # the fleet, and renders here once the lease frees
                        tracing.add_event("cache.corrupt", key=spec.name,
                                          bytes=len(cached[0]))
                        self.metrics.record_cache_corrupt()
                        try:
                            self.storage.delete(spec.name)
                        except Exception:
                            pass
                    token = lease.acquire(spec.name)
                    if token is not None:
                        self._lease_role(lease_span, "steal", "steal")
                        tracing.add_event("l2.lease_steal", key=spec.name)
                        return ("lead", token)
            finally:
                lease.end_wait()

    def _lease_serve(self, span, cached):
        self._lease_role(span, "coalesced", "coalesced")
        return ("serve", cached[0], cached[1].mtime)

    def _lease_role(self, span, outcome: str, role: str) -> None:
        """One lease decision: ``flyimg_l2_lease_total{outcome}`` (lead |
        coalesced | steal | timeout) and the span's ``lease.role``."""
        self.metrics.counter(
            f'flyimg_l2_lease_total{{outcome="{outcome}"}}',
            "Cross-replica lease decisions on both-tier cache misses",
        ).inc()
        if span is not None:
            span.set_attribute("lease.role", role)

    # -- brownout -------------------------------------------------------------

    def _stale_hit(self, spec: OutputSpec, options: OptionsBag, image_src: str,
                   stat, source, reuse_entry) -> bool:
        """At DEGRADED and above a hit older than ``brownout_stale_ttl_s`` is
        stale: it serves now and one background refresh re-renders it (none
        at SHED)."""
        engine = self.brownout
        if (engine is None or not engine.swr_active() or stat.mtime is None
                or engine.stale_ttl_s <= 0
                or time.time() - stat.mtime <= engine.stale_ttl_s):
            return False
        engine.record_degraded("stale")
        tracing.add_event("brownout.stale_hit", key=spec.name,
                          age_s=round(time.time() - stat.mtime, 1))
        if not engine.shed_active():
            self._schedule_refresh(
                spec, options, source.data if source is not None else None, image_src,
                source.data_info if source is not None else None,
                source.info.mime if source is not None
                else reuse_entry.source_mime if reuse_entry is not None else "")
        return True

    def _schedule_refresh(self, spec: OutputSpec, options: OptionsBag,
                          data: Optional[bytes], image_src: str, info,
                          source_mime: str) -> None:
        """Queue ONE background re-render of a stale entry: the refresh queue
        coalesces by name, and the refresh itself goes through the
        single-flight table (so it coalesces with a foreground miss too). It
        renders at full quality whatever the level, with the default budget;
        without ``data`` (a stale hit off the reuse path) it fetches the
        source itself, on the background thread. Nothing runs during a CPU
        failover: the stale entry serves until the card is back."""

        def refresh() -> None:
            if self._device_down():
                return
            leader, _fut = self._flight.begin(spec.name)
            if not leader:
                return      # a foreground render is computing it
            try:
                deadline = Deadline(self.default_deadline_s, metrics=self.metrics)
                payload, payload_info, mime = data, info, source_mime
                if payload is None:
                    fetched = self._load_source(image_src, options, {}, deadline)
                    payload, payload_info = fetched.data, fetched.data_info
                    mime = fetched.info.mime
                render_info: Dict[str, object] = {}
                content = self._process_admitted(payload, payload_info, options, spec, {},
                                                 deadline, render_info=render_info)
                if self._device_down():
                    # failed over mid-refresh: the waiters get the bytes,
                    # the store does not
                    self._flight.done(spec.name, result=(content, None, ("cpu-fallback",)))
                    return
                mtime = self.storage.write(spec.name, content)
                if self.reuse_enable:
                    self._record_variant(OptionsBag.hash_original_image_url(image_src),
                                         mime, spec, options, render_info)
            except BaseException as exc:
                self._flight.done(spec.name, exc=exc)
                raise
            self._flight.done(spec.name, result=(content, mtime, ()))

        self.brownout.refresh.submit(spec.name, refresh)

    # -- derivative reuse -------------------------------------------------------

    def _try_reuse(self, entry, options: OptionsBag, spec: OutputSpec,
                   timings: Dict[str, float], deadline: Deadline, degrade,
                   degraded_out: List[str], render_info: Dict[str, object]):
        """Render this miss from a stored ancestor: candidates largest first,
        the first that ``rewrite_for_reuse`` accepts and whose bytes still
        read and decode wins. ``(content, ancestor facts, generations)``, or
        None with the outcome counted. At DEGRADED and above a nearer
        ancestor and one more lossy generation are accepted."""
        min_scale = self.reuse_min_scale
        max_generations = self.reuse_max_generations
        widened = False
        engine = self.brownout
        if engine is not None and engine.swr_active():
            widened = True
            min_scale = self.reuse_degraded_min_scale
            max_generations += 1
        reason = None
        for anc in entry.candidates():
            if anc.name == spec.name:
                continue
            plan, target_out, why = rewrite_for_reuse(
                options, spec.extension, anc,
                min_scale=min_scale, max_generations=max_generations)
            if plan is None:
                reason = why
                continue
            blob = self._fetch_ancestor(entry.source_key, anc)
            if blob is None:
                reason = "ancestor_gone"
                continue
            try:
                content = self._process_admitted(
                    blob, codecs.media_info(blob), options, spec, timings, deadline,
                    degrade=degrade, degraded_out=degraded_out, render_info=render_info)
            except DeadlineExceededException:
                raise
            except Exception:
                # a torn write can keep valid magic over a body that does
                # not decode: drop it, render from the source instead
                self.variants.discard(entry.source_key, anc.name)
                tracing.add_event("reuse.ancestor_invalid", ancestor=anc.name)
                reason = "ancestor_gone"
                continue
            scale = min(anc.out_w / max(target_out[0], 1), anc.out_h / max(target_out[1], 1))
            tracing.add_event("reuse.ancestor_hit", ancestor=anc.name,
                              scale=round(scale, 3), generations=anc.generations,
                              widened=widened)
            self._record_reuse("hit")
            generations = anc.generations + (1 if anc.lossy else 0)
            self.metrics.histogram(
                "flyimg_reuse_generations",
                "Lossy re-encode depth of reuse-rendered outputs",
                bounds=(0.5, 1.5, 2.5, 3.5),
            ).observe(float(generations))
            return content, anc, generations
        self._record_reuse("unsafe" if reason is not None else "miss")
        return None

    def _fetch_ancestor(self, source_key: str, anc) -> Optional[bytes]:
        """One candidate's bytes, or None (then dropped from the index) when
        they are gone or do not sniff as their container. The
        ``reuse.ancestor`` fault point may inject bytes or raise."""
        try:
            injected = faults.fire("reuse.ancestor", name=anc.name)
            if injected is not faults.PASS:
                blob = injected
            else:
                fetched = self.storage.fetch(anc.name)
                blob = fetched[0] if fetched is not None else None
        except Exception:
            blob = None
        expected = _ENCODED.get(anc.extension)
        if not blob or (expected is not None and codecs.media_info(blob).mime != expected):
            self.variants.discard(source_key, anc.name)
            return None
        return blob

    def _record_reuse(self, outcome: str) -> None:
        """One reuse decision of a miss: hit, unsafe or miss."""
        self.metrics.counter(
            f'flyimg_reuse_hits_total{{outcome="{outcome}"}}',
            "Cache-miss reuse-rewriter decisions by outcome",
        ).inc()

    def _record_variant(self, source_key: str, source_mime: str, spec: OutputSpec,
                        options: OptionsBag, render_info: Dict[str, object], *,
                        generations: int = 0, ancestor=None) -> None:
        """Index a rendition just stored when it is a pure full-frame
        resample; a reuse render carries its ancestor's true source size."""
        plan = render_info.get("plan")
        src_size = ((ancestor.src_w, ancestor.src_h) if ancestor is not None
                    else render_info.get("src_size"))
        if plan is None or src_size is None or spec.is_gif:
            return
        if spec.extension not in ("png", "jpg", "webp"):
            return
        pure = (
            plan.resize_to is not None and plan.extent is None
            and plan.extract is None and plan.rotate is None
            and plan.colorspace is None and not plan.monochrome
            and plan.unsharp is None and plan.sharpen is None and plan.blur is None
            and not plan.smart_crop and not plan.face_blur and not plan.face_crop
        )
        if not pure:
            return
        out_w, out_h = plan.resize_to
        self.variants.record(source_key, source_mime, VariantFacts(
            name=spec.name, out_w=out_w, out_h=out_h, extension=spec.extension,
            quality=options.int_option("quality", 90) or 90,
            lossy=lossy_output(spec.extension, options), pure=True,
            colorspace=None, monochrome=False, background=plan.background,
            generations=generations, src_w=int(src_size[0]), src_h=int(src_size[1]),
            frame_key=reuse_frame_key(options), stored_at=time.time(),
        ))

    def _load_source(self, image_src: str, options: OptionsBag,
                     timings: Dict[str, float], deadline: Deadline):
        """The origin fetch in its ``fetch`` span, on the fetch pool when
        the host pipeline is on."""
        t = time.perf_counter()

        def _fetch():
            with tracing.span("fetch") as fetch_span:
                source = load_source(
                    image_src, options, self.tmp_dir,
                    header_extra_options=self.params.by_key("header_extra_options", ""),
                    policy=self.fetch_policy, deadline=deadline, device=self.device,
                )
                if fetch_span is not None:
                    fetch_span.set_attribute("source.bytes", len(source.data))
                    fetch_span.set_attribute("source.mime", source.info.mime)
            return source

        source = self._stage("fetch", _fetch, deadline, inline_fallback=False)
        timings["fetch"] = time.perf_counter() - t
        return source

    def _faces(self):
        """The face backend, made on first use from ``face_backend`` /
        ``face_checkpoint`` (loading BlazeFace weights is not free); during a
        CPU failover a second one on the CPU."""
        with self._face_lock:
            if self._device_down():
                if self._cpu_face_backend is None:
                    self._cpu_face_backend = make_face_backend(
                        str(self.params.by_key("face_backend", "auto")),
                        self.params.by_key("face_checkpoint"),
                        device=_CPU,
                    )
                return self._cpu_face_backend
            if self._face_backend is None:
                self._face_backend = make_face_backend(
                    str(self.params.by_key("face_backend", "auto")),
                    self.params.by_key("face_checkpoint"),
                    device=self.device,
                )
            return self._face_backend

    def _record_wedge(self) -> None:
        """Every wedged-executor or wedged-stage fallback counts here."""
        self._count("wedged_fallbacks")

    def _stage(self, name: str, fn, deadline: Deadline, *,
               inline_fallback: bool = True):
        """Run one host stage on its pool when the host pipeline is on, else
        inline. A stage that does not finish within the device wait (a
        wedged or saturated pool) runs ``fn`` inline in this thread
        (``inline_fallback``, counted as a wedge) or answers 503; a pool's
        shed propagates its 503; an error of ``fn`` itself surfaces as is."""
        pipeline = self.host_pipeline
        if pipeline is None or not pipeline.enabled:
            return fn()
        try:
            return pipeline.run(
                name, fn, timeout=deadline.timeout(self.device_result_timeout_s))
        except (FutureTimeout, TimeoutError):
            # our wait ran out, or the pool failed the task (a wedged worker
            # abandoned by its heal, a pool closing)
            deadline.check(name)
            self._record_wedge()
            if inline_fallback:
                return fn()
            raise ServiceUnavailableException(
                f"host {name} stage did not produce a result in time") from None

    def _wait(self, fut: Future, stage: str, deadline: Deadline, direct):
        """A batched result, waited for at most ``device_result_timeout_s``
        and the request's remaining budget. A spent budget answers 504; past
        the device wait the executor is taken as wedged: ``direct()`` (the
        single-image program on this handler's device) answers in this
        thread, counted in ``wedged_fallbacks``, or, with
        ``wedged_executor_fallback`` off, 503."""
        try:
            return fut.result(timeout=deadline.timeout(self.device_result_timeout_s))
        except FutureTimeout:
            deadline.check(stage)
            if not self.wedged_fallback:
                raise ServiceUnavailableException(
                    f"the device executor did not produce the {stage} result "
                    "within device_result_timeout_s") from None
            self._record_wedge()
            return direct()

    def _await(self, fut: Future, stage: str, deadline: Deadline, direct):
        with _device_failures("device transform"):
            return self._wait(fut, stage, deadline, direct)

    def transform_bytes(
        self,
        data: bytes,
        options: OptionsBag,
        spec: OutputSpec,
        timings: Optional[Dict[str, float]] = None,
        *,
        deadline: Optional[Deadline] = None,
    ) -> bytes:
        """The entry of offline callers (the bulk runner): the cache-miss
        transform pipeline (decode, the device program, the smart-crop and
        face post-passes, the alpha flatten over bg_, the st_0 metadata
        graft, the encode) with no storage and no HTTP. Bulk and serving
        share this one path, so the same options give the same bytes in
        both."""
        return self._process_new(
            data, codecs.media_info(data), options, spec,
            {} if timings is None else timings,
            deadline if deadline is not None else Deadline(None))

    def _process_admitted(
        self, data: bytes, info, options: OptionsBag, spec: OutputSpec,
        timings: Dict[str, float], deadline: Deadline, *, degrade=None,
        degraded_out: Optional[List[str]] = None,
        render_info: Optional[Dict[str, object]] = None,
    ) -> bytes:
        """``_process_new`` under the host byte budget: the source's
        predicted decoded bytes are charged from its header before decode
        and released when the render ends, however it ends."""
        charge = None
        if info.width and info.height:
            pixels = int(info.width) * int(info.height)
            if 0 < self.max_source_pixels < pixels:
                raise PayloadTooLargeException(
                    f"source is {info.width}x{info.height} ({pixels} px), over "
                    f"the mem_max_source_pixels bound of {self.max_source_pixels}")
            if self.mem_accountant is not None:
                charge = self.mem_accountant.admit(pixels * 3)
        try:
            return self._process_new(data, info, options, spec, timings, deadline,
                                     degrade, degraded_out, render_info)
        finally:
            if charge is not None:
                self.mem_accountant.release(charge)

    def _roi_window(self, options: OptionsBag, info, hint, is_gif_out: bool):
        """The post-prescale source window this request's plan lets the
        decoder restrict itself to (``spec/plan.py decode_roi_window``), or
        None for a whole decode. The probe plan is built against the dims
        the prescaled decode WILL produce (libjpeg's ceil rule)."""
        if (info.mime != JPEG_MIME or not info.width or not info.height
                or is_gif_out):
            return None
        scale = codecs.jpeg_batch_scale_num(info, hint)
        sw = (info.width * scale + 7) // 8
        sh = (info.height * scale + 7) // 8
        try:
            probe_plan = build_plan(options, sw, sh)
        except Exception:
            # an invalid option raises identically in the real build_plan
            # below: the probe must not pre-empt that typed error
            return None
        return decode_roi_window(probe_plan)

    @staticmethod
    def _decode_mode(decoded, info, hint) -> str:
        """The decode mode (full | prescale | roi) of the JAX handler's
        per-mode stage timings."""
        if decoded.roi_offset is not None:
            return "roi"
        if info.mime == JPEG_MIME:
            w0, h0 = decoded.orig_size
            # EXIF orientation may have transposed the frame: only a dims
            # change beyond the swap means the DCT prescale ran
            if decoded.size not in ((w0, h0), (h0, w0)):
                return "prescale"
        return "full"

    def _decode_batched(self, data: bytes, hint, info, deadline: Deadline, roi=None):
        """A JPEG decode through the codec batcher: concurrent misses
        sharing a DCT prescale decode as ONE batch (host entropy decodes on
        threads, one K18 and one K19 launch); ``roi`` windows ride the same
        batch. None for everything the group does not cover (non-JPEG, no
        codec batcher, a member whose decode failed, a wedged group): the
        caller runs the single-image decode, which answers as this member
        alone would."""
        if self.codec_batcher is None or info.mime != JPEG_MIME:
            return None
        if roi is not None and jpeg_orientation(data) != 1:
            # the window would not survive the EXIF transpose
            roi = None
        scale = codecs.jpeg_batch_scale_num(info, hint)
        try:
            result = self.codec_batcher.submit_aux(
                ("jpegdec", scale), (data, scale, roi), self._jpeg_decode_runner,
            ).result(timeout=deadline.timeout(self.device_result_timeout_s))
        except FutureTimeout:
            deadline.check("decode")
            self._record_wedge()
            return None
        if result is None:
            return None
        if isinstance(result, tuple):
            window, offset, frame_size = result
            return codecs.DecodedImage(
                rgb=window, alpha=None, mime=JPEG_MIME,
                orig_size=(info.width or frame_size[0], info.height or frame_size[1]),
                roi_offset=offset, frame_size=frame_size,
            )
        return codecs.DecodedImage(
            rgb=result, alpha=None, mime=JPEG_MIME,
            orig_size=(info.width or result.shape[1], info.height or result.shape[0]),
        )

    def _process_new(
        self, data: bytes, info, options: OptionsBag, spec: OutputSpec,
        timings: Dict[str, float], deadline: Deadline, degrade=None,
        degraded_out: Optional[List[str]] = None,
        render_info: Optional[Dict[str, object]] = None,
    ) -> bytes:
        """The miss pipeline. ``render_info`` receives the plan and the
        decoded source size (what the variant index records); ``degrade``
        (the brownout engine at BROWNOUT) rewrites the plan and names what
        it dropped in ``degraded_out``, where a CPU failover adds
        ``cpu-fallback``."""
        deadline.check("decode")
        if (degraded_out is not None and self._device_down()
                and "cpu-fallback" not in degraded_out):
            degraded_out.append("cpu-fallback")
        t = time.perf_counter()
        gif_frame = options.int_option("gif-frame", 0) or 0
        # a JPEG decodes prescaled toward the target box (DCT-domain scale)
        hint = decode_target_hint(options)
        # ROI decode: a crop/extract-dominant plan decodes only the source
        # window its resample samples (+ tap margin), against the
        # post-prescale frame the decode will produce
        with tracing.span("decode") as decode_span:
            roi = (self._roi_window(options, info, hint, spec.is_gif)
                   if self.decode_roi else None)
            decoded = self._decode_batched(data, hint, info, deadline, roi=roi)
            batched_decode = decoded is not None
            if decoded is None:
                decoded = self._stage("decode", lambda: codecs.decode(
                    data, target_hint=hint, info=info, frame=gif_frame,
                    device=self.device, roi=roi,
                ), deadline)
            anim = None
            if spec.is_gif and decoded.n_frames > 1:
                anim = self._stage(
                    "decode", lambda: codecs.decode_all(data, info, self.device),
                    deadline)
            decode_mode = self._decode_mode(decoded, info, hint)
            if decode_span is not None:
                decode_span.set_attribute("decode.mime", info.mime)
                decode_span.set_attribute("decode.batched", batched_decode)
                decode_span.set_attribute("decode.mode", decode_mode)
        timings["decode"] = time.perf_counter() - t
        timings[f"decode_{decode_mode}"] = timings["decode"]
        self.metrics.counter(
            "flyimg_decode_bytes_total",
            "Compressed source bytes through the host decode stage",
        ).inc(len(data))
        self.metrics.counter(
            f'flyimg_decode_mode_total{{mode="{decode_mode}"}}',
            "Host decodes by mode (full | prescale | roi)",
        ).inc()
        w, h = decoded.size
        src_window = None
        if decoded.roi_offset is not None and decoded.frame_size is not None:
            # the pixels are a window: geometry resolves against the whole
            # (post-prescale) frame, the window's origin goes to the device
            # as a span shift
            w, h = decoded.frame_size
            src_window = decoded.roi_offset
        plan = build_plan(options, w, h, metrics=self.metrics)
        if render_info is not None:
            render_info["plan"] = plan
            render_info["src_size"] = (w, h)
        quality_cap = None
        if degrade is not None:
            plan, dropped = degrade_plan(plan)
            if degraded_out is not None:
                degraded_out.extend(dropped)
            # "quality" is named by the encode, where the clamp applies
            quality_cap = int(degrade.quality)
        spec.command_repr = repr(plan)

        frames = [decoded.rgb]
        alpha_start = None
        if anim is not None:
            frames = anim.frames
            if anim.alphas is not None:
                # a transparent animation: the colour frames flatten over
                # bg_ and the alpha planes follow as extra frames, under a
                # geometry-only plan (value ops would corrupt alpha, fills
                # would turn opaque)
                alpha_start = len(frames)
                frames = [_flatten(f, a, plan.background)
                          for f, a in zip(frames, anim.alphas)]
                frames += [np.repeat(a[..., None], 3, axis=2) for a in anim.alphas]

        # alpha survives only when no op changes geometry and the format
        # carries it; everywhere else flatten over the bg_ color (IM
        # flattens over -background)
        keeps_alpha = (
            decoded.alpha is not None
            and plan.resize_to is None and plan.extent is None
            and plan.extract is None and plan.rotate is None
            and not plan.smart_crop
            and not plan.face_blur and not plan.face_crop
            and anim is None
            and spec.extension in ("png", "webp")
        )
        if decoded.alpha is not None and not keeps_alpha and anim is None:
            frames = [_flatten(frames[0], decoded.alpha, plan.background)]

        t = time.perf_counter()
        # every frame is submitted before any wait, so the frames of one
        # animation share launches of one program; the submissions happen
        # inside the span, which the batcher makes the parent of the
        # shared launch span
        with tracing.span("batch_wait", frames=len(frames)):
            out_frames = self._transform_frames(
                frames, plan, options, src_window, anim, alpha_start, deadline,
                degrade is not None)
        timings["device"] = time.perf_counter() - t
        return self._finish_render(data, decoded, anim, alpha_start, plan, out_frames,
                                   keeps_alpha, options, spec, timings, deadline,
                                   degrade is not None, quality_cap, degraded_out)

    def _transform_frames(self, frames, plan, options, src_window, anim,
                          alpha_start, deadline: Deadline, degraded: bool = False):
        """Submit every frame (or run it tiled or direct), then wait for
        each: the transformed frames in order."""
        staged = []
        for idx, frame in enumerate(frames):
            fh, fw = frame.shape[:2]
            window = None
            if src_window is not None and anim is None:
                # a window decode: the plan stays built against the whole
                # frame and the window's origin shifts its spans
                frame_plan, window = plan, src_window
            elif (fw, fh) == plan.src_size:
                frame_plan = plan
            else:
                frame_plan = build_plan(options, fw, fh, metrics=self.metrics)
                if degraded:
                    # a frame of another size degrades as the first did
                    frame_plan, _ = degrade_plan(frame_plan)
            if alpha_start is not None and idx >= alpha_start:
                frame_plan = replace(
                    frame_plan, colorspace=None, monochrome=False, unsharp=None,
                    sharpen=None, blur=None, background=(255, 255, 255),
                )
            tiled = None
            if window is None:
                with _device_failures("tiled transform"):
                    tiled = self._tiled_or_none(frame, frame_plan)
            if tiled is not None:
                staged.append((tiled, frame, frame_plan, None))
            elif self.batcher is not None:
                staged.append((self.batcher.submit(frame, frame_plan, src_window=window),
                               frame, frame_plan, window))
            else:
                staged.append((run_plan(frame, frame_plan, window, device=self.device),
                               frame, frame_plan, window))
        return [
            self._await(s, "transform", deadline,
                        partial(run_plan, f, fp, win, device=self.device))
            if isinstance(s, Future) else s
            for s, f, fp, win in staged
        ]

    def _finish_render(self, data: bytes, decoded, anim, alpha_start, plan,
                       out_frames, keeps_alpha: bool, options: OptionsBag,
                       spec: OutputSpec, timings: Dict[str, float],
                       deadline: Deadline, degraded: bool = False,
                       quality_cap: Optional[int] = None,
                       degraded_out: Optional[List[str]] = None) -> bytes:
        """The post-passes in the reference's order (smart-crop, then the
        face passes; none for a GIF answer), then the encode. Degraded, the
        host entropy crop stands in for the smart-crop scoring."""
        out = out_frames[0]
        if plan.smart_crop and not spec.is_gif and degraded:
            t = time.perf_counter()
            with tracing.span("smartcrop", degraded=True):
                out = smartcrop.entropy_crop_image(out)
            if degraded_out is not None:
                degraded_out.append("smartcrop")
            timings["smartcrop"] = time.perf_counter() - t
        elif plan.smart_crop and not spec.is_gif:
            t = time.perf_counter()
            with tracing.span("smartcrop"):
                item = smartcrop.prepare_work(out)
                if self.batcher is not None:
                    crop = self._await(self.batcher.submit_aux(
                        ("smc", item.bucket, item.step), item, self._smc_runner,
                    ), "smartcrop", deadline, lambda: self._direct(self._smc_runner)([item])[0])
                else:
                    crop = self._direct(self._smc_runner)([item])[0]
                out = smartcrop.apply_crop(out, crop)
            timings["smartcrop"] = time.perf_counter() - t

        if (plan.face_blur or plan.face_crop) and not spec.is_gif:
            t = time.perf_counter()
            with tracing.span("faces"):
                out = self._face_pass(out, plan, deadline)
            timings["faces"] = time.perf_counter() - t

        deadline.check("encode")
        t = time.perf_counter()
        with tracing.span("encode", format=spec.extension) as encode_span:
            content = self._encode_answer(data, decoded, anim, alpha_start, out,
                                          out_frames, keeps_alpha, options, spec,
                                          deadline, quality_cap, degraded_out)
            if encode_span is not None:
                encode_span.set_attribute("encode.bytes", len(content))
        timings["encode"] = time.perf_counter() - t
        self.metrics.counter(
            "flyimg_encode_bytes_total",
            "Encoded output bytes through the host encode stage",
        ).inc(len(content))
        if options.wants_refresh():
            # the rf_1 debug header's `identify` line (reference
            # Response.php:62), from a probe of the encoded bytes
            info = codecs.media_info(content)
            fmt = spec.extension.upper().replace("JPG", "JPEG")
            spec.identify_repr = (
                f"{spec.name} {fmt} {info.width}x{info.height} "
                f"{info.width}x{info.height}+0+0 8-bit sRGB {len(content)}B"
            )
        return content

    def _encode_answer(self, data: bytes, decoded, anim, alpha_start, out,
                       out_frames, keeps_alpha: bool, options: OptionsBag,
                       spec: OutputSpec, deadline: Deadline,
                       quality_cap: Optional[int] = None,
                       degraded_out: Optional[List[str]] = None) -> bytes:
        if anim is not None:
            n = len(anim.frames)
            alphas = None
            if alpha_start is not None:
                # GIF transparency is binary: the transformed alpha planes
                # threshold at 128
                alphas = [np.where(a[..., 0] >= 128, 255, 0).astype(np.uint8)
                          for a in out_frames[n:]]
            colour = [np.ascontiguousarray(f) for f in out_frames[:n]]
            content = self._stage("encode", lambda: codecs.encode_animation(
                colour, alphas, anim.durations, anim.loop), deadline)
        else:
            # attaching alpha to rgb that was already flattened over bg
            # would composite twice, and a plane of another size cannot be
            # attached
            alpha = None
            if keeps_alpha and out.shape[:2] == decoded.alpha.shape:
                alpha = decoded.alpha
            quality = options.int_option("quality", 90) or 90
            if (quality_cap is not None and lossy_output(spec.extension, options)
                    and quality_cap < quality):
                # the brownout clamp, named where it applies: a lossless
                # answer keeps its bytes
                quality = quality_cap
                if degraded_out is not None:
                    degraded_out.append("quality")
            content = self._encode_grouped(out, spec, options, alpha, deadline, quality)
            if content is None:
                content = self._stage("encode", lambda: self._encode(
                    np.ascontiguousarray(out), spec, options, alpha, quality), deadline)
            content = graft_metadata(content, data, decoded.mime, spec, options)
        return content

    def _encode_grouped(self, frame: np.ndarray, spec: OutputSpec, options: OptionsBag,
                        alpha, deadline: Deadline, quality: int) -> Optional[bytes]:
        """A JPEG answer through the codec batcher's encode group
        ``("jpegenc", quality, sampling, mozjpeg)``: concurrent encodes at
        one setting share one kernel launch (``codecs.batch_jpeg_encode``),
        each member's bytes its single encode's. None where the group does
        not apply (no codec batcher, another format, ``clsp_CMYK``) or is
        wedged: the caller encodes alone."""
        if (self.codec_batcher is None or spec.extension != "jpg" or alpha is not None
                or parse_colorspace(options) == "cmyk"):
            return None
        mozjpeg = str(options.get_option("mozjpeg")) == "1"
        # the grammar is checked HERE so a bad sf_ raises in the request
        # thread (a typed 400), not inside the shared group runner
        sampling = codecs.parse_sampling_factor(_sampling_factor(options))
        try:
            return self.codec_batcher.submit_aux(
                ("jpegenc", quality, sampling, mozjpeg),
                (np.ascontiguousarray(frame), quality, sampling, mozjpeg),
                self._jpeg_encode_runner,
            ).result(timeout=deadline.timeout(self.device_result_timeout_s))
        except FutureTimeout:
            deadline.check("encode")
            self._record_wedge()  # a wedged codec group: the single encode
            return None

    def _encode(self, frame: np.ndarray, spec: OutputSpec, options: OptionsBag,
                alpha, quality: int) -> bytes:
        """Encode a finished frame with the request's q_, moz_, sf_ and
        webpl_ (the reference handler's ``_encode_one``). Under
        ``clsp_CMYK`` (a JPEG container: ``_require_cmyk_container`` ran
        before decode) the frame is stored as CMYK samples, its Huffman
        tables optimized under ``moz_1``; ``sf_`` is still parsed (a bad
        value is a 400) though the four components are not subsampled.
        ``quality``: q_, or the brownout clamp."""
        mozjpeg = str(options.get_option("mozjpeg")) == "1"
        if parse_colorspace(options) == "cmyk":
            _require_cmyk_container(spec)
            codecs.parse_sampling_factor(_sampling_factor(options))
            return jpeg_enc.encode_cmyk(frame, quality, mozjpeg, device=self.device)
        return codecs.encode(
            frame, spec.extension, alpha,
            quality=quality,
            webp_lossless=_webp_lossless(options),
            mozjpeg=mozjpeg,
            sampling_factor=_sampling_factor(options),
            device=self.device,
        )

    def _tiled_or_none(self, frame: np.ndarray, plan: TransformPlan):
        """Run a spatially tiled program when one applies to a tall input:
        the halo-exchange resample for full-frame resample-only plans (the
        4k-thumbnail firehose), the ring rotate for rotate-only plans, the
        halo-exchange filter for single-filter plans. Anything else -> None
        (the batcher); every branch is an allowlist, so any new pixel op
        fails safe to the batcher. Only the tiling's infeasible-geometry
        error falls back; any other error is the device's, and raises."""
        if self.sp_mesh is None or self._device_down():
            return None
        single = self._tiled_single_op_or_none(frame, plan)
        if single is not None:
            return single
        if plan.resize_to is None:
            return None
        # allowlist, not denylist: the device plan must be EXACTLY a bare
        # resample
        bare = TransformPlan(
            src_size=(0, 0), resize_to=None, extent=None,
            filter_method=plan.filter_method,
        )
        if plan.device_plan() != bare:
            return None
        h, w = frame.shape[:2]
        if h < self.TILE_MIN_ROWS:
            return None
        # the layout covers crop windows, extent pads and extract offsets
        # in one form: the span must be the full frame
        layout = plan_layout(plan)
        out_h, out_w = layout.resample_out
        if (
            layout.out_true != (out_h, out_w)
            or layout.pad_canvas is not None
            or layout.span_y != (0.0, float(h))
            or layout.span_x != (0.0, float(w))
        ):
            return None
        try:
            out = tiled_transform(
                torch.from_numpy(frame), (out_h, out_w), self.sp_mesh,
                method=plan.filter_method, out_u8=True,
            )
        except TilingInfeasible:
            # the halo would exceed a tile -> batcher
            return None
        self._count("tiled_resamples")
        return out.cpu().numpy()

    def _tiled_single_op_or_none(self, frame: np.ndarray, plan: TransformPlan):
        """Tiled execution for tall single-op plans: EXACTLY one of rotate /
        blur / sharpen / unsharp and nothing else (no geometry change, no
        colour ops, no extract)."""
        if frame.shape[0] < self.TILE_MIN_ROWS:
            return None
        # extract must fail safe here explicitly: device_plan() zeroes the
        # extract field, so the comparison below cannot see it
        if (
            plan.resize_to is not None
            or plan.extent is not None
            or plan.extract is not None
        ):
            return None
        ops_set = [
            name for name in ("rotate", "blur", "sharpen", "unsharp")
            if getattr(plan, name) is not None
        ]
        if len(ops_set) != 1:
            return None
        # the device plan must be EXACTLY bare + this one op (+ background,
        # which only rotate reads when extent is None)
        op = ops_set[0]
        dp = plan.device_plan()
        bare = TransformPlan(
            src_size=(0, 0), resize_to=None, extent=None,
            filter_method=plan.filter_method,
        )
        if dp != replace(bare, background=dp.background, **{op: getattr(dp, op)}):
            return None
        x = torch.from_numpy(frame)
        try:
            if op == "rotate":
                out = tiled_rotate(x, float(plan.rotate), self.sp_mesh,
                                   background=plan.background, out_u8=True)
            elif op == "blur":
                r, s = plan.blur
                out = tiled_filter(x, self.sp_mesh, "blur", r, s, out_u8=True)
            elif op == "sharpen":
                r, s, _, _ = plan.sharpen
                out = tiled_filter(x, self.sp_mesh, "sharpen", r, s, out_u8=True)
            else:
                r, s, gain, thr = plan.unsharp
                out = tiled_filter(x, self.sp_mesh, "unsharp", r, s, gain=gain,
                                   threshold=thr, out_u8=True)
        except TilingInfeasible:
            # the halo or kernel would exceed a tile -> batcher
            return None
        self._count("tiled_single_ops")
        return out.cpu().numpy()

    def _face_pass(self, out: np.ndarray, plan, deadline: Deadline) -> np.ndarray:
        """Detect faces on the output, then blur and/or crop; detection is
        one aux group per bucket when the backend batches."""
        ff = self._faces()
        with _device_failures("face-blur" if plan.face_blur else "face-crop"):
            if hasattr(ff, "prepare_face_work"):
                item = ff.prepare_face_work(out)
                if self.batcher is not None:
                    faces = self._wait(self.batcher.submit_aux(
                        ("face", item.bucket), item, ff.detect_faces_batched,
                    ), "faces", deadline, lambda: ff.detect_faces_batched([item])[0])
                else:
                    faces = ff.detect_faces_batched([item])[0]
            else:
                faces = ff.detect_faces(out)
            if plan.face_blur:
                out = ff.blur_faces(out, faces)
        if plan.face_crop:
            out = ff.crop_face(out, faces, plan.face_crop_position)
        return out
