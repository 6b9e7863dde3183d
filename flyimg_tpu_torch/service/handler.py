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
``gf_``. The fetch, the decode and the encode run on the host stage pools
when the server has them (``host_pipeline_*``). Not ported yet (ROADMAP):
the JPEG sampling factors nvJPEG lacks, CMYK JPEG (``clsp_CMYK``), signed
URLs and domain restrictions, brownout, derivative reuse and the fleet
tier.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import metadata
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    AppException,
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
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.runtime.hostpipeline import HostPipeline
from flyimg_tpu_torch.runtime.memgovernor import HostByteAccountant
from flyimg_tpu_torch.runtime.resilience import Deadline
from flyimg_tpu_torch.service.input_source import FetchPolicy, load_source
from flyimg_tpu_torch.service.output_image import OutputSpec, resolve_output
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import (
    TransformPlan,
    build_plan,
    decode_target_hint,
    parse_colorspace,
)
from flyimg_tpu_torch.storage.local import LocalStorage


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
    budget (503 + Retry-After past it)."""

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
    ) -> None:
        self.params = params or AppParameters()
        self.device = resolve_device(device)
        self.batcher = batcher
        self.sp_mesh = sp_mesh
        self.host_pipeline = host_pipeline
        # counterparts of the reference's flyimg_tiled_resamples_total,
        # flyimg_tiled_single_ops_total and flyimg_wedged_fallbacks_total
        # (the port has no metrics registry)
        self.tiled_resamples = 0
        self.tiled_single_ops = 0
        self.wedged_fallbacks = 0
        self._count_lock = threading.Lock()
        self._face_backend = face_backend
        self._face_lock = threading.Lock()
        self.storage = LocalStorage(self.params.by_key("upload_dir"))
        self.tmp_dir = self.params.by_key("tmp_dir")
        self.fetch_policy = FetchPolicy.from_params(self.params)
        self.default_deadline_s = float(self.params.by_key("request_deadline_s") or 0.0)
        self.device_result_timeout_s = float(self.params.by_key("device_result_timeout_s"))
        self.wedged_fallback = bool(self.params.by_key("wedged_executor_fallback", True))
        self.max_source_pixels = int(self.params.by_key("mem_max_source_pixels", 0) or 0)
        accountant = HostByteAccountant.from_params(self.params)
        self.mem_accountant = accountant if accountant.enabled else None
        self._flight = _SingleFlight()
        # a stable runner: the batcher groups aux work by runner identity
        self._smc_runner = partial(
            smartcrop.find_best_crops_batched, device=self.device
        )

    def process_image(
        self, options_str: str, image_src: str, *, accepts_webp: bool = False,
        deadline: Optional[Deadline] = None,
    ) -> ProcessedImage:
        """One image request (the reference handler's ``process_image``);
        ``accepts_webp``: the client's Accept header names image/webp, so
        ``o_auto`` answers WebP. ``deadline``: the request's budget, by
        default ``request_deadline_s`` from now."""
        if deadline is None:
            deadline = Deadline(self.default_deadline_s)
        timings: Dict[str, float] = {}
        options = OptionsBag(
            options_str,
            options_keys=self.params.by_key("options_keys"),
            default_options=self.params.by_key("default_options"),
            separator=self.params.by_key("options_separator", ","),
        )
        t = time.perf_counter()
        source = self._stage("fetch", lambda: load_source(
            image_src, options, self.tmp_dir,
            header_extra_options=self.params.by_key("header_extra_options", ""),
            policy=self.fetch_policy, deadline=deadline,
        ), deadline, inline_fallback=False)
        timings["fetch"] = time.perf_counter() - t
        spec = resolve_output(options, image_src, source.info.mime,
                              accepts_webp=accepts_webp)
        if parse_colorspace(options) == "cmyk":
            _require_cmyk_container(spec)
            raise UnsupportedMediaException(
                "clsp_CMYK (a CMYK JPEG output) is not ported to the PyTorch "
                "package yet"
            )
        if spec.extension not in _ENCODED:
            raise UnsupportedMediaException(
                f"{spec.extension} output is not ported to the PyTorch "
                "package yet (png, jpg, webp and gif only)"
            )
        # refused before decode and device work, as the output container is
        codecs.require_encodable(spec.extension,
                                 sampling_factor=_sampling_factor(options))
        refresh = options.wants_refresh()
        if refresh:
            self.storage.delete(spec.name)
        cached = None if refresh else self.storage.fetch(spec.name)
        if cached is not None and not _cache_entry_valid(cached[0], spec):
            self.storage.delete(spec.name)
            cached = None
        if cached is not None:
            content, mtime = cached
            return ProcessedImage(
                content=content, spec=spec, options=options,
                from_cache=True, timings=timings, modified_at=mtime,
            )

        leader, fut = self._flight.begin(spec.name)
        if not leader:
            # a generous multiple of one device wait: only a stuck leader
            # sheds its followers, and the follower's own budget caps it
            try:
                content, mtime = fut.result(
                    timeout=deadline.timeout(5 * self.device_result_timeout_s))
            except FutureTimeout:
                deadline.check("coalesced")
                raise ServiceUnavailableException(
                    "timed out waiting for the in-flight pipeline computing "
                    "this output") from None
            return ProcessedImage(
                content=content, spec=spec, options=options,
                timings=timings, modified_at=mtime,
            )
        try:
            content = self._process_admitted(
                source.data, source.info, options, spec, timings, deadline
            )
            t = time.perf_counter()
            mtime = self.storage.write(spec.name, content)
            timings["store"] = time.perf_counter() - t
        except BaseException as exc:
            self._flight.done(spec.name, exc=exc)
            raise
        self._flight.done(spec.name, result=(content, mtime))
        return ProcessedImage(
            content=content, spec=spec, options=options, timings=timings,
            modified_at=mtime,
        )

    def _faces(self):
        """The face backend, made on first use from ``face_backend`` /
        ``face_checkpoint`` (loading BlazeFace weights is not free)."""
        with self._face_lock:
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

    def _process_admitted(
        self, data: bytes, info, options: OptionsBag, spec: OutputSpec,
        timings: Dict[str, float], deadline: Deadline,
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
            return self._process_new(data, info, options, spec, timings, deadline)
        finally:
            if charge is not None:
                self.mem_accountant.release(charge)

    def _process_new(
        self, data: bytes, info, options: OptionsBag, spec: OutputSpec,
        timings: Dict[str, float], deadline: Deadline,
    ) -> bytes:
        deadline.check("decode")
        t = time.perf_counter()
        gif_frame = options.int_option("gif-frame", 0) or 0
        # a JPEG decodes prescaled toward the target box (DCT-domain scale)
        decoded = self._stage("decode", lambda: codecs.decode(
            data, target_hint=decode_target_hint(options), info=info,
            frame=gif_frame, device=self.device,
        ), deadline)
        anim = None
        if spec.is_gif and decoded.n_frames > 1:
            anim = self._stage("decode", lambda: codecs.decode_all(data, info), deadline)
        timings["decode"] = time.perf_counter() - t
        w, h = decoded.size
        plan = build_plan(options, w, h)
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
        # animation share launches of one program
        staged = []
        for idx, frame in enumerate(frames):
            fh, fw = frame.shape[:2]
            frame_plan = plan if (fw, fh) == plan.src_size else build_plan(options, fw, fh)
            if alpha_start is not None and idx >= alpha_start:
                frame_plan = replace(
                    frame_plan, colorspace=None, monochrome=False, unsharp=None,
                    sharpen=None, blur=None, background=(255, 255, 255),
                )
            with _device_failures("tiled transform"):
                tiled = self._tiled_or_none(frame, frame_plan)
            if tiled is not None:
                staged.append((tiled, frame, frame_plan))
            elif self.batcher is not None:
                staged.append((self.batcher.submit(frame, frame_plan), frame, frame_plan))
            else:
                staged.append((run_plan(frame, frame_plan, device=self.device),
                               frame, frame_plan))
        out_frames = [
            self._await(s, "transform", deadline,
                        partial(run_plan, f, fp, device=self.device))
            if isinstance(s, Future) else s
            for s, f, fp in staged
        ]
        timings["device"] = time.perf_counter() - t

        # post-passes in the reference's order: smart-crop, then the face
        # passes; none for a GIF answer
        out = out_frames[0]
        if plan.smart_crop and not spec.is_gif:
            t = time.perf_counter()
            item = smartcrop.prepare_work(out)
            if self.batcher is not None:
                crop = self._await(self.batcher.submit_aux(
                    ("smc", item.bucket, item.step), item, self._smc_runner,
                ), "smartcrop", deadline, lambda: self._smc_runner([item])[0])
            else:
                crop = self._smc_runner([item])[0]
            out = smartcrop.apply_crop(out, crop)
            timings["smartcrop"] = time.perf_counter() - t

        if (plan.face_blur or plan.face_crop) and not spec.is_gif:
            t = time.perf_counter()
            out = self._face_pass(out, plan, deadline)
            timings["faces"] = time.perf_counter() - t

        deadline.check("encode")
        t = time.perf_counter()
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
            content = self._stage("encode", lambda: self._encode(
                np.ascontiguousarray(out), spec, options, alpha), deadline)
            content = graft_metadata(content, data, decoded.mime, spec, options)
        timings["encode"] = time.perf_counter() - t
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

    def _encode(self, frame: np.ndarray, spec: OutputSpec, options: OptionsBag,
                alpha) -> bytes:
        """Encode a finished frame with the request's q_, moz_, sf_ and
        webpl_ (the reference handler's ``_encode_one``)."""
        return codecs.encode(
            frame, spec.extension, alpha,
            quality=options.int_option("quality", 90) or 90,
            webp_lossless=_webp_lossless(options),
            mozjpeg=str(options.get_option("mozjpeg")) == "1",
            sampling_factor=_sampling_factor(options),
            device=self.device,
        )

    def _count(self, name: str) -> None:
        with self._count_lock:
            setattr(self, name, getattr(self, name) + 1)

    def _tiled_or_none(self, frame: np.ndarray, plan: TransformPlan):
        """Run a spatially tiled program when one applies to a tall input:
        the halo-exchange resample for full-frame resample-only plans (the
        4k-thumbnail firehose), the ring rotate for rotate-only plans, the
        halo-exchange filter for single-filter plans. Anything else -> None
        (the batcher); every branch is an allowlist, so any new pixel op
        fails safe to the batcher. Only the tiling's infeasible-geometry
        error falls back; any other error is the device's, and raises."""
        if self.sp_mesh is None:
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
