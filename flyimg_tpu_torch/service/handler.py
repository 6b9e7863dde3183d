"""ImageHandler: the request pipeline of the PyTorch package.

The port of the miss path of ``flyimg_tpu/service/handler.py`` for the main
path: options parse -> source fetch -> output naming + cache check ->
decode -> plan -> batched device transform -> smart-crop post-pass -> face
post-passes (blur, then crop) -> encode -> store -> serve bytes. Concurrent
misses for one output name are coalesced so one render serves them all.

Every device stage of the reference's program runs here (resample, extent
pad, grayscale, monochrome, rotate, unsharp, sharpen, blur), and the face
options: detection through the ``face_backend`` parameter's backend
(models/faces.py), batched as an aux group where the backend has a batched
path; a detection that fails fails the request, never answering with the
faces unblurred. Not ported yet (ROADMAP): spatial tiling, codecs other
than PNG, signed URLs and domain restrictions, brownout, derivative reuse,
the fleet tier and metadata grafting.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    AppException,
    ExecFailedException,
    ServiceUnavailableException,
    UnsupportedMediaException,
)
from flyimg_tpu_torch.models import smartcrop
from flyimg_tpu_torch.models.faces import make_face_backend
from flyimg_tpu_torch.ops.compose import run_plan
from flyimg_tpu_torch.runtime.batcher import BatchController, classify_error
from flyimg_tpu_torch.service.input_source import load_source
from flyimg_tpu_torch.service.output_image import OutputSpec, resolve_output
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
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


def _cache_entry_valid(content: bytes, spec: OutputSpec) -> bool:
    """A stored PNG must at least carry its signature (a torn or damaged
    entry re-renders instead of serving garbage under image headers)."""
    return spec.extension != "png" or content[:8] == b"\x89PNG\r\n\x1a\n"


@contextmanager
def _device_failures(what: str):
    """Map a failure of device work to the HTTP layer's classes: an
    out-of-memory is capacity (503, Retry-After), not the request's fault;
    anything else fails the request naming ``what`` (500)."""
    try:
        yield
    except torch.OutOfMemoryError as exc:
        raise ServiceUnavailableException(
            f"device out of memory ({classify_error(exc)})"
        ) from exc
    except AppException:
        raise
    except Exception as exc:
        raise ExecFailedException(f"{what} failed: {exc}") from exc


class ImageHandler:
    """One per app. ``batcher`` None runs every transform as a batch-1
    program in the calling thread (``run_plan``)."""

    def __init__(
        self,
        params: Optional[AppParameters] = None,
        *,
        device: Union[str, torch.device] = "cuda",
        batcher: Optional[BatchController] = None,
        face_backend=None,
    ) -> None:
        self.params = params or AppParameters()
        self.device = resolve_device(device)
        self.batcher = batcher
        self._face_backend = face_backend
        self._face_lock = threading.Lock()
        self.storage = LocalStorage(self.params.by_key("upload_dir"))
        self.tmp_dir = self.params.by_key("tmp_dir")
        self._flight = _SingleFlight()
        # a stable runner: the batcher groups aux work by runner identity
        self._smc_runner = partial(
            smartcrop.find_best_crops_batched, device=self.device
        )

    def process_image(
        self, options_str: str, image_src: str, *, accepts_webp: bool = False
    ) -> ProcessedImage:
        timings: Dict[str, float] = {}
        options = OptionsBag(
            options_str,
            options_keys=self.params.by_key("options_keys"),
            default_options=self.params.by_key("default_options"),
            separator=self.params.by_key("options_separator", ","),
        )
        t = time.perf_counter()
        source = load_source(
            image_src, options, self.tmp_dir,
            header_extra_options=self.params.by_key("header_extra_options", ""),
        )
        timings["fetch"] = time.perf_counter() - t
        spec = resolve_output(
            options, image_src, source.info.mime, accepts_webp=accepts_webp
        )
        if spec.extension != "png":
            raise UnsupportedMediaException(
                f"{spec.extension} output is not ported to the PyTorch "
                "package yet (png only)"
            )
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
            content, mtime = fut.result()
            return ProcessedImage(
                content=content, spec=spec, options=options,
                timings=timings, modified_at=mtime,
            )
        try:
            content = self._process_new(source.data, options, spec, timings)
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

    def _await(self, fut: Future):
        with _device_failures("device transform"):
            return fut.result()

    def _process_new(
        self, data: bytes, options: OptionsBag, spec: OutputSpec,
        timings: Dict[str, float],
    ) -> bytes:
        t = time.perf_counter()
        decoded = codecs.decode(data)
        timings["decode"] = time.perf_counter() - t
        w, h = decoded.size
        plan = build_plan(options, w, h)
        spec.command_repr = repr(plan)

        # alpha survives only when no op changes geometry and the format
        # carries it; everywhere else flatten over the bg_ color (IM
        # flattens over -background)
        keeps_alpha = (
            decoded.alpha is not None
            and plan.resize_to is None and plan.extent is None
            and plan.extract is None and plan.rotate is None
            and not plan.smart_crop
            and not plan.face_blur and not plan.face_crop
            and spec.extension in ("png", "webp")
        )
        frame = decoded.rgb
        if decoded.alpha is not None and not keeps_alpha:
            a = decoded.alpha[..., None].astype(np.float32) / 255.0
            bg = np.asarray(plan.background or (255, 255, 255), np.float32)
            frame = np.round(
                frame.astype(np.float32) * a + bg * (1.0 - a)
            ).astype(np.uint8)

        t = time.perf_counter()
        if self.batcher is not None:
            out = self._await(self.batcher.submit(frame, plan))
        else:
            out = run_plan(frame, plan, device=self.device)
        timings["device"] = time.perf_counter() - t

        if plan.smart_crop:
            t = time.perf_counter()
            item = smartcrop.prepare_work(out)
            if self.batcher is not None:
                crop = self._await(self.batcher.submit_aux(
                    ("smc", item.bucket, item.step), item, self._smc_runner,
                ))
            else:
                crop = self._smc_runner([item])[0]
            out = smartcrop.apply_crop(out, crop)
            timings["smartcrop"] = time.perf_counter() - t

        if plan.face_blur or plan.face_crop:
            t = time.perf_counter()
            out = self._face_pass(out, plan)
            timings["faces"] = time.perf_counter() - t

        t = time.perf_counter()
        # attaching alpha to rgb that was already flattened over bg would
        # composite twice, and a plane of another size cannot be attached
        alpha = None
        if keeps_alpha and out.shape[:2] == decoded.alpha.shape:
            alpha = decoded.alpha
        content = codecs.encode(np.ascontiguousarray(out), spec.extension, alpha)
        timings["encode"] = time.perf_counter() - t
        return content

    def _face_pass(self, out: np.ndarray, plan) -> np.ndarray:
        """Detect faces on the output, then blur and/or crop; detection is
        one aux group per bucket when the backend batches."""
        ff = self._faces()
        with _device_failures("face-blur" if plan.face_blur else "face-crop"):
            if hasattr(ff, "prepare_face_work"):
                item = ff.prepare_face_work(out)
                if self.batcher is not None:
                    faces = self.batcher.submit_aux(
                        ("face", item.bucket), item, ff.detect_faces_batched,
                    ).result()
                else:
                    faces = ff.detect_faces_batched([item])[0]
            else:
                faces = ff.detect_faces(out)
            if plan.face_blur:
                out = ff.blur_faces(out, faces)
        if plan.face_crop:
            out = ff.crop_face(out, faces, plan.face_crop_position)
        return out
