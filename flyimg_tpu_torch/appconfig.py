"""Server parameters: the keys this package reads, with the JAX package's
defaults, loaded from a dict or a JSON file (no YAML dependency)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from flyimg_tpu_torch.spec.options import DEFAULT_OPTIONS, OPTIONS_KEYS

SERVER_DEFAULTS: Dict[str, Any] = {
    "application_name": "flyimg-tpu",
    "header_cache_days": 365,
    "options_separator": ",",
    "header_extra_options": (
        "User-Agent: Mozilla/5.0 (Windows; U; Windows NT 6.1; rv:2.2) "
        "Gecko/20110201"
    ),
    "options_keys": dict(OPTIONS_KEYS),
    "default_options": dict(DEFAULT_OPTIONS),
    "upload_dir": "web/uploads",
    "tmp_dir": "var/tmp",
    "batch_max_size": 64,
    "batch_deadline_ms": 4.0,
    # launches between dispatch and completed readback (2: the next launch
    # is dispatched while the last one reads back; 1: launch, read, launch)
    "batch_pipeline_depth": 2,
    # the codec batcher (a second BatchController): concurrent JPEG decodes
    # at one DCT scale, and JPEG encodes at one setting, share one launch
    # of the codec kernels; pending submissions before a 503 (0 =
    # unbounded)
    "decode_batch_max": 32,
    "decode_deadline_ms": 1.0,
    "decode_max_queue_depth": 0,
    # ROI decode: crop/extract-dominant plans decode only the source
    # window they sample (spec/plan.py decode_roi_window)
    "decode_roi": True,
    # the host stage pools (runtime/hostpipeline.py): bounded fetch, decode
    # and encode workers, each stage shedding 503 past workers + queue
    # depth pending; a worker in one task longer than the wedge timeout is
    # replaced (0 turns that check off). Off: every stage runs inline in
    # the request's thread
    "host_pipeline_enable": True,
    "host_pipeline_fetch_workers": 4,
    "host_pipeline_decode_workers": 2,
    "host_pipeline_encode_workers": 2,
    "host_pipeline_queue_depth": 16,
    "host_pipeline_wedge_timeout_s": 60.0,
    # dense | banded | auto (ops/resample.py); the env var seeds it as in
    # the JAX package
    "resample_kernel": os.environ.get("FLYIMG_RESAMPLE_KERNEL", "dense"),
    # auto | haar | blazeface | facefind | none (models/faces.py)
    "face_backend": "auto",
    # an .npz of BlazeFace weights (tools/export_blazeface_npz.py); None
    # is the packaged one
    "face_checkpoint": None,
    # resilience (runtime/resilience.py, service/input_source.py): a
    # request's budget (0 = unbounded), the bound of one wait on a device
    # result, fetch retries and per-host breakers
    "request_deadline_s": 0.0,
    "device_result_timeout_s": 120.0,
    # past device_result_timeout_s a request answers from the direct
    # single-image program on its own device (counted in the handler's
    # wedged_fallbacks), or 503 with this off
    "wedged_executor_fallback": True,
    "fetch_read_timeout_s": 10.0,
    "retry_max_attempts": 3,
    "retry_base_backoff_s": 0.05,
    "retry_max_backoff_s": 2.0,
    "breaker_failure_threshold": 5,
    "breaker_recovery_s": 10.0,
    # the batcher's containment (runtime/batcher.py): pending submissions
    # before a 503 (0 = unbounded) and its Retry-After, whole-batch retries
    # of a transient failure, bisection of a poison member (and the
    # halving of an out-of-memory batch), the quarantine's TTL (0 = off)
    "batch_max_queue_depth": 0,
    "shed_retry_after_s": 1.0,
    "resilience_batch_retries": 2,
    "resilience_bisect_enable": True,
    "resilience_quarantine_ttl": 300.0,
    # an executor in one batch longer than this without progress is
    # replaced at the next submission (0: only a dead one is)
    "resilience_executor_wedge_timeout_s": 60.0,
    # the memory governor (runtime/memgovernor.py), off by default
    "mem_governor_enable": False,
    "mem_device_budget_bytes": 0,
    "mem_heuristic_bytes_per_pixel": 64.0,
    "mem_ceiling_ttl_s": 300.0,
    "mem_probe_successes": 4,
    "mem_probe_step": 1,
    "mem_host_budget_bytes": 0,
    # source guards: the most bytes a fetch reads, and the most pixels a
    # source's header may declare (413 before any decode; also the JPEG
    # decoder's limit; 0 or less keeps the codec's default)
    "mem_max_source_bytes": 256 * 1024 * 1024,
    "mem_max_source_pixels": 512 * 1024 * 1024,
    # a flyimg_tpu_torch.testing.faults.FaultInjector the server installs
    # (tests only)
    "fault_injector": None,
}


class AppParameters:
    """Defaults overlaid with the given parameters."""

    def __init__(self, params: Optional[Dict[str, Any]] = None) -> None:
        self.params: Dict[str, Any] = dict(SERVER_DEFAULTS)
        if params:
            self.params.update(params)

    @classmethod
    def from_json(cls, path: str) -> "AppParameters":
        with open(path, "r", encoding="utf-8") as fh:
            return cls(json.load(fh) or {})

    def by_key(self, key: str, default: Any = None) -> Any:
        return self.params.get(key, default)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.params)
