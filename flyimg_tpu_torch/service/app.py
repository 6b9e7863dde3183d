"""HTTP service of the PyTorch package, on the standard library.

The port of ``flyimg_tpu/service/app.py``: a ``ThreadingHTTPServer`` with
the reference's routes

- ``GET /upload/{options}/{imageSrc}``: render (or serve from the output
  cache) and answer the image bytes with the reference's headers; ``o_auto``
  answers WebP when the request's Accept header names image/webp;
- ``GET /path/{options}/{imageSrc}``: render the same way and answer the
  stored file's public URL (``HOSTNAME_URL`` or the request's host, then
  ``/uploads/<name>``);
- ``GET /``: the homepage;

(the two pipeline patterns can be renamed under the ``routes`` parameter,
checked when the server is made), with signed URLs and domain restrictions
(``security_key``, ``restricted_domains``) checked by the handler, and the
operations surface

- ``GET /healthz`` (liveness and the device it serves on) and ``GET
  /readyz`` (readiness: 503 from the moment a drain begins);
- ``GET /metrics``: Prometheus text, or OpenMetrics with exemplars for a
  scrape that accepts it;
- debug-gated (the ``debug`` parameter): ``/debug/trace?ms=`` (a
  wall-clock torch.profiler capture) and ``/debug/traces[/{id}]`` answer
  403 with debug off; ``/debug/slo``, ``/debug/perf``, ``/debug/plans``,
  ``/debug/flightrecorder``, ``/debug/profile`` (GET the state, POST
  ``?batches=N`` to arm a batch-scoped capture, GET
  ``/debug/profile/captures/{name}`` for its tar.gz), ``/debug/memory``,
  ``/debug/brownout`` (the level, the pressure and its components),
  ``/debug/device`` (the device supervisor's state),
  ``/debug/telemetry`` (the mix classifier and the archive),
  ``/debug/autotune`` (the autotuner's policy, envelopes and history),
  ``/debug/fleet`` (membership and warm start), ``/debug/fleet/status``
  (the observatory, membership and the router's peer health), ``POST
  /debug/fleet/replicas`` (swap the routing set; refused while membership
  owns it) and ``/debug/tier`` (the tier supervisor) answer 404.

With more than one local card the transform batcher shards every launch
over a ``data`` mesh of them (``local_data_mesh``, beside the tiling mesh
``local_sp_mesh``): the device supervisor's re-promotion rebuilds it and
warm start seeds sharded programs against it. With one card nothing
changes.

The JAX app's opt-in modules are made and wired as it makes them, each off
by default: the brownout engine (its level evaluated on every pipeline
request, stamped into flight records, an escalation dumping the flight
recorder), the device supervisor (fed by the transform batcher, failing
both controllers over to the CPU), the telemetry pipeline (its beat on the
request path, the flight recorder's dumps under its retention) and the
handler's variant index (``flyimg_variant_index_entries``), the policy
autotuner (its step on every pipeline request, bound to both controllers'
live policy, the host pools, the reuse min-scale and the band fraction)
and warm start (the program cache and the policy seeded from the store's
manifests before the first request, published after the drains). The
program caches are read by ``flyimg_program_cache_entries`` and
``/debug/plans``'s ``program_cache``.

The fleet tier (docs/fleet.md), off by default, boots in the JAX app's
order: the store (tiered over the shared L2 with ``l2_enable``), the tier
supervisor, the handler's lease, warm start on ``storage.shared``,
membership and the observatory. With ``fleet_replicas`` set an ``/upload``
request is routed to its rendezvous owner (``_route_fleet``): proxied one
hop with ``fleet_route`` proxy (``X-Flyimg-Fleet-Hop``; a dead owner or
its 5xx falls back to a render here, its 4xx is relayed), rendered here
under ``local``. With ``debug`` on, each pipeline answer this replica
produced carries ``X-Flyimg-Replica``. ``serve`` re-reads the params file's
``fleet_replicas`` on SIGHUP where the platform has it.

``HEAD`` answers any GET route with the GET's status and headers, no body.
Every request passes one observability choke point (``_RequestHandler.
_serve``): the route's logical name, a trace minted or adopted
(``traceparent``) for ``upload`` and ``path``, the in-flight gauge,
``flyimg_requests_total`` and the SLO record, ``traceparent`` echoed on the
answer, ``Server-Timing`` with ``debug`` on, and the JSON access log
(``log_access``).

Errors map to the status codes of the JAX app's ``_error_response``; a plan
stage the port does not carry yet answers 501, and any other exception 500.
A 503 carries Retry-After. ``server_close`` drains: readiness answers 503
first, while the server still serves, then the batchers and the host pools
finish their work within ``shutdown_drain_timeout_s``, and warm start
publishes its manifests. Run it with

    python -m flyimg_tpu_torch.service.app serve --port 8080 [--params p.json]
    python -m flyimg_tpu_torch.service.app encrypt '<options>/<imageSrc>' --params p.json
    python -m flyimg_tpu_torch.service.app prune --max-bytes N [--params p.json]
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import logging
import os
import re
import signal
import sys
import tarfile
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import native_codec
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.exceptions import (
    AppException,
    DeadlineExceededException,
    ExecFailedException,
    InvalidArgumentException,
    MissingParamsException,
    NotPortedException,
    OriginUnavailableException,
    PayloadTooLargeException,
    ReadFileException,
    SecurityException,
    ServiceUnavailableException,
    UnsupportedMediaException,
)
from flyimg_tpu_torch.ops.compose import program_cache_entries, program_cache_info
from flyimg_tpu_torch.ops.resample import set_auto_band_frac, set_kernel_mode
from flyimg_tpu_torch.parallel.mesh import Mesh, local_devices, make_mesh
from flyimg_tpu_torch.runtime import tracing, warmstart
from flyimg_tpu_torch.runtime.autotuner import PolicyAutotuner, reuse_signal_fn
from flyimg_tpu_torch.runtime.batcher import BatchController, containment_params
from flyimg_tpu_torch.runtime.brownout import BrownoutEngine
from flyimg_tpu_torch.runtime.costledger import get_ledger
from flyimg_tpu_torch.runtime.devicesupervisor import DeviceSupervisor
from flyimg_tpu_torch.runtime.fleet import HOP_HEADER, FleetRouter, route_key
from flyimg_tpu_torch.runtime.flightrecorder import FlightRecorder
from flyimg_tpu_torch.runtime.hostpipeline import HostPipeline
from flyimg_tpu_torch.runtime.logging import access_log, configure_logging
from flyimg_tpu_torch.runtime.membership import FleetMembership
from flyimg_tpu_torch.runtime.memgovernor import (
    HostByteAccountant,
    MemoryGovernor,
    RssWatchdog,
)
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.runtime.observatory import FleetObservatory
from flyimg_tpu_torch.runtime.profiling import DeviceProfiler, ProfilerSession
from flyimg_tpu_torch.runtime.resilience import Deadline
from flyimg_tpu_torch.runtime.slo import SloEngine
from flyimg_tpu_torch.runtime.telemetry import TelemetryPipeline
from flyimg_tpu_torch.runtime.tiersupervisor import TierSupervisor
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.service.response import (
    NOT_MODIFIED_HEADERS,
    image_headers,
    is_not_modified,
)
from flyimg_tpu_torch.storage import make_storage
from flyimg_tpu_torch.testing import faults

_ERROR_STATUS = {
    SecurityException: 403,
    ReadFileException: 404,
    InvalidArgumentException: 400,
    UnsupportedMediaException: 415,
    DeadlineExceededException: 504,
    OriginUnavailableException: 502,
    ServiceUnavailableException: 503,
    PayloadTooLargeException: 413,
    NotPortedException: 501,
    ExecFailedException: 500,
    MissingParamsException: 500,
}

#: the pipeline routes' default patterns (reference config/routes.yml);
#: ``routes`` overrides them by name
DEFAULT_ROUTES = {
    "upload": "/upload/{options}/{imageSrc:.+}",
    "path": "/path/{options}/{imageSrc:.+}",
}

# the pipeline routes get a trace; probes and scrapes would only fill the
# ring
_TRACED_ROUTES = frozenset(("upload", "path"))

_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json; charset=utf-8"
_DEBUG_OFF = "debug disabled (set debug: true in params)"

HOMEPAGE = """<!doctype html>
<html><head><title>flyimg-tpu</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 46em; margin: 3em auto;
        line-height: 1.5; padding: 0 1em; }
 code { background: #f3f3f3; padding: .1em .3em; border-radius: 3px; }
 input { font: inherit; padding: .3em; width: 100%; box-sizing: border-box; }
 label { font-size: .85em; color: #555; }
 img.demo { max-width: 100%; border: 1px solid #ddd; margin-top: 1em; }
 footer { margin-top: 2em; font-size: .85em; color: #777; }
</style></head>
<body>
<h1>flyimg-tpu</h1>
<p>On-the-fly image resizing, cropping and compression behind a
flyimg-compatible URL API. This server is the PyTorch port: its pixel
pipeline runs as batched CUDA kernels written for the GPU (resampling,
smart-crop saliency, JPEG decode and encode), with the host stages beside
them.</p>
<p>Usage: <code>GET /upload/{options}/{image-url}</code>, e.g.
<code>/upload/w_300,h_250,c_1/https://example.com/image.jpg</code>, or
<code>GET /path/{options}/{image-url}</code> for the stored file's URL.</p>
<label>options</label><input id="opts" value="w_300,h_250,c_1">
<label>image URL</label><input id="src" value="">
<p><button onclick="go()">transform</button> <code id="url"></code></p>
<img id="out" class="demo" alt="" style="display:none">
<script>
function go() {
  var u = '/upload/' + document.getElementById('opts').value + '/' +
          document.getElementById('src').value;
  document.getElementById('url').textContent = u;
  var img = document.getElementById('out');
  img.style.display = 'block';
  img.src = u;
}
</script>
<footer><a href="/metrics">metrics</a> · <a href="/healthz">health</a>
· <a href="/readyz">ready</a></footer>
</body></html>"""

#: one answer: (status, body, headers)
Response = Tuple[int, bytes, Dict[str, str]]


def error_status(exc: AppException) -> int:
    for cls, code in _ERROR_STATUS.items():
        if isinstance(exc, cls):
            return code
    return 500


def error_response(exc: AppException) -> Response:
    status = error_status(exc)
    headers = {"Content-Type": _TEXT}
    if status == 503:
        headers["Retry-After"] = str(max(1, int(getattr(exc, "retry_after_s", 1) or 1)))
    return status, f"{type(exc).__name__}: {exc}".encode(), headers


def compile_route(pattern: str) -> "re.Pattern":
    """An aiohttp-style route pattern as a regex: ``{name}`` matches one
    path segment, ``{name:regex}`` the regex."""
    out, pos = [], 0
    for m in re.finditer(r"\{(\w+)(?::([^{}]+))?\}", pattern):
        out.append(re.escape(pattern[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>{m.group(2) or '[^/]+'})")
        pos = m.end()
    out.append(re.escape(pattern[pos:]))
    return re.compile("".join(out))


def resolve_routes(params: AppParameters) -> Dict[str, "re.Pattern"]:
    """The pipeline routes by logical name after the ``routes`` overrides;
    a misconfiguration raises here, when the server is made."""
    routes = dict(DEFAULT_ROUTES)
    overrides = params.by_key("routes", {}) or {}
    unknown = set(overrides) - set(DEFAULT_ROUTES)
    if unknown:
        raise InvalidArgumentException(
            f"unknown route names in `routes` config: {sorted(unknown)} "
            f"(known: {sorted(DEFAULT_ROUTES)})"
        )
    routes.update(overrides)
    for name, pattern in routes.items():
        if "{options}" not in pattern or "{imageSrc" not in pattern:
            raise InvalidArgumentException(
                f"route pattern for {name!r} must contain {{options}} and "
                f"{{imageSrc:.+}} placeholders, got {pattern!r}"
            )
    return {name: compile_route(pattern) for name, pattern in routes.items()}


def local_sp_mesh(device: torch.device) -> Optional[Mesh]:
    """The spatial-tiling mesh over this host's cards when there is more
    than one (serving meshes span local devices only), else None."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return make_mesh(axis_names=("sp",))


def local_data_mesh(device: torch.device) -> Optional[Mesh]:
    """The data-parallel mesh the transform batcher shards over: this
    host's cards on one ``data`` axis when there is more than one, else
    None. Serving meshes span local devices only: each host of a process
    group runs its own batcher over its own cards (share-nothing across
    hosts); a global mesh would need every host to launch in lockstep."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    return make_mesh(devices=local_devices())


class FlyimgServer(ThreadingHTTPServer):
    """The HTTP server, its handler, its batchers, its host stage pools, its
    observability (the metrics registry, the tracer, the SLO engine, the
    flight recorder, the profiler, the telemetry pipeline), the brownout
    engine, the device supervisor, the policy autotuner, warm start and
    the fleet tier (router, tier supervisor, membership, observatory)."""

    daemon_threads = True

    def __init__(self, address, params: AppParameters,
                 device: Union[str, torch.device] = "cuda",
                 sp_mesh: Optional[Mesh] = None) -> None:
        self.routes = resolve_routes(params)
        set_kernel_mode(str(params.by_key("resample_kernel", "dense")))
        # a previous server's tuned band fraction does not carry over
        set_auto_band_frac(1.0)
        self.params = params
        self.debug = bool(params.by_key("debug"))
        self.log_access = bool(params.by_key("log_access", True))
        self.drain_timeout_s = float(params.by_key("shutdown_drain_timeout_s", 30.0))
        self._injector = params.by_key("fault_injector")
        if self._injector is not None:
            faults.install(self._injector)
        # the JPEG decoder's limit follows the source pixel guard (as the
        # JAX package's Pillow guard does; 0 or less keeps the default)
        native_codec.set_max_pixels(int(params.by_key("mem_max_source_pixels", 0) or 0))

        metrics = self.metrics = MetricsRegistry(
            exemplars=bool(params.by_key("metrics_exemplars", True)))
        self.tracer = tracing.Tracer.from_params(params, metrics=metrics)
        self.slo = SloEngine.from_params(params, metrics=metrics)
        self.slo.register_metrics(metrics)
        metrics.attach_slo(self.slo)
        self.cost_ledger = get_ledger()
        self.cost_ledger.configure(
            max_entries=int(params.by_key("costledger_max_entries", 256)))
        self.cost_ledger.register_metrics(metrics)
        self.flight_recorder = FlightRecorder.from_params(params, metrics=metrics)
        self.profiler = DeviceProfiler.from_params(params, metrics=metrics)
        # the evidence of a breach (the launches that burned the budget) is
        # still in the ring when the breach fires
        self.slo.add_breach_listener(
            lambda info: self.flight_recorder.dump("slo_breach", context=info))
        self.storage = make_storage(params, metrics=metrics)

        governor = self.governor = MemoryGovernor.from_params(params, metrics=metrics)
        self.mem_accountant = HostByteAccountant.from_params(params, metrics=metrics)
        self.rss_watchdog = RssWatchdog.from_params(params, metrics=metrics)
        for part in (governor, self.mem_accountant, self.rss_watchdog):
            if part.enabled:
                part.register_metrics(metrics)
        containment = containment_params(params)
        # the device supervisor, fed by the transform batcher's launches
        supervisor = self.device_supervisor = DeviceSupervisor.from_params(
            params, metrics=metrics)
        # one batch-id sequence for both controllers: an id in a capture's
        # flyimg:batch:<id> range names one flight record
        batch_ids = itertools.count(1)
        mesh = local_data_mesh(resolve_device(device))
        self.batcher = BatchController(
            max_batch=int(params.by_key("batch_max_size", 64)),
            deadline_ms=float(params.by_key("batch_deadline_ms", 4.0)),
            device=device,
            governor=governor if governor.enabled else None,
            metrics=metrics, name="device",
            flight_recorder=self.flight_recorder, profiler=self.profiler,
            batch_ids=batch_ids, supervisor=supervisor if supervisor.enabled else None,
            mesh=mesh, **containment,
        )
        # codec work gets its OWN controller and thread: JPEG decode and
        # encode groups must not serialize with the transform launches
        containment["max_queue_depth"] = int(params.by_key("decode_max_queue_depth", 0))
        self.codec_batcher = BatchController(
            max_batch=int(params.by_key("decode_batch_max", 32)),
            deadline_ms=float(params.by_key("decode_deadline_ms", 1.0)),
            device=self.batcher.device,
            metrics=metrics, name="codec",
            flight_recorder=self.flight_recorder, profiler=self.profiler,
            batch_ids=batch_ids, **containment,
        )
        if supervisor.enabled:
            # a failover moves both controllers: the codec kernels' plain
            # versions serve the JPEG work while it holds
            # the data mesh is asked for anew at each re-promotion, on the
            # card the batcher started on
            card = self.batcher.device
            supervisor.attach(batchers=(self.batcher, self.codec_batcher),
                              mesh_factory=lambda: local_data_mesh(card))
            supervisor.register_metrics(metrics)
        self.brownout = BrownoutEngine.from_params(params, metrics=metrics)
        self.brownout.register_metrics(metrics)
        # flight records carry the level, and an escalation dumps the ring
        # (the launches that built the pressure)
        self.flight_recorder.attach(level_fn=self.brownout.level)
        self.brownout.add_transition_listener(
            lambda info: self.flight_recorder.dump("brownout_escalation", context=info))
        # the fleet router: inert (never consulted) without two replicas
        self.fleet = FleetRouter.from_params(params, metrics=metrics)
        self.replica_id = str(params.by_key("fleet_replica_id", "") or "")
        self.telemetry = TelemetryPipeline.from_params(
            params, metrics=metrics, replica_id=self.replica_id)
        if sp_mesh is None:
            sp_mesh = local_sp_mesh(self.batcher.device)
        self.host_pipeline = HostPipeline.from_params(
            params, metrics=metrics, flight_recorder=self.flight_recorder)
        for pool_name, stage_pool in self.host_pipeline.pools():
            metrics.gauge(
                f'flyimg_host_pool_queue_depth{{pool="{pool_name}"}}',
                "Pending (queued or executing) tasks per host stage pool",
                fn=lambda p=stage_pool: float(p.pending),
            )
        self.handler = ImageHandler(
            params, device=self.batcher.device, batcher=self.batcher,
            sp_mesh=sp_mesh, host_pipeline=self.host_pipeline,
            codec_batcher=self.codec_batcher, metrics=metrics,
            storage=self.storage, brownout=self.brownout,
            device_supervisor=supervisor if supervisor.enabled else None,
            telemetry=self.telemetry if self.telemetry.enabled else None,
        )
        # the tier supervisor: storms of L2 failures trip the island (L2
        # skipped, writes journaled), clean probes re-promote and replay;
        # off, no feed, no thread and no metric
        tier = self.tier_supervisor = TierSupervisor.from_params(params, metrics=metrics)
        if tier.enabled:
            tier.attach(storage=self.storage, variant_index=self.handler.variants)
            if hasattr(self.storage, "attach_supervisor"):
                self.storage.attach_supervisor(tier)
            if self.handler.l2lease is not None:
                self.handler.l2lease.supervisor = tier
            self.handler.variants.attach_supervisor(tier)
            tier.register_metrics(metrics)
        self.inflight = metrics.gauge(
            "flyimg_inflight_requests", "HTTP requests currently in flight")
        metrics.gauge(
            "flyimg_breaker_open",
            "Upstream circuit breakers currently open or half-open",
            fn=self.handler.fetch_policy.breakers.open_count,
        )
        metrics.gauge(
            "flyimg_traces_buffered",
            "Traces held in the tail-sampling ring buffer",
            fn=lambda: len(self.tracer),
        )
        metrics.gauge(
            "flyimg_variant_index_entries",
            "Reuse-safe renditions tracked by the per-source variant index",
            fn=lambda: float(len(self.handler.variants)),
        )
        metrics.gauge(
            "flyimg_program_cache_entries",
            "Live entries across the single-image and batched program caches",
            fn=program_cache_entries,
        )
        self.brownout.attach(
            batchers=(self.batcher, self.codec_batcher),
            slo=self.slo,
            inflight_fn=lambda: self.inflight.value,
            breaker_open_fn=self.handler.fetch_policy.breakers.open_count,
            host_pipeline=self.host_pipeline,
            # followers parked behind remote lease leaders: a fleet-wide
            # stampede is load this replica carries with empty queues
            lease_waiters_fn=((lambda: float(self.handler.l2lease.waiters))
                              if self.handler.l2lease is not None else None),
            device_supervisor=supervisor if supervisor.enabled else None,
            rss_fn=self.rss_watchdog.pressure if self.rss_watchdog.enabled else None,
        )
        # the policy autotuner: off, one bool check a request, no knob
        # bound and no metric
        self.autotuner = PolicyAutotuner.from_params(params, metrics=metrics)
        if self.autotuner.enabled:
            self.autotuner.register_knobs(
                batcher=self.batcher, codec_batcher=self.codec_batcher,
                host_pipeline=self.host_pipeline, handler=self.handler)
            self.autotuner.attach_signals(
                metrics=metrics, slo=self.slo, brownout=self.brownout,
                host_pipeline=self.host_pipeline,
                flight_recorder=self.flight_recorder,
                reuse_fn=reuse_signal_fn(metrics) if self.handler.reuse_enable else None)
            self.autotuner.register_metrics(metrics)
        # warm start, before the first request: the policy, then every
        # program of the store's manifest built and run once on this
        # server's device (a server that answers has absorbed its builds)
        self.warmstart = warmstart.WarmStartCache.from_params(
            params, storage=self.storage.shared, metrics=metrics)
        if self.warmstart.enabled:
            self.warmstart.install()
            self.warmstart.seed_policy(self.autotuner)
            self.warmstart.seed_programs(str(self.batcher.device), self.batcher.mesh)
        # membership: TTL'd markers on the shared tier feed the router's
        # live set, a device-down replica heartbeats degraded, and warm
        # start publishes on the beat; off, no marker, thread or metric
        self.membership = FleetMembership.from_params(
            params, storage=self.storage.shared, router=self.fleet,
            supervisor=supervisor if supervisor.enabled else None,
            warmstart=self.warmstart if self.warmstart.enabled else None,
            metrics=metrics)
        if tier.enabled:
            self.membership.tier_supervisor = tier
        # the observatory: this replica's digest on the membership beat,
        # the fleet rollup and the autoscale recommendation
        self.observatory = FleetObservatory.from_params(
            params, storage=self.storage.shared, membership=self.membership,
            slo=self.slo, brownout=self.brownout,
            supervisor=supervisor if supervisor.enabled else None,
            metrics=metrics)
        if tier.enabled:
            self.observatory.tier_supervisor = tier
        if self.observatory.enabled:
            # its own window: assemble() diffs the launches per window
            self.observatory.window.attach(
                metrics=metrics, slo=self.slo, brownout=self.brownout,
                host_pipeline=self.host_pipeline,
                flight_recorder=self.flight_recorder,
                reuse_fn=reuse_signal_fn(metrics) if self.handler.reuse_enable else None)
            self.membership.observatory = self.observatory
        if self.telemetry.enabled:
            self.telemetry.attach(
                metrics=metrics, slo=self.slo, brownout=self.brownout,
                host_pipeline=self.host_pipeline, flight_recorder=self.flight_recorder,
                reuse_fn=reuse_signal_fn(metrics) if self.handler.reuse_enable else None,
                ledger_fn=self.cost_ledger.aggregates,
            )
            # a positive telemetry_retention_max_dumps bounds the dumps
            self.telemetry.adopt_dump_retention(
                self.flight_recorder,
                int(params.by_key("telemetry_retention_max_dumps", 0)))
        self.draining = threading.Event()
        self._serving = False
        self._trace_lock = threading.Lock()
        self._closed = False
        self._prune_stop = threading.Event()
        self._prune_thread = self._start_prune_loop()
        self._fleet_started = False
        super().__init__(address, _RequestHandler)

    # -- lifecycle -----------------------------------------------------------

    def start_fleet(self) -> None:
        """Announce membership and start its beat, and the tier
        supervisor's scrubber (each a no-op when off); ``serve_forever``
        calls it once."""
        if self._fleet_started:
            return
        self._fleet_started = True
        self.membership.start()
        self.tier_supervisor.start()

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self.start_fleet()
        self._serving = True
        try:
            super().serve_forever(poll_interval)
        finally:
            self._serving = False

    def begin_drain(self) -> None:
        """Readiness answers 503 from now on, and the membership marker
        says draining (peers stop routing here at their next beat);
        everything else still serves."""
        self.draining.set()
        self.membership.begin_drain()

    def server_close(self) -> None:
        """The graceful drain: readiness flips first, while the server
        still serves, then the batchers and the pools finish their work
        within ``shutdown_drain_timeout_s``; then the listener stops."""
        if self._closed:
            return
        self._closed = True
        self.begin_drain()
        self._prune_stop.set()
        self.fleet.close()
        self.device_supervisor.close()
        self.batcher.close(self.drain_timeout_s)
        self.codec_batcher.close(self.drain_timeout_s)
        self.host_pipeline.close(self.drain_timeout_s)
        if self.warmstart.enabled:
            # after the drains: what this server built, for the next one;
            # the process-wide recorder is disarmed
            self.warmstart.maybe_publish()
            warmstart.uninstall()
        # the digest goes before the member marker; an islanded close skips
        # the marker IO, and the prober and scrubber stop last
        self.observatory.close()
        self.membership.close()
        self.tier_supervisor.close()
        self.telemetry.close()
        if self._serving:
            self.shutdown()
        super().server_close()
        if self._injector is not None:
            faults.clear()

    def _start_prune_loop(self) -> Optional[threading.Thread]:
        """The output cache's size budget: every ``cache_prune_interval_s``
        the store is pruned to ``cache_max_bytes`` (temporaries past
        ``cache_part_ttl_s`` go with it). Off unless both are positive."""
        max_bytes = int(self.params.by_key("cache_max_bytes", 0) or 0)
        interval = float(self.params.by_key("cache_prune_interval_s", 300.0))
        part_ttl = float(self.params.by_key("cache_part_ttl_s", 3600.0) or 0.0)
        if max_bytes <= 0 or interval <= 0 or not hasattr(self.storage, "prune"):
            return None

        def run() -> None:
            while not self._prune_stop.wait(interval):
                self.prune_once(max_bytes, part_ttl)

        thread = threading.Thread(target=run, name="flyimg-torch-prune", daemon=True)
        thread.start()
        return thread

    def prune_once(self, max_bytes: int, part_ttl_s: float) -> Optional[dict]:
        """One prune pass and its counters; a failed pass is logged and the
        loop goes on (a transient scan error must not end the budget)."""
        try:
            summary = self.storage.prune(max_bytes, part_ttl_s)
        except Exception as exc:
            print(f"cache prune pass failed: {exc}", file=sys.stderr)
            return None
        if summary["deleted"]:
            self.metrics.counter(
                "flyimg_cache_pruned_total",
                "Cached outputs evicted by the size budget",
            ).inc(summary["deleted"])
        if summary.get("parts"):
            self.metrics.counter(
                "flyimg_cache_part_orphans_total",
                "Orphaned .part temporaries reclaimed by the prune pass",
            ).inc(summary["parts"])
        return summary

    # -- routing --------------------------------------------------------------

    def resolve(self, method: str, path: str):
        """(route name, route function, match groups) of a request path
        (percent-decoded), as the JAX app's router names them: the logical
        name of a pipeline route, the first path segment of the others
        (``index`` for ``/``), ``unmatched`` for none."""
        path = urllib.parse.unquote(path)
        get = method in ("GET", "HEAD")
        for name, regex in self.routes.items():
            m = regex.fullmatch(path)
            if m is not None and get:
                return name, _ROUTE_FUNCS[name], m.groupdict()
        if get and path in _STATIC_GET:
            return _route_label(path), _STATIC_GET[path], {}
        if method == "POST" and path in _STATIC_POST:
            return "debug", _STATIC_POST[path], {}
        if get:
            for prefix, fn in _PREFIX_GET:
                if path.startswith(prefix) and len(path) > len(prefix):
                    return "debug", fn, {"tail": path[len(prefix):]}
        return "unmatched", _not_found, {}


def _route_label(path: str) -> str:
    return path.strip("/").split("/")[0] or "index"


class _RequestHandler(BaseHTTPRequestHandler):
    server: FlyimgServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args) -> None:  # the access log replaces it
        pass

    def _send(self, status: int, body: bytes, headers=None) -> None:
        self.send_response(status)
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def do_HEAD(self) -> None:  # noqa: N802
        """The GET's status and headers, Content-Length included, and no
        body (the reference's aiohttp routes answer HEAD with their GET)."""
        self._serve("HEAD")

    def do_GET(self) -> None:  # noqa: N802 (http.server's name)
        self._serve("GET")

    def do_POST(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length") or 0)
        self.body = self.rfile.read(length) if length > 0 else b""
        self._serve("POST")

    @property
    def query(self) -> Dict[str, str]:
        return dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(self.path).query))

    def _serve(self, method: str) -> None:
        """The observability choke point every request passes."""
        srv = self.server
        path = urllib.parse.urlsplit(self.path).path
        route, fn, match = srv.resolve(method, path)
        trace = None
        if route in _TRACED_ROUTES:
            trace = srv.tracer.start(self.headers.get("traceparent"))
            # the engines' beats ride the pipeline requests (each rate-
            # limited inside, one check when off), in this request's trace
            # so their span events land on it
            with tracing.activate(trace):
                srv.brownout.evaluate()
                srv.autotuner.evaluate()
                srv.device_supervisor.evaluate()
                srv.tier_supervisor.evaluate()
                srv.telemetry.evaluate()
            if trace is not None:
                trace.root.set_attribute("route", route)
                trace.root.set_attribute("http.method", method)
                trace.root.set_attribute("http.path", path)
                trace.root.set_attribute("net.peer", self.client_address[0])
                if srv.replica_id:
                    # which replica's ring holds this trace
                    trace.root.set_attribute("fleet.replica_id", srv.replica_id)
        srv.inflight.inc()
        t0 = time.perf_counter()
        response: Optional[Response] = None
        try:
            response = fn(self, match, trace)
        except Exception:
            # anything else is the server's fault: answer 500, as the
            # reference's app does, instead of dropping the connection
            traceback.print_exc(file=sys.stderr)
            response = (500, b"500 Internal Server Error", {"Content-Type": _TEXT})
        finally:
            srv.inflight.dec()
            duration = time.perf_counter() - t0
            status = response[0] if response is not None else 500
            srv.metrics.record_request(route, status)
            if route in _TRACED_ROUTES:
                # before finish, so a breach's span event rides this trace
                srv.slo.record(duration, ok=status < 500, trace=trace)
        status, body, headers = response
        if (srv.debug and srv.replica_id and route in _TRACED_ROUTES
                and "X-Flyimg-Replica" not in headers):
            # the replica that produced the answer; a proxied one keeps
            # its owner's
            headers["X-Flyimg-Replica"] = srv.replica_id
        if trace is not None:
            trace.root.set_attribute("http.status", status)
            srv.tracer.finish(trace, "error" if status >= 500 else "ok")
            headers["traceparent"] = tracing.format_traceparent(
                trace.trace_id, trace.root.span_id)
            if srv.debug:
                timing = tracing.server_timing(trace)
                if timing:
                    headers["Server-Timing"] = timing
        if srv.log_access:
            access_log(
                method=method, path=self.path, route=route, status=status,
                duration_s=duration, bytes_sent=len(body),
                remote=self.client_address[0],
                trace_id=trace.trace_id if trace is not None else None,
                span_id=trace.root.span_id if trace is not None else None,
                user_agent=self.headers.get("User-Agent"),
                replica=srv.replica_id or None,
            )
        self._send(status, body, headers)

    # -- the pipeline -------------------------------------------------------

    def process(self, match: Dict[str, str], trace):
        """The handler's render of this request, under its trace and its
        budget (minted here, at ingress)."""
        srv = self.server
        deadline = Deadline.from_params(srv.params, metrics=srv.metrics)
        with tracing.activate(trace):
            return srv.handler.process_image(
                match["options"], match["imageSrc"],
                accepts_webp="image/webp" in (self.headers.get("Accept") or ""),
                deadline=deadline,
            )


def _json(doc, status: int = 200) -> Response:
    return status, json.dumps(doc).encode(), {"Content-Type": _JSON}


def _text(text: str, status: int = 200) -> Response:
    return status, text.encode(), {"Content-Type": _TEXT}


def _route_fleet(req: _RequestHandler, match, trace) -> Optional[Response]:
    """Owner routing of one ``/upload`` request: the owner's relayed
    answer, or None when this replica renders (it owns the key, the
    request hopped once already, the mode is ``local``, or the owner is
    down or answered 5xx, when the render here is the fallback and the
    shared lease still dedups it)."""
    srv = req.server
    fleet = srv.fleet
    if not fleet.enabled:
        return None
    key = route_key(match["options"], match["imageSrc"],
                    separator=str(srv.params.by_key("options_separator", ",")))
    owner = fleet.owner(key)
    route_span = trace.start_span("fleet.route") if trace is not None else None
    outcome = "self"
    try:
        if HOP_HEADER in req.headers:
            # forwarded once already: render here whatever this replica's
            # (maybe skewed) set says, so no request proxies in circles
            outcome = "hop"
            return None
        if owner == fleet.self_id:
            return None
        if not fleet.proxies:
            outcome = "local"
            return None
        relayed = fleet.proxy(
            owner, req.path, req.headers,
            timeout_s=float(srv.params.by_key("request_deadline_s", 0.0) or 0.0) or None,
            traceparent=(tracing.format_traceparent(trace.trace_id, route_span.span_id)
                         if route_span is not None else None),
        )
        if relayed is None:
            outcome = "fallback"
            return None
        outcome = "proxied"
        status, headers, body = relayed
        return status, body, headers
    finally:
        fleet.record(outcome)
        if route_span is not None:
            route_span.attributes.update({
                "fleet.owner": owner, "fleet.self": fleet.self_id,
                "fleet.outcome": outcome,
            })
            route_span.end()


def _upload(req: _RequestHandler, match, trace) -> Response:
    routed = _route_fleet(req, match, trace)
    if routed is not None:
        return routed
    try:
        result = req.process(match, trace)
    except AppException as exc:
        return error_response(exc)
    headers = image_headers(result, req.server.params.by_key("header_cache_days", 365))
    if req.server.debug and result.reused_from:
        # which stored ancestor the answer was derived from (debug only)
        headers["X-Flyimg-Reuse"] = result.reused_from
    if is_not_modified(req.headers, headers):
        return 304, b"", {k: headers[k] for k in NOT_MODIFIED_HEADERS if k in headers}
    return 200, result.content, headers


def _path(req: _RequestHandler, match, trace) -> Response:
    try:
        result = req.process(match, trace)
    except AppException as exc:
        return error_response(exc)
    host = req.headers.get("Host") or "%s:%d" % req.server.server_address[:2]
    return _text(req.server.storage.public_url(result.spec.name, f"http://{host}"))


def _index(req, match, trace) -> Response:
    return 200, HOMEPAGE.encode(), {"Content-Type": "text/html; charset=utf-8"}


def _not_found(req, match, trace) -> Response:
    return 404, b"404: Not Found", {"Content-Type": _TEXT}


def _healthz(req, match, trace) -> Response:
    srv = req.server
    return _json({
        "status": "ok",
        "app": srv.params.by_key("application_name"),
        "devices": [str(srv.batcher.device)],
    })


def _readyz(req, match, trace) -> Response:
    """Readiness, apart from liveness: 503 from the moment the server
    begins to drain, so a load balancer takes it out of rotation before
    the batchers drain."""
    srv = req.server
    membership = srv.membership
    # two drains answer here: the server's own, and a scale-in nomination
    # of the observatory (the membership marker flips first)
    if srv.draining.is_set() or (
            membership.enabled and membership.current_status() == "draining"):
        return _json({"status": "draining"}, 503)
    doc = {"status": "ok"}
    if srv.device_supervisor.enabled:
        # a failed-over server stays ready (hits and CPU renders serve);
        # the fleet's health gate reads this field
        doc["device"] = "down" if srv.device_supervisor.cpu_forced() else "ok"
    if membership.enabled:
        doc["members"] = int(membership.member_count())
    if srv.tier_supervisor.enabled:
        # an islanded replica stays ready (L1 hits and journaled writes)
        doc["tier"] = "island" if srv.tier_supervisor.islanded() else "attached"
    return _json(doc)


def _metrics(req, match, trace) -> Response:
    """A Prometheus scrape: OpenMetrics (exemplars, ``# EOF``) for a client
    that accepts it, else text 0.0.4, which has no exemplar syntax."""
    srv = req.server
    if "application/openmetrics-text" in (req.headers.get("Accept") or ""):
        return (200, srv.metrics.render_prometheus(openmetrics=True).encode(),
                {"Content-Type": "application/openmetrics-text; version=1.0.0; "
                                 "charset=utf-8"})
    return 200, srv.metrics.render_prometheus().encode(), {"Content-Type": _TEXT}


def _debug_403(fn: Callable) -> Callable:
    def gated(req, match, trace):
        if not req.server.debug:
            return _text(_DEBUG_OFF, 403)
        return fn(req, match, trace)
    return gated


def _debug_404(fn: Callable) -> Callable:
    """The operator-only routes do not advertise themselves with debug
    off."""
    def gated(req, match, trace):
        if not req.server.debug:
            return _text("not found", 404)
        return fn(req, match, trace)
    return gated


@_debug_403
def _debug_trace(req, match, trace) -> Response:
    """A wall-clock torch.profiler capture of ``?ms=`` milliseconds
    (default 500, at most 30 s) into ``tmp_dir/traces``. Refuses (409)
    while another capture, or a batch-scoped one, holds the profiler."""
    srv = req.server
    try:
        ms = min(float(req.query.get("ms", 500)), 30_000.0)
        if not ms > 0:
            raise ValueError
    except ValueError:
        return _text("ms must be a positive number", 400)
    if not srv._trace_lock.acquire(blocking=False):
        return _text("a trace is already running", 409)
    try:
        if srv.profiler.busy:
            return _text("a /debug/profile capture is in flight", 409)
        trace_dir = os.path.join(str(srv.params.by_key("tmp_dir", "var/tmp")),
                                 "traces", time.strftime("%Y%m%d-%H%M%S"))
        session = ProfilerSession(trace_dir)
        session.start()
        try:
            time.sleep(ms / 1000.0)
        finally:
            session.stop()
    finally:
        srv._trace_lock.release()
    return _json({"trace_dir": trace_dir, "captured_ms": ms})


@_debug_403
def _debug_traces_list(req, match, trace) -> Response:
    try:
        limit = min(int(req.query.get("limit", 100)), 1000)
    except ValueError:
        return _text("limit must be an integer", 400)
    return _json({"traces": req.server.tracer.list(limit=limit)})


@_debug_403
def _debug_traces_get(req, match, trace) -> Response:
    kept = req.server.tracer.get(match["tail"])
    if kept is None:
        return _text("no such trace (dropped by the tail sampler, evicted "
                     "from the ring, or never seen)", 404)
    return _json(kept.as_dict())


@_debug_404
def _debug_slo(req, match, trace) -> Response:
    return _json(req.server.slo.snapshot())


@_debug_404
def _debug_perf(req, match, trace) -> Response:
    srv = req.server
    doc = srv.metrics.perf_snapshot()
    doc["host_pipeline"] = (srv.host_pipeline.snapshot()
                            if srv.host_pipeline.enabled else None)
    # which replica produced these windows (null with the fleet off)
    doc["fleet"] = ({"replica_id": srv.replica_id, "replicas": srv.fleet.replicas,
                     "mode": srv.fleet.mode}
                    if srv.fleet.enabled else None)
    return _json(doc)


@_debug_404
def _debug_plans(req, match, trace) -> Response:
    """The cost ledger's snapshot and both program caches."""
    doc = req.server.cost_ledger.snapshot()
    doc["program_cache"] = program_cache_info()
    return _json(doc)


@_debug_404
def _debug_flightrecorder(req, match, trace) -> Response:
    return _json(req.server.flight_recorder.snapshot())


@_debug_404
def _debug_profile_get(req, match, trace) -> Response:
    return _json(req.server.profiler.snapshot())


@_debug_404
def _debug_profile_arm(req, match, trace) -> Response:
    """Arm a capture of the next ``?batches=N`` batches (``?max_s=S``
    bounds it); 409 while a capture or a ``/debug/trace`` runs."""
    srv = req.server
    if srv._trace_lock.locked():
        return _text("a /debug/trace capture is running", 409)
    query = req.query
    try:
        batches = int(query.get("batches", 4))
        max_s = float(query["max_s"]) if "max_s" in query else None
        if batches <= 0 or (max_s is not None and not max_s > 0):
            raise ValueError
    except ValueError:
        return _text("batches (int > 0) and max_s (seconds > 0) expected", 400)
    try:
        return _json(srv.profiler.arm(batches, max_s))
    except RuntimeError as exc:
        return _text(str(exc), 409)


@_debug_404
def _debug_profile_download(req, match, trace) -> Response:
    """One listed capture as a tar.gz (an unlisted name is 404, so a
    crafted segment cannot leave the capture directory)."""
    name = match["tail"]
    path = req.server.profiler.capture_path(name)
    if path is None:
        return _text("no such capture", 404)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        tar.add(path, arcname=name)
    return 200, buf.getvalue(), {
        "Content-Type": "application/gzip",
        "Content-Disposition": f'attachment; filename="{name}.tar.gz"',
    }


@_debug_404
def _debug_brownout(req, match, trace) -> Response:
    return _json(req.server.brownout.snapshot())


@_debug_404
def _debug_device(req, match, trace) -> Response:
    return _json(req.server.device_supervisor.snapshot())


@_debug_404
def _debug_telemetry(req, match, trace) -> Response:
    return _json(req.server.telemetry.snapshot())


@_debug_404
def _debug_autotune(req, match, trace) -> Response:
    return _json(req.server.autotuner.snapshot())


@_debug_404
def _debug_fleet(req, match, trace) -> Response:
    """Membership (self status, the live set, every readable marker and
    its expiry verdict) and warm start's accounting."""
    srv = req.server
    doc = srv.membership.snapshot()
    doc["warmstart"] = srv.warmstart.snapshot()
    return _json(doc)


@_debug_404
def _debug_fleet_status(req, match, trace) -> Response:
    """The whole fleet in one document: the observatory's digests, rollup
    and recommendation, membership, and the router's peer health."""
    srv = req.server
    return _json({
        "observatory": srv.observatory.snapshot(),
        "membership": srv.membership.snapshot(),
        "routing": srv.fleet.peer_health(),
    })


_REPLICAS_BODY = ('body must be {"replicas": ["http://...", ...], '
                  '"replica_id": "..."} (replica_id optional)')


@_debug_404
def _debug_fleet_replicas(req, match, trace) -> Response:
    """Swap the routing set online from ``{"replicas": [...],
    "replica_id": "..."}``; refused while membership owns the set (its
    next beat would overwrite the swap: a split brain)."""
    srv = req.server
    log = logging.getLogger("flyimg.fleet")
    if srv.membership.active:
        log.warning("manual replica-set reload rejected: elastic membership "
                    "owns the replica set",
                    extra={"event": "fleet.manual_reload_rejected",
                           "source": "debug_endpoint"})
        return _text("replica set is managed by fleet membership "
                     "(fleet_membership_enable is on); a manual swap would be "
                     "overwritten by the watcher's next beat — stop the "
                     "replica or disable membership instead", 400)
    try:
        body = json.loads(getattr(req, "body", b"") or b"")
    except ValueError:
        return _text("body must be JSON", 400)
    replicas = body.get("replicas") if isinstance(body, dict) else None
    if not isinstance(replicas, list) or not all(isinstance(r, str) for r in replicas):
        return _text(_REPLICAS_BODY, 400)
    self_id = body.get("replica_id")
    if self_id is not None and not isinstance(self_id, str):
        return _text("replica_id must be a string", 400)
    applied = srv.fleet.update_replicas(replicas, self_id=self_id)
    log.info("replica set reloaded via /debug/fleet/replicas",
             extra={"event": "fleet.replicas_reloaded", **applied})
    return _json(applied)


@_debug_404
def _debug_tier(req, match, trace) -> Response:
    return _json(req.server.tier_supervisor.snapshot())


@_debug_404
def _debug_memory(req, match, trace) -> Response:
    srv = req.server
    return _json({
        "governor": srv.governor.snapshot(),
        "host": srv.mem_accountant.snapshot(),
        "rss": srv.rss_watchdog.snapshot(),
    })


_ROUTE_FUNCS = {"upload": _upload, "path": _path}
_STATIC_GET = {
    "/": _index,
    "/healthz": _healthz,
    "/readyz": _readyz,
    "/metrics": _metrics,
    "/debug/trace": _debug_trace,
    "/debug/traces": _debug_traces_list,
    "/debug/slo": _debug_slo,
    "/debug/perf": _debug_perf,
    "/debug/plans": _debug_plans,
    "/debug/flightrecorder": _debug_flightrecorder,
    "/debug/profile": _debug_profile_get,
    "/debug/memory": _debug_memory,
    "/debug/brownout": _debug_brownout,
    "/debug/device": _debug_device,
    "/debug/telemetry": _debug_telemetry,
    "/debug/autotune": _debug_autotune,
    "/debug/fleet": _debug_fleet,
    "/debug/fleet/status": _debug_fleet_status,
    "/debug/tier": _debug_tier,
}
_STATIC_POST = {
    "/debug/profile": _debug_profile_arm,
    "/debug/fleet/replicas": _debug_fleet_replicas,
}
# one path segment after the prefix (aiohttp's {name})
_PREFIX_GET = (
    ("/debug/traces/", _debug_traces_get),
    ("/debug/profile/captures/", _debug_profile_download),
)


def make_server(
    params: Optional[AppParameters] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    device: Union[str, torch.device] = "cuda",
    sp_mesh: Optional[Mesh] = None,
) -> FlyimgServer:
    """A bound, not yet serving server (port 0 picks a free port).
    ``sp_mesh`` is the handler's tiling mesh (for example a virtual one);
    None takes the local cards' when there are more than one."""
    return FlyimgServer((host, port), params or AppParameters(), device, sp_mesh)


def serve_in_thread(server: FlyimgServer) -> threading.Thread:
    thread = threading.Thread(
        target=server.serve_forever, name="flyimg-torch-http", daemon=True
    )
    thread.start()
    return thread


def reload_replicas(server: FlyimgServer, params_path: str) -> Optional[dict]:
    """Re-read ``fleet_replicas`` and ``fleet_replica_id`` from the params
    file into the router (the SIGHUP path; the same swap as ``POST
    /debug/fleet/replicas``). Refused while membership owns the set."""
    log = logging.getLogger("flyimg.fleet")
    if server.membership.active:
        log.warning("SIGHUP replica reload rejected: elastic membership owns "
                    "the replica set",
                    extra={"event": "fleet.manual_reload_rejected", "source": "sighup"})
        return None
    try:
        fresh = AppParameters.from_json(params_path)
        applied = server.fleet.update_replicas(
            list(fresh.by_key("fleet_replicas", []) or []),
            self_id=str(fresh.by_key("fleet_replica_id", "") or "") or None)
    except Exception as exc:
        log.warning("SIGHUP replica reload failed: %s", exc)
        return None
    log.info("replica set reloaded on SIGHUP",
             extra={"event": "fleet.replicas_reloaded", **applied})
    return applied


def install_sighup_reload(server: FlyimgServer, params_path: str) -> bool:
    """SIGHUP reloads the replica set, where the platform has the signal
    and this is the main thread (else the boot set stays)."""
    sighup = getattr(signal, "SIGHUP", None)
    if sighup is None or threading.current_thread() is not threading.main_thread():
        return False
    try:
        signal.signal(sighup, lambda _signum, _frame: reload_replicas(server, params_path))
    except (ValueError, OSError):
        return False
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flyimg-tpu-torch")
    sub = parser.add_subparsers(dest="cmd")
    enc = sub.add_parser("encrypt", help="mint a signed URL token")
    enc.add_argument("payload", help="'{options}/{imageSrc}' to encrypt")
    enc.add_argument("--params", default=None, help="JSON parameters file")
    srv = sub.add_parser("serve", help="run the HTTP service")
    srv.add_argument("--host", default="0.0.0.0")
    srv.add_argument("--port", type=int, default=8080)
    srv.add_argument("--params", default=None, help="JSON parameters file")
    srv.add_argument("--device", default="cuda")
    prn = sub.add_parser(
        "prune",
        help="evict least-recently-modified cached outputs to a size budget",
    )
    prn.add_argument("--max-bytes", type=int, required=True)
    prn.add_argument("--params", default=None, help="JSON parameters file")
    args = parser.parse_args(argv)
    params = (
        AppParameters.from_json(args.params)
        if getattr(args, "params", None) else AppParameters()
    )
    if args.cmd == "encrypt":
        from flyimg_tpu_torch.service.security import SecurityHandler

        print(SecurityHandler(params).encrypt(args.payload))
        return 0
    if args.cmd == "prune":
        storage = make_storage(params)
        if not hasattr(storage, "prune"):
            print(f"{type(storage).__name__} does not support prune "
                  "(use a bucket lifecycle policy)", file=sys.stderr)
            return 1
        print(json.dumps(storage.prune(args.max_bytes)))
        return 0
    if args.cmd != "serve":
        parser.print_help()
        return 1
    configure_logging(params)
    server = make_server(params, args.host, args.port, args.device)
    print(f"flyimg-tpu-torch serving on {args.host}:{server.server_address[1]} "
          f"({server.batcher.device})", file=sys.stderr)
    if args.params:
        install_sighup_reload(server, args.params)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
