"""Server parameters: the keys this package reads, with the JAX package's
defaults, loaded from a dict or a JSON file (no YAML dependency)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from flyimg_tpu_torch.spec.options import DEFAULT_OPTIONS, OPTIONS_KEYS

SERVER_DEFAULTS: Dict[str, Any] = {
    "application_name": "flyimg-tpu",
    # the debug-gated routes (/debug/*) and the Server-Timing header
    "debug": False,
    "header_cache_days": 365,
    "options_separator": ",",
    # signed URLs and domain restrictions (service/security.py): with a
    # security_key the options segment is an AES-256-CBC token; with
    # restricted_domains on, only whitelist_domains hosts are fetched
    "security_key": "",
    "security_iv": "",
    "restricted_domains": False,
    "whitelist_domains": [],
    # the output store (storage/): local, s3 or gcs, each reading its own
    # config dict below
    "storage_system": "local",
    "aws_s3": {"access_id": "", "secret_key": "", "region": "", "bucket_name": ""},
    "gcs": {"bucket_name": "", "project": ""},
    # the S3 and GCS clients' split timeouts (0: the library's default, and
    # no timeout configuration is built at all)
    "storage_connect_timeout_s": 0.0,
    "storage_read_timeout_s": 0.0,
    # route-pattern overrides by logical name (upload, path), validated
    # when the server is made
    "routes": {},
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
    # a source fetch's split timeouts: to connect, between reads of the
    # answer, to send the request (each capped by the remaining deadline)
    "fetch_connect_timeout_s": 3.0,
    "fetch_read_timeout_s": 10.0,
    "fetch_write_timeout_s": 10.0,
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
    # the process RSS limit the watchdog normalises its pressure to (0
    # off); /debug/memory and flyimg_mem_rss_bytes read it
    "mem_rss_limit_bytes": 0,
    # source guards: the most bytes a fetch reads, and the most pixels a
    # source's header may declare (413 before any decode; also the JPEG
    # decoder's limit; 0 or less keeps the codec's default)
    "mem_max_source_bytes": 256 * 1024 * 1024,
    "mem_max_source_pixels": 512 * 1024 * 1024,
    # the output cache's size budget and its background prune (0 disables
    # the budget; a non-positive interval disables the loop); orphaned
    # temporaries older than the TTL are reclaimed by the same pass
    "cache_max_bytes": 0,
    "cache_prune_interval_s": 300.0,
    "cache_part_ttl_s": 3600.0,
    # ms without a cache read's result before ONE backup read fires and
    # the first result serves (storage/base.py fetch_hedged); 0 is off
    "storage_hedge_delay_ms": 0.0,
    # the bounded drain of the batchers and pools at shutdown (readiness
    # answers 503 from its start)
    "shutdown_drain_timeout_s": 30.0,
    # observability (runtime/tracing.py, logging.py, slo.py, metrics.py,
    # flightrecorder.py, profiling.py): per-request traces with tail
    # sampling, the JSON access log, SLO burn rates, exemplars, the
    # flight recorder and the batch-scoped torch.profiler captures
    "tracing_enabled": True,
    "tracing_buffer_size": 256,
    "tracing_sample_rate": 1.0,
    "tracing_slow_threshold_s": 0.5,
    "log_format": "json",
    "log_level": "info",
    "log_access": True,
    "slo_enabled": True,
    "slo_latency_p99_ms": 150.0,
    "slo_availability": 99.9,
    "slo_latency_quantile": 0.99,
    "slo_window_fast_s": 300.0,
    "slo_window_slow_s": 3600.0,
    "slo_burn_threshold_fast": 14.4,
    "slo_burn_threshold_slow": 6.0,
    "metrics_exemplars": True,
    "costledger_max_entries": 256,
    "profiling_max_batches": 16,
    "profiling_max_seconds": 30.0,
    "profiling_dir": "",
    "flightrecorder_size": 256,
    "flightrecorder_dump_dir": "",
    "flightrecorder_min_dump_interval_s": 30.0,
    "flightrecorder_max_dumps": 16,
    # the telemetry warehouse (runtime/telemetry.py), off by default: a
    # JSONL archive of signal windows and launch records under
    # telemetry_dir ('' is <tmp_dir>/telemetry), rotated by size and age,
    # evicted oldest first past the retention bounds, and the traffic-mix
    # classifier; the beat rides the request path every
    # telemetry_snapshot_interval_s. A positive
    # telemetry_retention_max_dumps bounds the flight recorder's dumps
    "telemetry_enable": False,
    "telemetry_dir": "",
    "telemetry_snapshot_interval_s": 10.0,
    "telemetry_segment_max_bytes": 1048576,
    "telemetry_segment_max_age_s": 300.0,
    "telemetry_retention_max_bytes": 33554432,
    "telemetry_retention_max_segments": 64,
    "telemetry_retention_max_dumps": 0,
    "telemetry_mix_window": 256,
    "telemetry_mix_min_samples": 8,
    "telemetry_mix_hysteresis": 2,
    # the device supervisor (runtime/devicesupervisor.py), off by default:
    # device_storm_threshold TRANSIENT launch failures within
    # device_storm_window_s fail both controllers over to the CPU (answers
    # tagged X-Flyimg-Degraded: cpu-fallback, never cached); a prober
    # re-promotes after device_probe_hysteresis clean CUDA probes, each
    # bounded by backend_probe_timeout_s
    "device_supervisor_enable": False,
    "device_storm_threshold": 5,
    "device_storm_window_s": 30.0,
    "device_probe_interval_s": 5.0,
    "device_probe_hysteresis": 2,
    "device_failover_drain_s": 10.0,
    "backend_probe_timeout_s": 75.0,
    # brownout (runtime/brownout.py), off by default: the pressure of the
    # batchers, the SLO burn, the host pools and the RSS watchdog walks
    # NORMAL -> DEGRADED (stale-while-revalidate) -> BROWNOUT (degraded
    # plans, the host entropy crop, quality clamped to brownout_quality;
    # never cached) -> SHED (misses answer 503); escalation is immediate,
    # each step down waits brownout_min_dwell_s and pressure under
    # threshold * brownout_hysteresis
    "brownout_enable": False,
    "brownout_degraded_at": 0.6,
    "brownout_brownout_at": 0.85,
    "brownout_shed_at": 1.1,
    "brownout_hysteresis": 0.75,
    "brownout_min_dwell_s": 5.0,
    "brownout_eval_interval_s": 0.25,
    # pending submissions at which queue pressure reads 1.0 (0:
    # batch_max_queue_depth, else 64); inflight requests and open
    # breakers at which those read 1.0 (0: not read)
    "brownout_queue_ref": 0.0,
    "brownout_inflight_ref": 0.0,
    "brownout_breaker_ref": 0.0,
    "brownout_quality": 40,
    "brownout_stale_ttl_s": 300.0,
    "brownout_refresh_max_pending": 8,
    "brownout_lease_ref": 8.0,
    # derivative reuse (runtime/variantindex.py), off by default: a miss
    # renders from a stored pure resample of the same source at least
    # reuse_min_scale times its box (reuse_degraded_min_scale and one more
    # lossy generation at DEGRADED and above), indexed per source in
    # <source-digest>.variants.json manifests beside the outputs
    "reuse_enable": False,
    "reuse_min_scale": 2.0,
    "reuse_max_generations": 1,
    "reuse_degraded_min_scale": 1.3,
    "reuse_index_max_sources": 512,
    "reuse_index_max_variants": 16,
    "reuse_index_ttl_s": 3600.0,
    # the negative origin cache (runtime/brownout.py NegativeCache): an
    # origin whose retries ran out, or whose breaker is open, answers 502
    # at once for this many seconds (0 off)
    "negative_cache_ttl_s": 0.0,
    "negative_cache_max_entries": 1024,
    # warm start (runtime/warmstart.py), off by default: the identities of
    # the programs built are published as digest-stamped manifests (with
    # the autotuner's known-good policy) in the store at shutdown, and a
    # server seeds its program cache and policy from them before it serves
    "warmstart_enable": False,
    "warmstart_max_entries": 64,
    # the policy autotuner (runtime/autotuner.py), off by default: at most
    # one in-envelope knob step every autotune_interval_s, reverted when
    # the next window's objective regresses past the margin, frozen at the
    # last-known-good policy while the SLO burn (or BROWNOUT) reaches
    # autotune_freeze_at; autotune_envelopes overrides {knob: {lo, hi, step}}
    "autotune_enable": False,
    "autotune_interval_s": 30.0,
    "autotune_regression_margin": 0.05,
    "autotune_cooldown_periods": 2,
    "autotune_freeze_at": 1.0,
    "autotune_unfreeze_hysteresis": 0.75,
    "autotune_freeze_dwell_s": 60.0,
    "autotune_history": 64,
    "autotune_envelopes": {},
    # the fleet tier (runtime/fleet.py, storage/tiered.py; docs/fleet.md),
    # all off by default. Rendezvous routing over fleet_replicas (on with
    # two or more and fleet_replica_id, this replica's own entry): a
    # non-owner proxies to the owner under fleet_route proxy (one hop,
    # bounded by fleet_proxy_timeout_s and the request's budget; a peer
    # whose /readyz says device down is routed around for
    # fleet_health_ttl_s) or renders itself under local
    "fleet_replicas": [],
    "fleet_replica_id": "",
    "fleet_route": "proxy",
    "fleet_proxy_timeout_s": 30.0,
    "fleet_health_ttl_s": 5.0,
    # the shared L2 behind each replica's store (l2_storage_system: local
    # at l2_upload_dir, or s3 / gcs on the dicts above): reads L1 then L2
    # with promotion, writes and deletes through both, blake2b sidecars
    # with l2_checksum_enable; the cross-replica lease (l2_lease_*) makes
    # one replica render a both-tier miss while the rest poll for it
    "l2_enable": False,
    "l2_storage_system": "local",
    "l2_upload_dir": "web/l2",
    "l2_lease_enable": True,
    "l2_lease_ttl_s": 30.0,
    "l2_lease_poll_ms": 50.0,
    "l2_lease_wait_cap_s": 120.0,
    "l2_checksum_enable": False,
    # the tier supervisor (runtime/tiersupervisor.py): tier_storm_threshold
    # L2 failures within tier_storm_window_s trip the island (L2 skipped,
    # writes journaled up to tier_journal_max_entries for
    # tier_journal_ttl_s); tier_probe_hysteresis clean probes every
    # tier_probe_interval_s re-promote and replay; the scrubber checks
    # tier_scrub_sample L2 artifacts every tier_scrub_interval_s
    "tier_supervisor_enable": False,
    "tier_storm_threshold": 5,
    "tier_storm_window_s": 30.0,
    "tier_probe_interval_s": 5.0,
    "tier_probe_hysteresis": 2,
    "tier_journal_max_entries": 512,
    "tier_journal_ttl_s": 900.0,
    "tier_scrub_enable": False,
    "tier_scrub_interval_s": 60.0,
    "tier_scrub_sample": 8,
    # fleet membership (runtime/membership.py): TTL'd member markers on the
    # L2, a heartbeat every fleet_membership_heartbeat_s, and the live set
    # fed to the router (manual reloads are refused while it runs)
    "fleet_membership_enable": False,
    "fleet_membership_ttl_s": 15.0,
    "fleet_membership_heartbeat_s": 5.0,
    # the fleet observatory (runtime/observatory.py): signal digests on the
    # membership beat, the fleet rollup and the autoscale recommendation
    # (fleet_autoscale_drain: a scale-in drains the last ready member)
    "fleet_observatory_enable": False,
    "fleet_autoscale_min_replicas": 1,
    "fleet_autoscale_max_replicas": 8,
    "fleet_autoscale_burn_out": 1.0,
    "fleet_autoscale_occupancy_out": 0.85,
    "fleet_autoscale_brownout_out": 2,
    "fleet_autoscale_burn_in": 0.5,
    "fleet_autoscale_occupancy_in": 0.5,
    "fleet_autoscale_cooldown_s": 60.0,
    "fleet_autoscale_drain": False,
    # object-passing clocks of the engines (tests only)
    "autotune_clock": None,
    "brownout_clock": None,
    "device_supervisor_clock": None,
    "fleet_membership_clock": None,
    "fleet_observatory_clock": None,
    "tier_supervisor_clock": None,
    "mem_clock": None,
    "telemetry_clock": None,
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
