"""The observatory: the signal window, and the fleet observatory.

The port of ``flyimg_tpu/runtime/observatory.py``:

- ``SignalWindow``: one dict of the signals the policy autotuner
  (``runtime/autotuner.py``), the telemetry beat (``runtime/telemetry.py``)
  and the fleet observatory read. Each consumer owns its own window;
- signal digests: each replica publishes a compact, versioned JSON digest
  (``fleet-digest--<slug>.digest``) on the membership beat beside its
  member marker, with the same discipline (TTL'd, expiry judged on the
  reader's clock, a failed write counted and tried again next beat);
- the fleet rollup (replica counts by status, the worst and the
  request-weighted burn, occupancy, the brownout histogram) behind the
  ``flyimg_fleet_*`` gauges and ``/debug/fleet/status``, and the
  ``AutoscaleRecommender``: a pure scale-out / scale-in / hold rule with
  hysteresis, cooldown and bounds. Every replica runs the same rule over
  the same rollup, so the scale-in drain candidate (the last sorted ready
  member) selects itself with no coordination.

Inert by default: with ``fleet_observatory_enable`` off (or membership
off) no metric, no digest and no answer changes.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from flyimg_tpu_torch.storage.tiered import DIGEST_PREFIX, DIGEST_SUFFIX, digest_name
from flyimg_tpu_torch.testing import faults

__all__ = ["SignalWindow", "AutoscaleRecommender", "FleetObservatory", "DIGEST_VERSION"]

LOGGER = "flyimg.fleet"

#: the digest's schema version: a reader skips (and counts) any other
DIGEST_VERSION = 1


class SignalWindow:
    """The signal assembly: the controllers' efficiency windows (with the
    launches since this window's previous call), the normalized SLO burn,
    the brownout level, the host pools' saturation, the reuse ratio, the
    flight recorder's recent summary and the resample kernel mode.
    ``attach()`` wires the read surfaces (each optional: a missing one
    gives neutral signals); ``assemble()`` returns one window.

    Not to be shared: ``assemble()`` diffs each controller's
    ``recorded_total`` against its own previous call, so two readers of
    one instance would each see part of the launches."""

    def __init__(self) -> None:
        self._prev_recorded: Dict[str, float] = {}
        self._slo = None
        self._brownout = None
        self._host_pipeline = None
        self._flight_recorder = None
        self._batch_stats_fn: Optional[Callable[[str], Dict]] = None
        self._reuse_fn: Optional[Callable[[], Dict]] = None

    def attach(self, *, metrics=None, slo=None, brownout=None,
               host_pipeline=None, flight_recorder=None,
               reuse_fn: Optional[Callable[[], Dict]] = None) -> None:
        if metrics is not None:
            self._batch_stats_fn = lambda name: metrics.batch_efficiency(name).stats()
        self._slo = slo
        self._brownout = brownout
        self._host_pipeline = host_pipeline
        self._flight_recorder = flight_recorder
        self._reuse_fn = reuse_fn

    def assemble(self) -> Dict:
        from flyimg_tpu_torch.ops.resample import kernel_mode

        out: Dict = {"controllers": {}, "host": {}}
        if self._batch_stats_fn is not None:
            for name in ("device", "codec"):
                try:
                    stats = dict(self._batch_stats_fn(name))
                except Exception:
                    continue
                # recency: the efficiency window is count-based and never
                # expires, so one old burst would read as live traffic
                total = float(stats.get("recorded_total", 0.0))
                prev = self._prev_recorded.get(name)
                stats["launches_delta"] = total - prev if prev is not None else 0.0
                self._prev_recorded[name] = total
                out["controllers"][name] = stats
        slo = self._slo
        if slo is not None and getattr(slo, "enabled", False):
            try:
                out["burn_fast_norm"] = slo.burn_rate("fast") / max(slo.burn_threshold_fast, 1e-9)
                out["burn_slow_norm"] = slo.burn_rate("slow") / max(slo.burn_threshold_slow, 1e-9)
            except Exception:
                pass
        if self._brownout is not None:
            try:
                out["brownout_level"] = int(self._brownout.level())
            except Exception:
                pass
        pipeline = self._host_pipeline
        if pipeline is not None and getattr(pipeline, "enabled", False):
            try:
                for stage, stats in pipeline.snapshot().items():
                    bound = max(stats.get("bound", 0.0), 1.0)
                    workers = max(stats.get("workers", 1.0), 1.0)
                    out["host"][stage] = {
                        "saturation": stats.get("pending", 0.0) / bound,
                        "busy_frac": stats.get("busy", 0.0) / workers,
                        "workers": workers,
                    }
            except Exception:
                pass
        if self._reuse_fn is not None:
            try:
                out["reuse"] = self._reuse_fn()
            except Exception:
                pass
        if self._flight_recorder is not None:
            try:
                out["flightrecorder"] = self._flight_recorder.recent_summary()
            except Exception:
                pass
        out["kernel_mode"] = kernel_mode()
        return out


class AutoscaleRecommender:
    """Deterministic scale-out/in recommendation over one fleet
    rollup. Pure rule set — no IO, no wall clock of its own (``now``
    is passed in), so every replica evaluating the same rollup reaches
    the same answer and tests script exact decision sequences.

    The recommendation is a LEVEL, not an edge: ``scale_out`` stands
    as long as its evidence does (an external scaler polls the gauge
    or /debug/fleet/status whenever it likes). Flap control is
    layered: hysteresis (separate out/in bars with a hold band
    between), a cooldown after every adopted non-hold flip, and
    min/max replica bounds. Dropping back to ``hold`` is always
    immediate — recommending capacity churn on stale evidence is the
    one failure mode worse than flapping."""

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 8,
        burn_out: float = 1.0,
        burn_in: float = 0.5,
        occupancy_out: float = 0.85,
        occupancy_in: float = 0.5,
        brownout_out: int = 2,
        cooldown_s: float = 60.0,
    ) -> None:
        self.min_replicas = max(int(min_replicas), 0)
        self.max_replicas = max(int(max_replicas), self.min_replicas)
        self.burn_out = float(burn_out)
        # hysteresis: the scale-in bar must sit below the scale-out bar
        self.burn_in = min(float(burn_in), self.burn_out)
        self.occupancy_out = float(occupancy_out)
        self.occupancy_in = min(float(occupancy_in), self.occupancy_out)
        self.brownout_out = max(int(brownout_out), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._cooldown_until = float("-inf")
        self._current: Dict[str, object] = {
            "action": "hold", "delta": 0,
            "reason": "no rollup evaluated yet",
        }

    def _raw(self, rollup: Dict) -> Dict[str, object]:
        """The threshold verdict for one rollup, before cooldown."""
        routable = int(rollup.get("routable", 0))
        if routable <= 0:
            return {
                "action": "hold", "delta": 0,
                "reason": "no live signal digests",
            }
        burn = float(rollup.get("burn_worst", 0.0))
        occupancy = float(rollup.get("occupancy", 0.0))
        level = int(rollup.get("brownout_worst", 0))
        pressure = []
        if burn >= self.burn_out:
            pressure.append(
                f"worst burn {burn:.2f} >= {self.burn_out:.2f}"
            )
        if occupancy >= self.occupancy_out:
            pressure.append(
                f"occupancy {occupancy:.2f} >= {self.occupancy_out:.2f}"
            )
        if level >= self.brownout_out:
            pressure.append(
                f"brownout level {level} >= {self.brownout_out}"
            )
        if pressure:
            if routable >= self.max_replicas:
                return {
                    "action": "hold", "delta": 0,
                    "reason": (
                        f"{'; '.join(pressure)} but already at "
                        f"max_replicas={self.max_replicas}"
                    ),
                }
            return {
                "action": "scale_out", "delta": 1,
                "reason": "; ".join(pressure),
            }
        quiet = (
            burn <= self.burn_in
            and occupancy <= self.occupancy_in
            and level == 0
        )
        if quiet:
            if routable <= self.min_replicas:
                return {
                    "action": "hold", "delta": 0,
                    "reason": (
                        f"fleet quiet (burn {burn:.2f}, occupancy "
                        f"{occupancy:.2f}) but already at "
                        f"min_replicas={self.min_replicas}"
                    ),
                }
            return {
                "action": "scale_in", "delta": -1,
                "reason": (
                    f"fleet quiet: worst burn {burn:.2f} <= "
                    f"{self.burn_in:.2f}, occupancy {occupancy:.2f} <= "
                    f"{self.occupancy_in:.2f}, all replicas normal"
                ),
            }
        return {
            "action": "hold", "delta": 0,
            "reason": (
                f"between thresholds (worst burn {burn:.2f}, occupancy "
                f"{occupancy:.2f}, brownout level {level}) — hysteresis"
            ),
        }

    def decide(self, rollup: Dict, now: float) -> Dict[str, object]:
        """One evaluation: adopt the threshold verdict, gated by the
        cooldown. A non-hold verdict DIFFERENT from the current one is
        adopted only after the cooldown since the last flip; falling
        back to hold is immediate (and restarts the cooldown, so the
        next flip dwells too)."""
        raw = self._raw(rollup)
        current_action = str(self._current.get("action", "hold"))
        if raw["action"] == current_action:
            self._current = raw  # refresh the reason/evidence in place
        elif raw["action"] == "hold":
            self._current = raw
            self._cooldown_until = now + self.cooldown_s
        elif now >= self._cooldown_until:
            self._current = raw
            self._cooldown_until = now + self.cooldown_s
        else:
            self._current = {
                "action": "hold", "delta": 0,
                "reason": (
                    f"cooldown: {raw['action']} indicated "
                    f"({raw['reason']}) but "
                    f"{self._cooldown_until - now:.1f}s of dwell remain"
                ),
            }
        return dict(self._current)


class FleetObservatory:
    """One replica's observatory agent: publish this replica's signal
    digest on the membership beat, collect every peer's digest, join
    them into the fleet rollup, and run the autoscale recommender.
    All marker IO runs against the **shared** tier (``storage.shared``
    — the L2 when tiered), the same durable home as member markers."""

    def __init__(
        self,
        storage,
        replica_id: str,
        *,
        enabled: bool = False,
        ttl_s: float = 15.0,
        membership=None,
        window: Optional[SignalWindow] = None,
        slo=None,
        brownout=None,
        supervisor=None,
        metrics=None,
        recommender: Optional[AutoscaleRecommender] = None,
        drain_enabled: bool = False,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.storage = storage
        self.replica_id = str(replica_id or "").rstrip("/")
        self.ttl_s = max(float(ttl_s), 0.1)
        self.membership = membership
        self.window = window if window is not None else SignalWindow()
        self.slo = slo
        self.brownout = brownout
        self.supervisor = supervisor
        self.metrics = metrics
        self.recommender = (
            recommender if recommender is not None else AutoscaleRecommender()
        )
        self.drain_enabled = bool(drain_enabled)
        # wall clock, not monotonic: digest timestamps are compared
        # ACROSS replicas (each reader against its own clock — the
        # skew cases are pinned in tests/test_torch_fleet_observatory.py)
        self._clock = clock
        # optional runtime.tiersupervisor.TierSupervisor wired by the
        # app: while islanded the whole digest beat short-circuits and
        # the previous rollup keeps feeding the gauges, loudly labeled
        # stale (docs/resilience.md "Shared-tier outage survival")
        self.tier_supervisor = None
        # one token per agent lifetime: close() must never delete a
        # digest another process (same replica id, config error)
        # overwrote — the membership/L2Lease release discipline
        self._token = uuid.uuid4().hex
        self._lock = threading.Lock()
        # the last collected digest set (by replica); collection
        # failures keep the previous one — the rollup degrades to the
        # last known world, never to an empty fleet
        self._digests: Dict[str, dict] = {}
        self._rollup: Dict[str, object] = {}
        self._recommendation: Dict[str, object] = {
            "action": "hold", "delta": 0,
            "reason": "observatory has not evaluated yet",
        }
        self._publish_failures = 0
        # per-family (value, at) totals behind the digest's shed /
        # deadline per-second rates
        self._prev_totals: Dict[str, tuple] = {}
        # the digest has no publication cadence without the membership
        # beat, and no rollup without marker enumeration
        can_list = callable(getattr(storage, "list_names", None))
        member_ok = membership is not None and getattr(
            membership, "enabled", False
        )
        self.enabled = (
            bool(enabled) and bool(self.replica_id) and can_list and member_ok
        )
        if bool(enabled) and not self.enabled:
            logging.getLogger(LOGGER).warning(
                "fleet_observatory_enable is on but its substrate is "
                "not (needs fleet_membership_enable, fleet_replica_id, "
                "and a listing-capable shared tier); observatory stays "
                "disabled",
            )
        if self.enabled and self.metrics is not None:
            self._register_metrics(self.metrics)

    # -- metrics -----------------------------------------------------------

    def _register_metrics(self, registry) -> None:
        """The flyimg_fleet_* rollup gauges — registered only when
        enabled, so off-is-off byte identity covers /metrics too.
        Render-time callbacks: a scrape always reads the latest
        assembled rollup, whatever the scrape/beat phase."""
        from flyimg_tpu_torch.runtime.brownout import LEVEL_NAMES

        for status in ("ready", "degraded", "draining"):
            registry.gauge(
                f'flyimg_fleet_replicas{{status="{status}"}}',
                "Fleet replicas by published digest status, from the "
                "observatory rollup",
                fn=lambda s=status: float(
                    (self._rollup.get("by_status") or {}).get(s, 0)
                ),
            )
        registry.gauge(
            "flyimg_fleet_burn_worst",
            "Worst normalized SLO burn across live fleet digests "
            "(1.0 = that replica's brownout threshold)",
            fn=lambda: float(self._rollup.get("burn_worst", 0.0)),
        )
        registry.gauge(
            "flyimg_fleet_burn_weighted",
            "Request-weighted mean normalized SLO burn across live "
            "fleet digests",
            fn=lambda: float(self._rollup.get("burn_weighted", 0.0)),
        )
        registry.gauge(
            "flyimg_fleet_occupancy",
            "Launch-weighted mean device batch occupancy across live "
            "fleet digests",
            fn=lambda: float(self._rollup.get("occupancy", 0.0)),
        )
        for level_name in LEVEL_NAMES.values():
            registry.gauge(
                f'flyimg_fleet_pressure_level{{level="{level_name}"}}',
                "Fleet replicas at each brownout level (the fleet "
                "pressure histogram), from the observatory rollup",
                fn=lambda n=level_name: float(
                    (self._rollup.get("pressure_levels") or {}).get(n, 0)
                ),
            )
        registry.gauge(
            "flyimg_fleet_autoscale_recommendation",
            "Autoscale recommendation: 1 scale_out, -1 scale_in, "
            "0 hold",
            fn=lambda: float(
                {"scale_out": 1.0, "scale_in": -1.0}.get(
                    str(self._recommendation.get("action")), 0.0
                )
            ),
        )
        registry.gauge(
            "flyimg_fleet_autoscale_delta",
            "Recommended integer replica delta (0 while holding)",
            fn=lambda: float(self._recommendation.get("delta", 0) or 0),
        )

    def _count_skip(self, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                f'flyimg_fleet_digest_skipped_total{{reason="{reason}"}}',
                "Signal digests excluded from the fleet rollup "
                "(stale = older than its TTL, corrupt = unreadable or "
                "not JSON, alien = wrong schema version or no replica, "
                "island = whole beat short-circuited by tier island "
                "mode)",
            ).inc()

    # -- digest marker IO --------------------------------------------------

    def _digest_name(self) -> str:
        from flyimg_tpu_torch.runtime.membership import member_slug

        return digest_name(member_slug(self.replica_id))

    def _rate(self, key: str, total: float, now: float) -> float:
        """Per-second rate of one monotone counter family since the
        previous digest publish (0.0 on the first beat)."""
        prev = self._prev_totals.get(key)
        self._prev_totals[key] = (total, now)
        if prev is None:
            return 0.0
        prev_total, prev_at = prev
        dt = now - prev_at
        if dt <= 0.0:
            return 0.0
        return round(max(total - prev_total, 0.0) / dt, 4)

    def _digest_doc(self) -> dict:
        now = self._clock()
        signals: Dict[str, object] = {}
        window = self.window.assemble()
        device = (window.get("controllers") or {}).get("device") or {}
        signals["occupancy"] = round(
            float(device.get("mean_occupancy", 0.0)), 4
        )
        signals["launches_delta"] = float(
            device.get("launches_delta", 0.0)
        )
        if self.slo is not None and getattr(self.slo, "enabled", False):
            try:
                signals.update(self.slo.digest_fields())
            except Exception:
                pass
        if self.brownout is not None:
            try:
                signals["brownout_level"] = int(self.brownout.level())
                signals["brownout_pressure"] = round(
                    float(self.brownout.pressure()), 4
                )
            except Exception:
                pass
        backend = "device"
        if self.supervisor is not None:
            try:
                if self.supervisor.cpu_forced():
                    backend = "cpu"
            except Exception:
                pass
        signals["backend"] = backend
        if self.metrics is not None:
            signals["queue_depth"] = self.metrics.family_total(
                "flyimg_batcher_queue_depth"
            )
            signals["shed_rate"] = self._rate(
                "shed",
                self.metrics.family_total("flyimg_shed_total"),
                now,
            )
            signals["deadline_rate"] = self._rate(
                "deadline",
                self.metrics.family_total("flyimg_deadline_exceeded_total"),
                now,
            )
        status = "ready"
        if self.membership is not None:
            try:
                status = self.membership.current_status()
            except Exception:
                pass
        return {
            "v": DIGEST_VERSION,
            "replica": self.replica_id,
            "status": status,
            "token": self._token,
            "renewed_at": now,
            "ttl_s": self.ttl_s,
            "signals": signals,
        }

    def publish(self) -> bool:
        """One digest write, riding the membership beat. Failure is
        counted and absorbed — the next beat retries; peers roll up
        without us until then (advisory telemetry, never a failed
        request)."""
        if not self.enabled:
            return False
        try:
            doc = self._digest_doc()
            # fault hook: digest IO shares the fleet.member point
            # (runtime/membership.py) with op="digest*" so one injector
            # plan scripts both marker families
            faults.fire(
                "fleet.member", op="digest", name=self._digest_name(),
                replica=self.replica_id,
            )
            self.storage.write(
                self._digest_name(),
                json.dumps(doc, sort_keys=True).encode("utf-8"),
            )
            if self.tier_supervisor is not None:
                self.tier_supervisor.record_success("member")
            return True
        except Exception as exc:
            self._publish_failures += 1
            if self.tier_supervisor is not None:
                self.tier_supervisor.record_failure("member")
            if self.metrics is not None:
                self.metrics.counter(
                    "flyimg_fleet_digest_failures_total",
                    "Signal digest writes that failed (retried next "
                    "beat; peers roll up without this replica until "
                    "then)",
                ).inc()
            logging.getLogger(LOGGER).warning(
                "signal digest publish failed (next beat retries): %s",
                exc,
            )
            return False

    def _expired(self, doc: dict) -> bool:
        """Reader-clock expiry — the membership/L2Lease idiom: a digest
        is stale when the READER's clock says its renewal is older than
        its TTL; a renewed_at in the reader's future (publisher clock
        ahead) clamps to age zero, so skew only extends a digest's
        life, never evicts a healthy publisher. Malformed timestamps
        are stale."""
        try:
            renewed = float(doc.get("renewed_at", 0.0))
            ttl = float(doc.get("ttl_s", self.ttl_s))
        except (TypeError, ValueError):
            return True
        return max(self._clock() - renewed, 0.0) > ttl

    def collect(self) -> Optional[Dict[str, dict]]:
        """Read every live peer digest. Returns {replica: doc}, or
        None when enumeration failed (the previous digest set keeps
        feeding the rollup). Stale digests are excluded and counted;
        corrupt (unreadable / not JSON) and alien (wrong version, no
        replica) ones are counted and skipped."""
        if not self.enabled:
            return None
        try:
            faults.fire(
                "fleet.member", op="digest-list", name=DIGEST_PREFIX,
                replica=self.replica_id,
            )
            names = self.storage.list_names(DIGEST_PREFIX)
        except Exception as exc:
            logging.getLogger(LOGGER).warning(
                "signal digest listing failed (keeping the previous "
                "rollup): %s", exc,
            )
            return None
        digests: Dict[str, dict] = {}
        for name in sorted(str(n) for n in names or ()):
            if not name.endswith(DIGEST_SUFFIX):
                continue
            try:
                faults.fire(
                    "fleet.member", op="digest-read", name=name,
                    replica=self.replica_id,
                )
                doc = json.loads(self.storage.read(name).decode("utf-8"))
            except Exception:
                self._count_skip("corrupt")
                continue
            if not isinstance(doc, dict):
                self._count_skip("corrupt")
                continue
            if doc.get("v") != DIGEST_VERSION or not str(
                doc.get("replica", "")
            ).strip():
                self._count_skip("alien")
                continue
            if self._expired(doc):
                self._count_skip("stale")
                continue
            digests[str(doc["replica"]).rstrip("/")] = doc
        return digests

    # -- rollup + recommendation -------------------------------------------

    def _assemble_rollup(self, digests: Dict[str, dict]) -> Dict[str, object]:
        from flyimg_tpu_torch.runtime.brownout import LEVEL_NAMES

        by_status: Dict[str, int] = {
            "ready": 0, "degraded": 0, "draining": 0,
        }
        pressure_levels: Dict[str, int] = {
            name: 0 for name in LEVEL_NAMES.values()
        }
        burn_worst = 0.0
        burn_acc = weight_acc = 0.0
        occ_acc = occ_weight = 0.0
        brownout_worst = 0
        ready_members: List[str] = []
        for replica in sorted(digests):
            doc = digests[replica]
            status = str(doc.get("status", "ready"))
            by_status[status] = by_status.get(status, 0) + 1
            if status == "ready":
                ready_members.append(replica)
            sig = doc.get("signals") or {}
            try:
                burn = max(
                    float(sig.get("burn_fast_norm", 0.0)),
                    float(sig.get("burn_slow_norm", 0.0)),
                )
            except (TypeError, ValueError):
                burn = 0.0
            burn_worst = max(burn_worst, burn)
            # request-weighted mean: an idle replica's zero burn must
            # not wash out one drowning replica that carries the load
            try:
                weight = max(float(sig.get("window_requests", 0.0)), 1.0)
            except (TypeError, ValueError):
                weight = 1.0
            burn_acc += burn * weight
            weight_acc += weight
            try:
                level = int(sig.get("brownout_level", 0))
            except (TypeError, ValueError):
                level = 0
            brownout_worst = max(brownout_worst, level)
            name = LEVEL_NAMES.get(level)
            if name is not None:
                pressure_levels[name] += 1
            # occupancy weighted by recent launches: a quiet replica's
            # empty window says nothing about fleet batch packing
            try:
                occ = float(sig.get("occupancy", 0.0))
                launches = max(float(sig.get("launches_delta", 0.0)), 0.0)
            except (TypeError, ValueError):
                occ, launches = 0.0, 0.0
            occ_acc += occ * (launches or 1.0)
            occ_weight += launches or 1.0
        return {
            "replicas": len(digests),
            "routable": by_status["ready"] + by_status["degraded"],
            "by_status": by_status,
            "burn_worst": round(burn_worst, 4),
            "burn_weighted": round(
                burn_acc / weight_acc if weight_acc else 0.0, 4
            ),
            "occupancy": round(
                occ_acc / occ_weight if occ_weight else 0.0, 4
            ),
            "pressure_levels": pressure_levels,
            "brownout_worst": brownout_worst,
            "ready_members": ready_members,
        }

    def on_beat(self) -> None:
        """One observatory beat, piggybacked on the membership
        heartbeat (runtime/membership.py step): publish our digest,
        collect the fleet's, assemble the rollup, run the recommender,
        and honor a scale-in inward when nominated. Every step absorbs
        its own failures — the beat never dies and never fails a
        request."""
        if not self.enabled:
            return
        tier = self.tier_supervisor
        if tier is not None and tier.islanded():
            # island mode: publish + collect would each pay the dead
            # tier's timeouts for nothing. Keep the previous rollup
            # feeding the gauges, but degrade LOUDLY: skip counted,
            # rollup stale-labeled in /debug/fleet/status until the
            # first post-re-promotion beat reassembles it fresh.
            tier.count_skip("digest")
            self._count_skip("island")
            with self._lock:
                if self._rollup:
                    self._rollup = dict(self._rollup, stale=True)
            return
        self.publish()
        collected = self.collect()
        with self._lock:
            if collected is not None:
                self._digests = collected
            digests = dict(self._digests)
        rollup = self._assemble_rollup(digests)
        decision = self.recommender.decide(rollup, self._clock())
        with self._lock:
            previous = str(self._recommendation.get("action", "hold"))
            self._rollup = rollup
            self._recommendation = decision
        action = str(decision.get("action", "hold"))
        if action != previous:
            # edge-triggered: one structured line per recommendation
            # flip, carrying the triggering window's evidence — the
            # line an external scaler (or an operator's grep) acts on
            if self.metrics is not None:
                self.metrics.counter(
                    "flyimg_fleet_autoscale_transitions_total"
                    f'{{to="{action}"}}',
                    "Autoscale recommendation flips by destination "
                    "action (edge-triggered, one per change)",
                ).inc()
            logging.getLogger(LOGGER).info(
                "autoscale recommendation changed: %s -> %s (%s)",
                previous, action, decision.get("reason"),
                extra={
                    "event": "fleet.autoscale_recommendation",
                    "action": action,
                    "previous": previous,
                    "delta": decision.get("delta"),
                    "reason": decision.get("reason"),
                    "evidence": rollup,
                    "replica": self.replica_id or None,
                },
            )
        if action == "scale_in":
            self._maybe_drain(rollup)

    def _maybe_drain(self, rollup: Dict[str, object]) -> None:
        """Honor a scale-in recommendation inward through membership's
        graceful-drain path. Every replica runs the same recommender
        over the same rollup, so the drain candidate self-selects with
        no coordination: the LAST sorted ready member drains (degraded
        replicas are already limping and draining ones already going —
        the choice is arbitrary but fleet-wide agreed). Gated by
        ``fleet_autoscale_drain`` (default off: recommend-only, an
        external scaler owns capacity)."""
        if not self.drain_enabled or self.membership is None:
            return
        ready = list(rollup.get("ready_members") or [])
        if len(ready) <= self.recommender.min_replicas:
            return
        if not ready or ready[-1] != self.replica_id:
            return
        logging.getLogger(LOGGER).info(
            "autoscale scale-in nominated this replica to drain",
            extra={
                "event": "fleet.autoscale_drain",
                "replica": self.replica_id or None,
                "ready_members": ready,
            },
        )
        self.membership.begin_drain()

    # -- lifecycle + introspection -----------------------------------------

    def close(self) -> None:
        """Release this replica's digest marker (token-checked, like
        the member marker — a foreign digest under our name is left
        for ITS owner; the TTL reclaims anything undeletable)."""
        if not self.enabled:
            return
        tier = self.tier_supervisor
        if tier is not None and tier.islanded():
            tier.count_skip("digest")
            return  # the TTL reclaims the marker
        try:
            raw = self.storage.read(self._digest_name())
            doc = json.loads(raw.decode("utf-8"))
            if not isinstance(doc, dict) or doc.get("token") == self._token:
                self.storage.delete(self._digest_name())
        except Exception:
            pass  # absent already, or the TTL reclaims it

    def snapshot(self) -> Dict[str, object]:
        """The observatory's slice of /debug/fleet/status: the live
        digest set, the assembled rollup, and the current
        recommendation."""
        with self._lock:
            digests = {k: dict(v) for k, v in self._digests.items()}
            rollup = dict(self._rollup)
            recommendation = dict(self._recommendation)
        return {
            "enabled": self.enabled,
            "replica_id": self.replica_id,
            "ttl_s": self.ttl_s,
            "drain_enabled": self.drain_enabled,
            "publish_failures": self._publish_failures,
            "digests": digests,
            "rollup": rollup,
            "recommendation": recommendation,
        }

    @classmethod
    def from_params(
        cls, params, *, storage, membership=None, window=None, slo=None,
        brownout=None, supervisor=None, metrics=None,
    ) -> "FleetObservatory":
        # clock injectable through the (non-YAML)
        # `fleet_observatory_clock` hook — wall clock like membership's:
        # digest ages are compared across processes
        clock = params.by_key("fleet_observatory_clock") or time.time
        recommender = AutoscaleRecommender(
            min_replicas=int(
                params.by_key("fleet_autoscale_min_replicas", 1)
            ),
            max_replicas=int(
                params.by_key("fleet_autoscale_max_replicas", 8)
            ),
            burn_out=float(params.by_key("fleet_autoscale_burn_out", 1.0)),
            burn_in=float(params.by_key("fleet_autoscale_burn_in", 0.5)),
            occupancy_out=float(
                params.by_key("fleet_autoscale_occupancy_out", 0.85)
            ),
            occupancy_in=float(
                params.by_key("fleet_autoscale_occupancy_in", 0.5)
            ),
            brownout_out=int(
                params.by_key("fleet_autoscale_brownout_out", 2)
            ),
            cooldown_s=float(
                params.by_key("fleet_autoscale_cooldown_s", 60.0)
            ),
        )
        return cls(
            storage,
            str(params.by_key("fleet_replica_id", "") or ""),
            enabled=bool(params.by_key("fleet_observatory_enable", False)),
            # digests expire on the SAME horizon as member markers: one
            # TTL bounds both "who is alive" and "whose signals count"
            ttl_s=float(params.by_key("fleet_membership_ttl_s", 15.0)),
            membership=membership,
            window=window,
            slo=slo,
            brownout=brownout,
            supervisor=supervisor,
            metrics=metrics,
            recommender=recommender,
            drain_enabled=bool(
                params.by_key("fleet_autoscale_drain", False)
            ),
            clock=clock,
        )
