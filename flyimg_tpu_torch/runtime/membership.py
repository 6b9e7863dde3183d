"""Elastic fleet membership: heartbeat markers, crash detection,
graceful drain. The port of ``flyimg_tpu/runtime/membership.py``
(docs/fleet.md "Membership and elasticity").

A static ``fleet_replicas`` list plus SIGHUP is operator-driven
membership: a crashed replica stays in every peer's rendezvous set
until a human intervenes, and a scale-out replica is invisible until
every peer's config is rewritten. This module makes the replica set
**self-assembling** on the infrastructure that already exists — the
shared L2 tier (storage/tiered.py) holds one TTL'd JSON *member
marker* per replica, written with the same clock-skew-tolerant
expiry idiom as ``L2Lease``:

- **announce/heartbeat**: each replica writes
  ``fleet-member--<slug>.member`` (storage.tiered.member_name) at
  boot and re-writes it every ``fleet_membership_heartbeat_s``; the
  marker carries the replica URL, a status (``ready`` | ``draining``
  | ``degraded``), the renewal timestamp, and the TTL. Write-then-
  confirm: the announce reads its marker back and logs LOUDLY when a
  foreign token survives (two processes configured with one replica
  id — a config error membership cannot fix, only surface).
- **watch**: the same background beat lists ``*.member`` markers,
  drops expired/malformed/draining ones, and feeds the assembled
  live set to ``FleetRouter.update_replicas`` (one atomic reference
  swap; HRW re-homes ONLY the changed replicas' keys). A replica
  that stops heartbeating — SIGKILL, panic, power loss — ages out of
  every peer's set within one TTL with no operator action.
- **graceful drain** (scale-in): ``begin_drain`` re-writes the
  marker with ``status: draining``; peers exclude draining members
  immediately (next watch beat, well before the TTL) while the
  departing replica finishes in-flight work through the existing
  bounded batcher/pipeline drains, then ``close`` deletes the marker
  (never a foreign one — token-checked like ``L2Lease.release``).
  ``/readyz`` walks ready -> draining -> gone.
- **degraded, not dead**: a replica whose device backend failed over
  to CPU (runtime/devicesupervisor.py) keeps heartbeating with
  ``status: degraded`` — it stays IN the membership (its cache hits
  and CPU renders still serve) and the existing per-peer device-
  health gate (runtime/fleet.py) routes owned keys around it.

Marker IO is **advisory liveness, never correctness** — the same
posture as the lease protocol. A failed heartbeat write is counted
and retried next beat (worst case: peers age this replica out and
its keys re-home until the next successful beat); a failed list/read
during watch keeps the previous live set (routing continues against
the last known world). No marker failure is ever a request failure.

Split-brain guard: while membership is active the manual escape
hatches (``POST /debug/fleet/replicas``, the SIGHUP re-read) are
REJECTED in service/app.py — a manual swap would fight the watcher's
next beat and the two writers would flap the rendezvous set.

Inert by default: with ``fleet_membership_enable`` off (the default)
``FleetMembership.enabled`` is False — no markers, no thread, no
metrics, no readyz/debug content (byte-identity pinned by
tests/test_torch_fleet_membership.py).
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from flyimg_tpu_torch.storage.tiered import MEMBER_PREFIX, MEMBER_SUFFIX, member_name
from flyimg_tpu_torch.testing import faults

__all__ = ["FleetMembership", "member_slug"]

LOGGER = "flyimg.fleet"

#: marker statuses a watcher includes in the live routing set
_ROUTABLE = frozenset({"ready", "degraded"})


def member_slug(replica_id: str) -> str:
    """Flat, filesystem-safe marker slug for one replica id. Marker
    names MUST be flat: LocalStorage._path basenames every name, so a
    slash-containing name would silently collapse onto another's."""
    return re.sub(r"[^A-Za-z0-9._-]+", "-", str(replica_id)).strip("-")


class FleetMembership:
    """One replica's membership agent: announce, heartbeat, watch,
    drain. All marker IO runs against the **shared** tier
    (``storage.shared`` — the L2 when tiered), the same durable home
    as lease markers and variant manifests."""

    def __init__(
        self,
        storage,
        replica_id: str,
        router,
        *,
        enabled: bool = False,
        ttl_s: float = 15.0,
        heartbeat_s: float = 5.0,
        supervisor=None,
        warmstart=None,
        metrics=None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.storage = storage
        self.replica_id = str(replica_id or "").rstrip("/")
        self.router = router
        self.ttl_s = max(float(ttl_s), 0.1)
        self.heartbeat_s = max(float(heartbeat_s), 0.05)
        self.supervisor = supervisor
        self.warmstart = warmstart
        # fleet observatory (runtime/observatory.py), wired by the app
        # after construction (it needs this membership as its digest
        # status source): its digest publish + rollup + recommender
        # beat piggybacks on step() like the warm-start publish
        self.observatory = None
        self.metrics = metrics
        # wall clock, not monotonic: marker timestamps are compared
        # ACROSS replicas (each reader against its own clock — the
        # skew cases are pinned in tests/test_torch_fleet_membership.py)
        self._clock = clock
        # optional runtime.tiersupervisor.TierSupervisor wired by the
        # app: while islanded, heartbeat/watch marker IO short-circuits
        # and routing continues against the last live view (whose
        # staleness the gauge below surfaces)
        self.tier_supervisor = None
        # view staleness (satellite of docs/resilience.md "Shared-tier
        # outage survival"): age of the last successful marker listing.
        # A watcher silently frozen on its previous live set — outage,
        # islanding, or a misbehaving backend — is observable through
        # ``flyimg_fleet_view_stale_seconds`` / ``expired_view`` even
        # with the tier supervisor off.
        self._created_at = clock()
        self._last_list_ok_at: Optional[float] = None
        # one token per agent lifetime: close() must never delete a
        # marker another process (same replica id, config error)
        # overwrote — the L2Lease.release discipline
        self._token = uuid.uuid4().hex
        self._started_at: Optional[float] = None
        self._status = "ready"
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the last live set this watcher applied (None = never applied;
        # watch failures keep routing against the previous world)
        self._live: Optional[List[str]] = None
        self._heartbeat_failures = 0
        # capability gate: membership needs marker enumeration, which
        # only listing-capable shared backends provide (LocalStorage;
        # docs/fleet.md "Membership and elasticity")
        can_list = callable(getattr(storage, "list_names", None))
        self.enabled = bool(enabled) and bool(self.replica_id) and can_list
        if bool(enabled) and bool(self.replica_id) and not can_list:
            logging.getLogger(LOGGER).warning(
                "fleet_membership_enable is on but the shared tier "
                "(%s) cannot enumerate markers (no list_names); "
                "membership stays disabled",
                type(storage).__name__,
            )
        if self.enabled and self.metrics is not None:
            # registered only when enabled: off-is-off byte identity
            # covers the /metrics exposition too
            self.metrics.gauge(
                "flyimg_fleet_members",
                "Live fleet members in this replica's rendezvous set",
                fn=self.member_count,
            )
            self.metrics.gauge(
                "flyimg_fleet_view_stale_seconds",
                "Age of the last successful membership marker listing "
                "— a frozen live view (outage, island mode) grows this "
                "past the membership TTL",
                fn=self.view_stale_seconds,
            )

    # -- marker IO ---------------------------------------------------------

    def _marker_name(self) -> str:
        return member_name(member_slug(self.replica_id))

    def current_status(self) -> str:
        """The status the next heartbeat will publish — also the
        status the observatory stamps on this replica's signal digest,
        so the two markers never disagree about one replica."""
        status = self._status
        if status == "ready" and self.supervisor is not None:
            try:
                if self.supervisor.cpu_forced():
                    # device-down replicas heartbeat as DEGRADED, not
                    # dead: they stay members (cache hits + CPU renders
                    # still serve) and the router's health gate routes
                    # owned keys around them
                    status = "degraded"
            except Exception:
                pass
        return status

    def _marker_doc(self) -> dict:
        return {
            "replica": self.replica_id,
            "status": self.current_status(),
            "token": self._token,
            "started_at": self._started_at,
            "renewed_at": self._clock(),
            "ttl_s": self.ttl_s,
        }

    def _write_marker(self, purpose: str = "write") -> bool:
        """One heartbeat write. Failure is counted and absorbed — the
        next beat retries; peers age us out only after the TTL.
        Islanded, the write is skipped outright (not a failure — the
        tier supervisor already knows; peers age us out after the TTL
        exactly as if the write had failed, and re-promotion's next
        beat re-announces us)."""
        tier = self.tier_supervisor
        if tier is not None and tier.islanded():
            tier.count_skip("heartbeat")
            return False
        try:
            # fault hook (testing/faults.py fleet.member)
            faults.fire(
                "fleet.member", op=purpose, name=self._marker_name(),
                replica=self.replica_id,
            )
            self.storage.write(
                self._marker_name(),
                json.dumps(self._marker_doc(), sort_keys=True).encode(
                    "utf-8"
                ),
            )
            if tier is not None:
                tier.record_success("member")
            return True
        except Exception as exc:
            self._heartbeat_failures += 1
            if tier is not None:
                tier.record_failure("member")
            if self.metrics is not None:
                self.metrics.counter(
                    "flyimg_fleet_heartbeat_failures_total",
                    "Membership marker writes that failed (retried "
                    "next beat; peers age this replica out after the "
                    "TTL)",
                ).inc()
            logging.getLogger(LOGGER).warning(
                "membership heartbeat write failed (next beat "
                "retries): %s", exc,
            )
            return False

    def _read_marker(self, name: str, purpose: str = "read") -> Optional[dict]:
        try:
            faults.fire(
                "fleet.member", op=purpose, name=name,
                replica=self.replica_id,
            )
            doc = json.loads(self.storage.read(name).decode("utf-8"))
        except Exception:
            return None  # absent or unreadable = not a live member
        return doc if isinstance(doc, dict) else None

    def _expired(self, doc: dict) -> bool:
        """Reader-clock expiry, the ``L2Lease._expired`` idiom: a
        marker is dead when the READER's clock says its renewal is
        older than the TTL. A renewed_at in the reader's future (the
        writer's clock runs ahead) reads as age zero — skew can only
        make a marker live LONGER, never evict a healthy replica; a
        writer whose clock runs behind burns its skew out of the TTL,
        which is why the TTL must comfortably exceed worst-case skew
        plus one heartbeat. Malformed markers are dead."""
        try:
            renewed = float(doc.get("renewed_at", 0.0))
            ttl = float(doc.get("ttl_s", self.ttl_s))
        except (TypeError, ValueError):
            return True
        return max(self._clock() - renewed, 0.0) > ttl

    # -- the beat ----------------------------------------------------------

    def announce(self) -> None:
        """First marker write, bracketed by two reads: a live FOREIGN
        token under our name — before the write, or surviving the
        confirm read-back — means another process announced the SAME
        replica id, a config error worth a loud log (routing still
        converges: both write the same id, last-write-wins)."""
        if not self.enabled:
            return
        self._started_at = self._clock()
        existing = self._read_marker(self._marker_name())
        foreign = (
            existing is not None
            and existing.get("token") not in (None, self._token)
            and not self._expired(existing)
        )
        if not self._write_marker():
            return
        confirm = self._read_marker(self._marker_name(), purpose="confirm")
        if foreign or (
            confirm is not None
            and confirm.get("token") not in (None, self._token)
        ):
            logging.getLogger(LOGGER).warning(
                "another live process already announced replica id %s "
                "(foreign membership marker token) — check for "
                "duplicate fleet_replica_id configuration",
                self.replica_id,
            )

    def watch(self) -> Optional[List[str]]:
        """Assemble the live set from markers and feed the router.
        Returns the applied set, or None when enumeration failed (the
        previous set keeps routing — membership degrades to the last
        known world, never to an empty one)."""
        if not self.enabled:
            return None
        tier = self.tier_supervisor
        if tier is not None and tier.islanded():
            # island mode: keep routing against the last live view
            # without paying the dead tier's listing timeout; the view
            # staleness gauge keeps growing, so the freeze is labeled
            tier.count_skip("watch")
            return None
        try:
            faults.fire(
                "fleet.member", op="list", name=MEMBER_PREFIX,
                replica=self.replica_id,
            )
            names = self.storage.list_names(MEMBER_PREFIX)
        except Exception as exc:
            if tier is not None:
                tier.record_failure("member")
            logging.getLogger(LOGGER).warning(
                "membership marker listing failed (keeping the "
                "previous live set): %s", exc,
            )
            return None
        self._last_list_ok_at = self._clock()
        if tier is not None:
            tier.record_success("member")
        live = set()
        for name in names or ():
            if not str(name).endswith(MEMBER_SUFFIX):
                continue
            doc = self._read_marker(str(name))
            if doc is None or self._expired(doc):
                continue
            if str(doc.get("status", "")) not in _ROUTABLE:
                continue  # draining members leave the set immediately
            replica = str(doc.get("replica", "")).rstrip("/")
            if replica:
                live.add(replica)
        if self._status in _ROUTABLE:
            # self is a member while serving even if our own marker
            # write is failing — local renders must keep resolving
            live.add(self.replica_id)
        applied = sorted(live)
        with self._lock:
            previous = self._live
            changed = applied != previous
            self._live = applied
        if changed:
            joined = sorted(set(applied) - set(previous or []))
            left = sorted(set(previous or []) - set(applied))
            self.router.update_replicas(
                applied, self_id=self.replica_id, source="membership"
            )
            if self.metrics is not None:
                for event, names_ in (("join", joined), ("leave", left)):
                    if names_:
                        self.metrics.counter(
                            "flyimg_fleet_membership_transitions_total"
                            f'{{event="{event}"}}',
                            "Membership transitions applied to the "
                            "rendezvous set by the watcher",
                        ).inc(len(names_))
            logging.getLogger(LOGGER).info(
                "membership live set changed",
                extra={
                    "event": "fleet.membership_changed",
                    "members": applied,
                    "joined": joined,
                    "left": left,
                    "replica": self.replica_id or None,
                },
            )
        return applied

    def step(self) -> None:
        """One beat: heartbeat + watch (+ warm-start publish when new
        programs were recorded). The background thread calls this on
        the heartbeat cadence; tests drive it directly with injected
        clocks so nothing sleeps."""
        if not self.enabled:
            return
        self._write_marker()
        self.watch()
        if self.warmstart is not None:
            # piggyback: the membership beat is the fleet's natural
            # publication cadence for the warm-start manifests
            try:
                self.warmstart.maybe_publish()
            except Exception as exc:
                logging.getLogger(LOGGER).warning(
                    "warm-start publish failed (next beat retries): "
                    "%s", exc,
                )
        if self.observatory is not None:
            # same piggyback: the signal digest publishes (and the
            # fleet rollup + autoscale recommendation re-assemble) on
            # the heartbeat cadence, the fleet's one shared-tier beat
            try:
                self.observatory.on_beat()
            except Exception as exc:
                logging.getLogger(LOGGER).warning(
                    "observatory beat failed (next beat retries): %s",
                    exc,
                )

    # -- lifecycle ---------------------------------------------------------

    @property
    def active(self) -> bool:
        """The split-brain guard's predicate: the watcher owns the
        replica set whenever membership is enabled (started or about
        to be) — manual set swaps must be rejected for the whole app
        lifetime, not only between start() and close()."""
        return self.enabled

    def start(self) -> None:
        """Announce and start the heartbeat/watch thread (daemon, like
        every other background worker here — it must never block
        interpreter exit)."""
        if not self.enabled or self._thread is not None:
            return
        self.announce()
        self.watch()
        if self.observatory is not None:
            # first digest publishes WITH the announce, not one
            # heartbeat later: a joining replica is observable the
            # moment it is routable
            try:
                self.observatory.on_beat()
            except Exception as exc:
                logging.getLogger(LOGGER).warning(
                    "observatory boot beat failed (next beat "
                    "retries): %s", exc,
                )

        def run() -> None:
            while not self._stop.wait(self.heartbeat_s):
                try:
                    self.step()
                except Exception as exc:  # the beat must never die
                    logging.getLogger(LOGGER).warning(
                        "membership beat failed: %s", exc
                    )

        self._thread = threading.Thread(
            target=run, name="flyimg-membership", daemon=True
        )
        self._thread.start()

    def begin_drain(self) -> None:
        """Graceful scale-in, phase 1 (service/app.py ``begin_drain``):
        flip the marker to ``draining`` so peers stop routing owned
        keys here on their next watch beat — BEFORE the bounded
        batcher/pipeline drains run. In-flight and straggler requests
        still serve (the replica renders locally; the L2 write-through
        keeps results fleet-visible)."""
        if not self.enabled or self._status == "draining":
            return
        self._status = "draining"
        self._write_marker()
        from flyimg_tpu_torch.runtime import tracing

        tracing.add_event("fleet.member_drain", replica=self.replica_id)
        logging.getLogger(LOGGER).info(
            "membership drain announced",
            extra={
                "event": "fleet.member_drain",
                "replica": self.replica_id or None,
            },
        )

    def close(self) -> None:
        """Phase 2 (``server_close``, after the drains): stop the beat and
        release the marker — token-checked, so a foreign marker under
        our name (duplicate-id config error) is left for ITS owner."""
        if not self.enabled:
            return
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=max(self.heartbeat_s * 2, 1.0))
            self._thread = None
        tier = self.tier_supervisor
        if tier is not None and tier.islanded():
            # shutdown during an outage: skip the marker release rather
            # than paying its timeouts; the TTL reclaims it
            tier.count_skip("heartbeat")
            return
        try:
            doc = self._read_marker(self._marker_name())
            if doc is None or doc.get("token") == self._token:
                faults.fire(
                    "fleet.member", op="delete",
                    name=self._marker_name(), replica=self.replica_id,
                )
                self.storage.delete(self._marker_name())
        except Exception as exc:
            # the TTL reclaims an undeletable marker eventually
            logging.getLogger(LOGGER).warning(
                "membership marker release failed (TTL reclaims it): "
                "%s", exc,
            )

    # -- introspection -----------------------------------------------------

    def member_count(self) -> float:
        with self._lock:
            live = self._live
        return float(len(live)) if live is not None else 0.0

    def view_stale_seconds(self) -> float:
        """Age of the last successful marker listing (agent age when
        none ever succeeded) — the ``flyimg_fleet_view_stale_seconds``
        gauge. 0.0 while disabled."""
        if not self.enabled:
            return 0.0
        base = self._last_list_ok_at
        if base is None:
            base = self._created_at
        return max(self._clock() - base, 0.0)

    def expired_view(self) -> bool:
        """True when the live view is older than the membership TTL —
        every marker in it may have expired unseen, so routing runs on
        a world that can no longer be confirmed."""
        return self.enabled and self.view_stale_seconds() > self.ttl_s

    def members(self) -> List[str]:
        with self._lock:
            return list(self._live or [])

    def snapshot(self) -> Dict[str, object]:
        """The /debug/fleet document: self status, the applied live
        set, and every readable marker (expired ones tagged, so a
        wedged replica's stale marker is visible before it ages
        out)."""
        markers = []
        tier = self.tier_supervisor
        islanded = tier is not None and tier.islanded()
        try:
            names = [] if islanded else (
                self.storage.list_names(MEMBER_PREFIX) or []
            )
        except Exception:
            names = []
        for name in sorted(str(n) for n in names):
            if not name.endswith(MEMBER_SUFFIX):
                continue
            doc = self._read_marker(name)
            if doc is None:
                markers.append({"marker": name, "unreadable": True})
                continue
            markers.append({
                "marker": name,
                "replica": doc.get("replica"),
                "status": doc.get("status"),
                "renewed_at": doc.get("renewed_at"),
                "ttl_s": doc.get("ttl_s"),
                "expired": self._expired(doc),
            })
        return {
            "enabled": self.enabled,
            "replica_id": self.replica_id,
            "status": self._status,
            "ttl_s": self.ttl_s,
            "heartbeat_s": self.heartbeat_s,
            "members": self.members(),
            "heartbeat_failures": self._heartbeat_failures,
            "view_stale_seconds": round(self.view_stale_seconds(), 3),
            "expired_view": self.expired_view(),
            "markers": markers,
        }

    @classmethod
    def from_params(
        cls, params, *, storage, router, supervisor=None, warmstart=None,
        metrics=None,
    ) -> "FleetMembership":
        # clock injectable through the (non-YAML)
        # `fleet_membership_clock` hook — the same object-passing style
        # as brownout_clock/autotune_clock, so TTL/skew tests never
        # sleep. Wall clock default: markers are compared across
        # processes.
        clock = params.by_key("fleet_membership_clock") or time.time
        return cls(
            storage,
            str(params.by_key("fleet_replica_id", "") or ""),
            router,
            enabled=bool(params.by_key("fleet_membership_enable", False)),
            ttl_s=float(params.by_key("fleet_membership_ttl_s", 15.0)),
            heartbeat_s=float(
                params.by_key("fleet_membership_heartbeat_s", 5.0)
            ),
            supervisor=supervisor,
            warmstart=warmstart,
            metrics=metrics,
            clock=clock,
        )
