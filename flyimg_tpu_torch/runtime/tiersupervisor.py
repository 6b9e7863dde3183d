"""Shared-tier supervisor: L2 outage detection, island mode, journal
replay, and the anti-entropy scrubber. The port of
``flyimg_tpu/runtime/tiersupervisor.py`` (docs/resilience.md "Shared-tier
outage survival").

The shared L2 tier is the fleet's coordination substrate —
leases, variant manifests, membership markers, warm-start manifests and
signal digests all live there (the TensorFlow split of arXiv 1605.08695:
state in the storage tier, elastic stateless workers) — but every L2
failure is still handled per-op in isolation. During a full S3/GCS
outage each miss pays the L2 round trip *again* (the latency
amplification arXiv 2403.12981 shows dominates served latency),
membership silently freezes on a stale view, and every write-through
that failed during the outage is lost fleet-wide with no resync when the
tier returns. ``TierSupervisor`` is the device supervisor's treatment
applied to the storage tier:

- **Storm detection.** The existing ``l2.storage`` / lease / membership
  failure sites feed it outcomes: each L2 failure counts, any L2 success
  resets. When ``tier_storm_threshold`` consecutive failures land within
  ``tier_storm_window_s`` (both conditions — a slow trickle over hours
  is the per-op degrade paths' job, not a storm), the tier breaker
  trips into **island mode**.
- **Island mode.** Reads, writes, leases, heartbeats and digest beats
  short-circuit locally without paying per-op timeouts: L2 lookups
  degrade to L1 misses, lease dedup degrades to the per-process
  single-flight, membership keeps the last live view (its staleness
  labeled — ``flyimg_fleet_view_stale_seconds`` + ``expired_view`` in
  /debug/fleet), and the observatory rollup degrades loudly (previous
  rollup kept, stale-labeled, skip counted). Every skipped op is
  counted by site, so the outage's blast radius is measurable.
- **Write-behind journal.** While islanded (and on any pre-trip
  write-through failure) the supervisor records what the outage cost:
  content-addressed artifact names and variant-manifest merge intents,
  deduplicated, TTL'd, bounded (oldest dropped, overflow counted).
- **Probed re-promotion + replay.** A background prober exercises the
  raw L2 (write/read-back/delete of a probe object, through the
  ``l2.storage`` fault point so chaos plans govern it) every
  ``tier_probe_interval_s``; ``tier_probe_hysteresis`` consecutive
  clean probes re-promote — flap-damped exactly like the device
  supervisor (a re-trip shortly after a re-promotion doubles the clean
  probes required next time, capped 8x). Re-promotion first **replays
  the journal**: artifacts are re-written to the L2 from their L1
  copies (content-addressed, deterministic bytes — last-write-wins
  safe), manifests are merged by variant name into the live L2 doc
  (``variantindex.replay_manifest``) so a concurrent writer on another
  replica is never clobbered. Only then does the tier re-attach, so
  cross-replica reuse is restored instead of leaving permanent holes.
- **Anti-entropy scrubber.** A low-duty-cycle loop walks a bounded
  random sample of L2 artifacts per period and verifies the same
  magic-sniff integrity rule the handler applies at read time, plus
  the optional blake2b sidecar checksum written on write-through when
  ``l2_checksum_enable`` is on. Corrupt/torn entries are deleted from
  BOTH tiers (and discarded from the variant index) and counted, so
  one bad disk cannot serve garbage fleet-wide forever.

Like the lease protocol, all of this is **availability machinery,
never correctness**: artifact bytes are deterministic and
content-addressed, so the worst cost of any race (an island window's
journal overflowing, a replayed write racing a live one) is a reuse
miss or a redundant render — never wrong bytes.

Default OFF (``tier_supervisor_enable: false``): disabled, no storage
object carries a supervisor reference, no metrics register, no threads
exist, and serving is byte-identical (pinned by
tests/test_torch_tier_supervisor.py).
"""

from __future__ import annotations

import collections
import json
import logging
import random
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.testing import faults

__all__ = ["TierSupervisor", "ATTACHED", "ISLAND", "verify_artifact"]

TIER_LOGGER = "flyimg.tier"

#: supervisor states: whether the shared tier is serving L2 traffic
ATTACHED, ISLAND = "attached", "island"

#: flat name of the prober's scratch object in the L2 (written, read
#: back, deleted per probe; flat because LocalStorage basenames names)
PROBE_PREFIX = "tier-probe--"
PROBE_SUFFIX = ".probe"

#: shared-tier object-name suffixes that are fleet plumbing, not cache
#: artifacts — the scrubber never samples these (their integrity rules
#: are schema checks owned by their readers, not magic sniffs)
_NON_ARTIFACT_SUFFIXES = (
    ".lease", ".member", ".digest", ".probe", ".part",
    ".variants.json", ".json", ".b2",
)


def probe_name(replica_id: str) -> str:
    """Storage object name of one replica's tier probe scratch object."""
    import re

    slug = re.sub(r"[^A-Za-z0-9._-]+", "-", str(replica_id or "replica"))
    return f"{PROBE_PREFIX}{slug.strip('-') or 'replica'}{PROBE_SUFFIX}"


def verify_artifact(name: str, data: bytes,
                    sidecar: Optional[bytes]) -> Optional[str]:
    """Integrity verdict for one stored artifact: None when healthy (or
    unjudgeable), else the corruption reason. The magic-sniff rule is
    the handler's read-time ``_cache_entry_valid`` contract — every
    servable extension sniffs to its container, unknown extensions fail
    open; the sidecar check compares the stored blake2b hex digest
    written by the write-through (``l2_checksum_enable``)."""
    if not data:
        return "empty"
    if sidecar is not None:
        import hashlib

        expected = sidecar.decode("utf-8", "replace").strip()
        if expected and hashlib.blake2b(data).hexdigest() != expected:
            return "checksum"
    ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
    from flyimg_tpu_torch.codecs.sniff import sniff
    from flyimg_tpu_torch.service.output_image import EXT_TO_MIME

    expected_mime = EXT_TO_MIME.get(ext)
    if expected_mime is not None and sniff(data).mime != expected_mime:
        return "magic"
    return None


class TierSupervisor:
    """The shared-tier breaker + island/re-promotion state machine,
    the write-behind journal, and the scrubber loop."""

    def __init__(
        self,
        *,
        enabled: bool = False,
        storm_threshold: int = 5,
        storm_window_s: float = 30.0,
        probe_interval_s: float = 5.0,
        probe_hysteresis: int = 2,
        journal_max_entries: int = 512,
        journal_ttl_s: float = 900.0,
        scrub_enable: bool = False,
        scrub_interval_s: float = 60.0,
        scrub_sample: int = 8,
        replica_id: str = "",
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.storm_threshold = max(1, int(storm_threshold))
        self.storm_window_s = max(float(storm_window_s), 0.001)
        self.probe_interval_s = max(float(probe_interval_s), 0.05)
        self.probe_hysteresis = max(1, int(probe_hysteresis))
        self.journal_max_entries = max(1, int(journal_max_entries))
        self.journal_ttl_s = max(float(journal_ttl_s), 0.1)
        self.scrub_enable = bool(scrub_enable)
        self.scrub_interval_s = max(float(scrub_interval_s), 0.05)
        self.scrub_sample = max(1, int(scrub_sample))
        self.replica_id = str(replica_id or "")
        self._metrics = metrics
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._state = ATTACHED
        self._state_since = clock()
        # storm bookkeeping: consecutive L2 failures (reset by any L2
        # success) AND their timestamps (the rate half — the threshold
        # failures must fall inside the window)
        self._consecutive = 0
        self._window: Deque[float] = collections.deque()
        self._last_failure_site: Optional[str] = None
        # probe bookkeeping
        self._clean_probes = 0
        self._last_probe_outcome: Optional[str] = None
        self._probes_total = 0
        self._trips = 0
        self._repromotions = 0
        self._repromoting = False
        # flap damping, the device-supervisor discipline: an L2 that
        # answers the (tiny) probe but storms again under real traffic
        # would cycle island<->attached forever, paying a journal
        # replay per cycle. A trip landing within ``flap_window_s`` of
        # the last re-promotion doubles the clean probes required for
        # the NEXT re-promotion (capped 8x); a trip after a long
        # healthy stretch resets the multiplier.
        self.flap_window_s = self.storm_window_s * 10.0
        self._hysteresis_mult = 1
        self._last_repromote_at: Optional[float] = None
        # write-behind journal: insertion-ordered, deduplicated by
        # (kind, key) so a hot key's repeated renders cost one entry
        self._journal: "collections.OrderedDict[Tuple[str, str], dict]" = (
            collections.OrderedDict()
        )
        self._journal_dropped = 0
        self._island_skips = 0
        self._scrub_purged = 0
        # span events queued by the prober/scrub threads (no ambient
        # trace there), drained onto the next evaluated request — the
        # same discipline as brownout/device transitions
        self._pending_events: List[Dict[str, object]] = []
        # wiring (attach()): the TieredStorage whose L1 feeds replay and
        # whose ``shared`` property is the raw L2 the prober/scrubber
        # exercise, plus the variant index replay/discard target
        self._storage = None
        self._variant_index = None
        # thread state
        self._prober: Optional[threading.Thread] = None
        self._scrubber: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._scrub_wake = threading.Event()
        self._closed = False

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "TierSupervisor":
        clock = params.by_key("tier_supervisor_clock") or time.monotonic
        return cls(
            enabled=bool(params.by_key("tier_supervisor_enable", False)),
            storm_threshold=int(params.by_key("tier_storm_threshold", 5)),
            storm_window_s=float(params.by_key("tier_storm_window_s", 30.0)),
            probe_interval_s=float(
                params.by_key("tier_probe_interval_s", 5.0)
            ),
            probe_hysteresis=int(params.by_key("tier_probe_hysteresis", 2)),
            journal_max_entries=int(
                params.by_key("tier_journal_max_entries", 512)
            ),
            journal_ttl_s=float(params.by_key("tier_journal_ttl_s", 900.0)),
            scrub_enable=bool(params.by_key("tier_scrub_enable", False)),
            scrub_interval_s=float(
                params.by_key("tier_scrub_interval_s", 60.0)
            ),
            scrub_sample=int(params.by_key("tier_scrub_sample", 8)),
            replica_id=str(params.by_key("fleet_replica_id", "") or ""),
            metrics=metrics,
            clock=clock,
        )

    # -- wiring ------------------------------------------------------------

    def attach(self, *, storage=None, variant_index=None) -> None:
        """Wire the tiered storage (replay source/target + probe/scrub
        substrate) and the variant index (manifest replay + corrupt
        discard). Both optional for unit tests."""
        self._storage = storage
        self._variant_index = variant_index

    def register_metrics(self, registry) -> None:
        """The attachment gauge operators alert on plus the journal
        depth — registered only when enabled, so the default-off app's
        /metrics is byte-identical."""
        registry.gauge(
            "flyimg_tier_attached",
            "Shared-tier health: 1 attached to the L2, 0 islanded "
            "(serving single-replica from L1 only)",
            fn=lambda: 1.0 if self._state == ATTACHED else 0.0,
        )
        registry.gauge(
            "flyimg_tier_journal_depth",
            "Write-behind journal entries awaiting replay to the "
            "shared tier",
            fn=lambda: float(len(self._journal)),
        )

    # -- read surface ------------------------------------------------------

    def islanded(self) -> bool:
        """True while the tier breaker is tripped — every L2-facing
        module's short-circuit predicate (two attribute reads on the
        hot path; False the moment the knob is off)."""
        return self.enabled and self._state == ISLAND

    def state(self) -> str:
        return self._state

    def snapshot(self) -> Dict[str, object]:
        """The /debug/tier document (service/app.py)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "state": self._state,
                "state_age_s": round(self._clock() - self._state_since, 3),
                "storm": {
                    "threshold": self.storm_threshold,
                    "window_s": self.storm_window_s,
                    "consecutive_failures": self._consecutive,
                    "window_failures": len(self._window),
                    "last_failure_site": self._last_failure_site,
                },
                "probe": {
                    "interval_s": self.probe_interval_s,
                    "hysteresis": self.probe_hysteresis,
                    "hysteresis_mult": self._hysteresis_mult,
                    "clean_probes": self._clean_probes,
                    "last_outcome": self._last_probe_outcome,
                    "total": self._probes_total,
                },
                "journal": {
                    "depth": len(self._journal),
                    "max_entries": self.journal_max_entries,
                    "ttl_s": self.journal_ttl_s,
                    "dropped": self._journal_dropped,
                },
                "scrub": {
                    "enabled": self.scrub_enable,
                    "interval_s": self.scrub_interval_s,
                    "sample": self.scrub_sample,
                    "purged": self._scrub_purged,
                },
                "island_skips": self._island_skips,
                "trips": self._trips,
                "repromotions": self._repromotions,
            }

    # -- outcome feed ------------------------------------------------------

    def record_success(self, site: str) -> None:
        """One successful L2 operation anywhere (storage, lease marker,
        membership marker): the tier answered, so any storm-in-progress
        resets."""
        if not self.enabled:
            return
        with self._lock:
            self._consecutive = 0
            self._window.clear()

    def record_failure(self, site: str) -> None:
        """One failed L2 operation, already absorbed by its per-op
        degrade path (L1-miss serve, local lease leadership, heartbeat
        retry). The per-op paths own each individual failure; a
        sustained run of them IS the tier dying."""
        if not self.enabled:
            return
        trip = False
        with self._lock:
            now = self._clock()
            self._consecutive += 1
            self._last_failure_site = str(site)
            self._window.append(now)
            floor = now - self.storm_window_s
            while self._window and self._window[0] < floor:
                self._window.popleft()
            if (
                self._state == ATTACHED
                and self._consecutive >= self.storm_threshold
                and len(self._window) >= self.storm_threshold
            ):
                trip = True
        if trip:
            self._trip()

    def count_skip(self, op: str) -> None:
        """One L2 operation short-circuited by island mode — the
        outage's measurable blast radius."""
        with self._lock:
            self._island_skips += 1
        if self._metrics is not None:
            self._metrics.counter(
                f'flyimg_tier_island_skips_total{{op="{op}"}}',
                "Shared-tier operations short-circuited while islanded "
                "(served locally instead of paying the dead tier's "
                "per-op timeout)",
            ).inc()

    # -- the breaker -------------------------------------------------------

    def _trip(self) -> None:
        """The tier breaker trips: flip state NOW (every L2-facing
        module short-circuits from the next op on), then leave recovery
        to the background prober — unlike the device direction there is
        no executor to rebuild, so the trip itself is light enough for
        the request thread that delivered the final storm failure."""
        with self._lock:
            if self._state == ISLAND:
                return
            now = self._clock()
            self._state = ISLAND
            self._state_since = now
            self._trips += 1
            if (
                self._last_repromote_at is not None
                and now - self._last_repromote_at < self.flap_window_s
            ):
                # the re-promotion did not stick: demand more evidence
                # before the next one (flap damping)
                self._hysteresis_mult = min(self._hysteresis_mult * 2, 8)
            else:
                self._hysteresis_mult = 1
            self._clean_probes = 0
            self._pending_events.append({
                "name": "tier.island",
                "consecutive_failures": self._consecutive,
                "site": self._last_failure_site,
            })
        self._record_transition("island")
        logging.getLogger(TIER_LOGGER).error(
            "shared-tier failure storm: islanding (L2 short-circuited, "
            "write-behind journal armed)",
            extra={
                "event": "tier.island",
                "consecutive_failures": self._consecutive,
                "storm_threshold": self.storm_threshold,
                "site": self._last_failure_site,
            },
        )
        self._ensure_prober()

    # -- write-behind journal ----------------------------------------------

    def journal_artifact(self, name: str) -> None:
        """Record one artifact write-through the L2 never saw. Replay
        re-writes it from the L1 copy — content-addressed deterministic
        bytes, so last-write-wins replay is always safe."""
        if not self.enabled:
            return
        self._journal_put(("artifact", str(name)), {
            "kind": "artifact", "name": str(name), "at": self._clock(),
        })

    def journal_manifest(self, source_key: str, doc: dict) -> None:
        """Record one variant-manifest state the L2 never saw. The doc
        is this replica's full current view of the source; replay
        merges its variants into whatever the live L2 doc holds by then
        (``variantindex.replay_manifest``), so a concurrent writer on
        another replica is never clobbered."""
        if not self.enabled:
            return
        self._journal_put(("manifest", str(source_key)), {
            "kind": "manifest", "source_key": str(source_key),
            "doc": doc, "at": self._clock(),
        })

    def _journal_put(self, key: Tuple[str, str], entry: dict) -> None:
        with self._lock:
            if key in self._journal:
                del self._journal[key]  # refresh: newest state, newest slot
            self._journal[key] = entry
            while len(self._journal) > self.journal_max_entries:
                self._journal.popitem(last=False)
                self._journal_dropped += 1
                self._count_journal_drop("overflow")

    def _journal_drain(self) -> List[dict]:
        """Take every live journal entry (expired ones dropped and
        counted). Failed replays are re-queued by the caller."""
        with self._lock:
            entries = list(self._journal.values())
            self._journal.clear()
        floor = self._clock() - self.journal_ttl_s
        live = []
        for entry in entries:
            if float(entry.get("at", 0.0)) < floor:
                with self._lock:
                    self._journal_dropped += 1
                self._count_journal_drop("expired")
            else:
                live.append(entry)
        return live

    def _journal_requeue(self, entries: List[dict]) -> None:
        with self._lock:
            old = self._journal
            self._journal = collections.OrderedDict()
            for entry in entries:
                key = (str(entry.get("kind")),
                       str(entry.get("name") or entry.get("source_key")))
                self._journal[key] = entry
            # entries journaled DURING the failed replay keep their
            # newer state: they re-insert after the requeued ones
            for key, entry in old.items():
                if key in self._journal:
                    del self._journal[key]
                self._journal[key] = entry
            while len(self._journal) > self.journal_max_entries:
                self._journal.popitem(last=False)
                self._journal_dropped += 1
                self._count_journal_drop("overflow")

    def journal_snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._journal.values()]

    def _replay_journal(self) -> bool:
        """Replay every journaled intent against the raw L2. Returns
        True when the journal is fully drained; on the first L2 error
        the remaining entries (including the failed one) re-queue and
        re-promotion aborts — the prober re-evaluates from scratch."""
        storage = self._storage
        entries = self._journal_drain()
        if not entries:
            return True
        log = logging.getLogger(TIER_LOGGER)
        replayed = {"artifact": 0, "manifest": 0}
        for idx, entry in enumerate(entries):
            kind = str(entry.get("kind"))
            try:
                if kind == "artifact" and storage is not None:
                    if storage.replay_to_l2(str(entry["name"])):
                        replayed["artifact"] += 1
                    else:
                        # the L1 copy is gone (pruned during the
                        # island window): nothing to replay
                        with self._lock:
                            self._journal_dropped += 1
                        self._count_journal_drop("missing")
                elif kind == "manifest" and storage is not None:
                    from flyimg_tpu_torch.runtime.variantindex import (
                        replay_manifest,
                    )

                    replay_manifest(
                        getattr(storage, "shared", storage),
                        str(entry["source_key"]),
                        entry.get("doc") or {},
                    )
                    replayed["manifest"] += 1
            except Exception as exc:
                self._journal_requeue(entries[idx:])
                log.warning(
                    "journal replay failed at %s (%s); staying islanded "
                    "— the prober re-evaluates", kind, exc,
                )
                return False
        for kind, count in replayed.items():
            if count and self._metrics is not None:
                self._metrics.counter(
                    f'flyimg_tier_journal_replayed_total{{kind="{kind}"}}',
                    "Write-behind journal entries replayed into the "
                    "shared tier at re-promotion",
                ).inc(count)
        log.info(
            "journal replay complete",
            extra={
                "event": "tier.journal_replay",
                "artifacts": replayed["artifact"],
                "manifests": replayed["manifest"],
            },
        )
        return True

    # -- probing / re-promotion --------------------------------------------

    def _spawn(self, target, name: str = "flyimg-tier-supervisor") -> None:
        """Run ``target`` on a daemon thread (tests monkeypatch this to
        run inline for determinism). Never called under the lock."""
        threading.Thread(target=target, name=name, daemon=True).start()

    def _ensure_prober(self) -> None:
        """Start the background prober if none is running. The thread
        parks (and exits) once the state returns to ATTACHED; a later
        trip starts a fresh one."""
        with self._lock:
            if self._closed or (
                self._prober is not None and self._prober.is_alive()
            ):
                return
            thread = threading.Thread(
                target=self._probe_loop,
                name="flyimg-tier-prober",
                daemon=True,
            )
            self._prober = thread
        thread.start()

    def _probe_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self.probe_interval_s)
            self._wake.clear()
            if self._closed:
                return
            with self._lock:
                if self._state != ISLAND or self._repromoting:
                    if self._state == ATTACHED:
                        return  # re-promoted: park until the next trip
                    continue
            self.probe_and_handle()

    def probe(self) -> Tuple[bool, str]:
        """One direct L2 health check: write, read back, delete a tiny
        probe object against the RAW shared tier — island mode's
        short-circuits must never mask the probe, and chaos plans on
        the ``l2.storage`` point govern it like any other tier op. Any
        exception is a recorded outcome, never a crash."""
        storage = self._storage
        if storage is None:
            return False, "unattached"
        l2 = getattr(storage, "shared", storage)
        name = probe_name(self.replica_id)
        try:
            faults.fire("l2.storage", op="probe", name=name)
            payload = json.dumps({"at": self._clock()}).encode("utf-8")
            l2.write(name, payload)
            if l2.read(name) != payload:
                return False, "torn-read"
            l2.delete(name)
            return True, "ok"
        except Exception as exc:
            return False, f"error:{type(exc).__name__}"

    def probe_and_handle(self) -> bool:
        """One probe attempt + hysteresis bookkeeping (the prober
        loop's body, callable directly by tests and the outage
        smoke)."""
        ok, detail = self.probe()
        self._record_probe("ok" if ok else "dead")
        repromote = False
        with self._lock:
            self._probes_total += 1
            self._last_probe_outcome = detail
            if self._state != ISLAND or self._repromoting:
                return ok
            if ok:
                self._clean_probes += 1
                required = self.probe_hysteresis * self._hysteresis_mult
                if self._clean_probes >= required:
                    self._repromoting = True
                    repromote = True
            else:
                self._clean_probes = 0
        if repromote:
            self._repromote()
        return ok

    def _repromote(self) -> None:
        """N clean probes: replay the journal FIRST (requests keep
        short-circuiting, so replay never competes with per-op
        timeouts), then re-attach atomically. A replay failure keeps
        the island state and the un-replayed journal; the prober starts
        its hysteresis over."""
        log = logging.getLogger(TIER_LOGGER)
        try:
            if not self._replay_journal():
                with self._lock:
                    self._clean_probes = 0
                return
            with self._lock:
                self._state = ATTACHED
                self._state_since = self._clock()
                self._consecutive = 0
                self._window.clear()
                self._clean_probes = 0
                self._repromotions += 1
                self._last_repromote_at = self._clock()
                self._pending_events.append({"name": "tier.repromote"})
            self._record_transition("attached")
            log.warning(
                "shared tier revived: re-attached after journal replay",
                extra={"event": "tier.repromote"},
            )
        except Exception:
            log.exception("tier re-promotion failed; staying islanded")
        finally:
            with self._lock:
                self._repromoting = False

    # -- anti-entropy scrubber ---------------------------------------------

    def start(self) -> None:
        """Start the scrub loop (app startup). The prober starts on
        demand at the first trip; the scrubber is periodic for the
        whole app lifetime when enabled."""
        if not self.enabled or not self.scrub_enable:
            return
        with self._lock:
            if self._closed or (
                self._scrubber is not None and self._scrubber.is_alive()
            ):
                return
            thread = threading.Thread(
                target=self._scrub_loop,
                name="flyimg-tier-scrubber",
                daemon=True,
            )
            self._scrubber = thread
        thread.start()

    def _scrub_loop(self) -> None:
        while True:
            self._scrub_wake.wait(timeout=self.scrub_interval_s)
            self._scrub_wake.clear()
            if self._closed:
                return
            if self.islanded():
                continue  # nothing to scrub against a dead tier
            try:
                self.scrub_once()
            except Exception:  # the loop must never die
                logging.getLogger(TIER_LOGGER).exception(
                    "tier scrub pass failed"
                )

    def scrub_once(self) -> Dict[str, int]:
        """One scrub pass: sample up to ``tier_scrub_sample`` artifact
        names from the raw L2, verify each (magic sniff + optional
        blake2b sidecar), delete-and-count corrupt/torn entries from
        BOTH tiers and discard them from the variant index. Callable
        directly by tests and the outage smoke."""
        from flyimg_tpu_torch.storage.tiered import checksum_name

        result = {"scanned": 0, "purged": 0, "unreadable": 0}
        storage = self._storage
        if storage is None:
            return result
        l2 = getattr(storage, "shared", storage)
        lister = getattr(l2, "list_names", None)
        if not callable(lister):
            return result  # capability-gated, like membership
        try:
            names = lister("")
        except Exception:
            self.record_failure("scrub")
            return result
        candidates = [
            str(n) for n in names or ()
            if not str(n).endswith(_NON_ARTIFACT_SUFFIXES)
        ]
        if len(candidates) > self.scrub_sample:
            candidates = self._rng.sample(candidates, self.scrub_sample)
        log = logging.getLogger(TIER_LOGGER)
        for name in candidates:
            result["scanned"] += 1
            try:
                data = l2.read(name)
            except Exception:
                result["unreadable"] += 1
                self._count_scrub("unreadable")
                continue
            sidecar = None
            try:
                sidecar = l2.read(checksum_name(name))
            except Exception:
                sidecar = None  # no sidecar: magic sniff still judges
            reason = verify_artifact(name, data, sidecar)
            if reason is None:
                self._count_scrub("clean")
                continue
            self._purge(name, reason)
            result["purged"] += 1
            log.warning(
                "scrubber purged corrupt shared-tier artifact",
                extra={
                    "event": "tier.scrub_purge", "artifact": name,
                    "reason": reason,
                },
            )
        return result

    def _purge(self, name: str, reason: str) -> None:
        """Delete one corrupt artifact from both tiers (plus its
        sidecar) and drop it from the variant index, so it can neither
        serve nor seed reuse again."""
        from flyimg_tpu_torch.storage.tiered import checksum_name

        storage = self._storage
        try:
            storage.delete(name)  # TieredStorage.delete: both tiers
        except Exception as exc:
            logging.getLogger(TIER_LOGGER).warning(
                "scrub purge of %s failed: %s", name, exc
            )
        l2 = getattr(storage, "shared", storage)
        try:
            l2.delete(checksum_name(name))
        except Exception:
            pass  # absent sidecar, or the next scrub retries
        index = self._variant_index
        if index is not None:
            try:
                index.discard_name(name)
            except Exception:
                pass
        with self._lock:
            self._scrub_purged += 1
        self._count_scrub(f"purged-{reason}")

    # -- observability -----------------------------------------------------

    def evaluate(self) -> None:
        """Rides the request middleware next to brownout/autotuner/
        device-supervisor evaluation: drains span events queued by the
        prober/scrub threads onto THIS request's trace. One list check
        when idle; nothing at all when disabled."""
        if not self.enabled or not self._pending_events:
            return
        with self._lock:
            pending, self._pending_events = self._pending_events, []
        for event in pending:
            name = str(event.pop("name"))
            tracing.add_event(name, **event)

    def _record_transition(self, to: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_tier_transitions_total{{to="{to}"}}',
            "Shared-tier state transitions by destination (island = "
            "storm tripped the breaker, attached = re-promotion after "
            "journal replay)",
        ).inc()

    def _record_probe(self, outcome: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_tier_probe_total{{outcome="{outcome}"}}',
            "Shared-tier re-probe attempts by outcome",
        ).inc()

    def _count_journal_drop(self, reason: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_tier_journal_dropped_total{{reason="{reason}"}}',
            "Write-behind journal entries dropped un-replayed "
            "(overflow = bound hit while islanded, expired = older "
            "than the journal TTL, missing = L1 copy pruned before "
            "replay)",
        ).inc()

    def _count_scrub(self, outcome: str) -> None:
        if self._metrics is None:
            return
        self._metrics.counter(
            f'flyimg_tier_scrubbed_total{{outcome="{outcome}"}}',
            "Anti-entropy scrub verdicts per sampled L2 artifact "
            "(clean, unreadable, or purged-<reason> for deleted "
            "corrupt/torn entries)",
        ).inc()

    def close(self) -> None:
        """Stop the prober and the scrubber (app shutdown)."""
        self._closed = True
        self._wake.set()
        self._scrub_wake.set()
