"""Two-tier storage for the fleet serving tier: the port of
``flyimg_tpu/storage/tiered.py`` (docs/fleet.md).

One replica's output cache stops at its own disk: with N replicas behind
a load balancer, the same hot derived key misses on every one of them
and renders N times. ``TieredStorage`` promotes the existing
S3/GCS/local-dir backends into a **shared L2** behind the per-replica
**L1** — the TensorFlow-style split (arXiv 1605.08695) of placement
(which replica owns a key, runtime/fleet.py) from state (where the
bytes live, here):

- reads go L1 -> L2; an L2 hit is promoted (written back) into L1 so
  the next hit on this replica is local;
- writes go through to BOTH tiers, so any replica's render is every
  replica's cache hit (and every replica's reuse ancestor — the variant
  manifests live on the shared tier, see ``shared``);
- deletes (rf_1 refresh, corrupt-entry discard) remove BOTH copies, so
  a poisoned artifact cannot resurrect from the other tier.

``L2Lease`` extends the per-process single-flight table across replicas
with TTL'd lease marker objects IN the L2: the first replica to miss
writes ``<name>.lease`` and renders (the leader); concurrent missing
replicas see the live lease and poll for the artifact instead of
rendering a duplicate. The lease is **advisory dedup, never
correctness**: artifact writes are last-write-wins of deterministic
bytes either way, so the worst outcome of any race (two winners of one
expired lease, clock skew across replicas) is one redundant render —
exactly today's behavior. A crashed leader never wedges the key: the
lease expires after ``l2_lease_ttl_s`` and a waiting follower steals it
(docs/fleet.md "Failure modes").

Everything here is inert unless ``l2_enable`` is on —
``make_storage`` returns the plain single-tier backend otherwise, and
the off-is-off byte identity is pinned by tests/test_torch_fleet.py.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from typing import Callable, Optional

from flyimg_tpu_torch.storage.base import Storage
from flyimg_tpu_torch.testing import faults

LOGGER = "flyimg.fleet"

#: suffix of the lease marker object a leader writes next to the artifact
LEASE_SUFFIX = ".lease"

#: suffix of the optional blake2b integrity sidecar written next to each
#: L2 artifact on write-through (``l2_checksum_enable``); verified by the
#: anti-entropy scrubber (runtime/tiersupervisor.py)
CHECKSUM_SUFFIX = ".b2"

#: fleet-membership heartbeat markers (runtime/membership.py) live on the
#: same shared tier under a reserved flat prefix/suffix pair — flat
#: because LocalStorage basenames every object name
MEMBER_PREFIX = "fleet-member--"
MEMBER_SUFFIX = ".member"

#: fleet-observatory signal digests (runtime/observatory.py) ride the
#: same shared tier and the same flat-name discipline, published on the
#: membership heartbeat beat next to the member marker
DIGEST_PREFIX = "fleet-digest--"
DIGEST_SUFFIX = ".digest"


def lease_name(name: str) -> str:
    """Storage object name of the lease marker guarding ``name``."""
    return f"{name}{LEASE_SUFFIX}"


def member_name(slug: str) -> str:
    """Storage object name of the membership marker for a replica slug."""
    return f"{MEMBER_PREFIX}{slug}{MEMBER_SUFFIX}"


def digest_name(slug: str) -> str:
    """Storage object name of the signal digest for a replica slug."""
    return f"{DIGEST_PREFIX}{slug}{DIGEST_SUFFIX}"


def checksum_name(name: str) -> str:
    """Storage object name of the blake2b sidecar guarding ``name``."""
    return f"{name}{CHECKSUM_SUFFIX}"


class TieredStorage(Storage):
    """L1 (per-replica) + L2 (fleet-shared) behind the one Storage
    surface the handler consumes. The handler's read-time corrupt-entry
    sniffing applies unchanged to whatever tier served the bytes — and
    its discard deletes both copies."""

    def __init__(
        self, l1: Storage, l2: Storage, *, metrics=None,
        checksum_enable: bool = False,
    ) -> None:
        self._l1 = l1
        self._l2 = l2
        self.metrics = metrics
        self.checksum_enable = bool(checksum_enable)
        # optional runtime.tiersupervisor.TierSupervisor wired by the
        # app AFTER make_storage: feeds it L2 outcomes and obeys its
        # island short-circuits; None (the default) changes nothing
        self._supervisor = None

    @property
    def shared(self) -> Storage:
        """The fleet-shared tier — where cross-replica state (variant
        manifests, lease markers) must live. Plain backends return
        themselves (base.Storage.shared), so callers never branch."""
        return self._l2

    # -- tier supervisor wiring (runtime/tiersupervisor.py) ----------------

    def attach_supervisor(self, supervisor) -> None:
        self._supervisor = supervisor

    def _islanded(self, op: str) -> bool:
        """True when island mode short-circuits this L2 op (and counts
        the skip); always False without a supervisor."""
        sup = self._supervisor
        if sup is None or not sup.islanded():
            return False
        sup.count_skip(op)
        return True

    def _l2_ok(self) -> None:
        sup = self._supervisor
        if sup is not None:
            sup.record_success("storage")

    def _l2_failed(self) -> None:
        sup = self._supervisor
        if sup is not None:
            sup.record_failure("storage")

    def _journal(self, name: str) -> None:
        sup = self._supervisor
        if sup is not None:
            sup.journal_artifact(name)

    # -- reads -------------------------------------------------------------

    def has(self, name: str) -> bool:
        """L1 then L2; an L2 failure degrades to the L1 answer (a
        cross-tier existence check must never fail a request the L1
        could have served as a miss)."""
        if self._l1.has(name):
            return True
        if self._islanded("has"):
            return False
        try:
            faults.fire("l2.storage", op="has", name=name)
            found = self._l2.has(name)
        except Exception as exc:
            self._l2_failed()
            logging.getLogger(LOGGER).warning(
                "L2 existence check of %s failed (answering from L1 "
                "only): %s", name, exc,
            )
            return False
        self._l2_ok()
        return found

    def stat(self, name: str):
        """L1 then L2; an L2 failure degrades to absent, the same
        posture as ``has``/``fetch``."""
        st = self._l1.stat(name)
        if st is not None:
            return st
        if self._islanded("stat"):
            return None
        try:
            faults.fire("l2.storage", op="stat", name=name)
            st = self._l2.stat(name)
        except Exception as exc:
            self._l2_failed()
            logging.getLogger(LOGGER).warning(
                "L2 stat of %s failed (answering from L1 only): %s",
                name, exc,
            )
            return None
        self._l2_ok()
        return st

    def read(self, name: str) -> bytes:
        """L1 then L2, WITHOUT promotion: read() serves mutable shared
        state (variant manifests read through ``shared`` use the L2
        directly, but defensive callers may hit this path) where an L1
        copy would go stale the moment another replica updates the L2.
        Artifact promotion is fetch()'s job — artifacts are immutable."""
        try:
            return self._l1.read(name)
        except Exception:
            if self._islanded("read"):
                raise  # islanded: the L1 miss IS the answer
            return self._l2.read(name)

    def fetch(self, name: str) -> Optional[tuple]:
        got = self._l1.fetch(name)
        if got is not None:
            return got
        if self._islanded("read"):
            return None
        try:
            # fault hook (testing/faults.py l2.storage): a
            # raising plan models the shared tier going away mid-read —
            # which must degrade to an L1 miss (single-replica behavior
            # for this key), never fail the request
            faults.fire("l2.storage", op="read", name=name)
            got = self._l2.fetch(name)
        except Exception as exc:
            self._l2_failed()
            logging.getLogger(LOGGER).warning(
                "L2 read of %s failed (serving as a miss): %s", name, exc
            )
            return None
        self._l2_ok()
        if got is None:
            return None
        # promote: derived outputs are content-addressed and their bytes
        # deterministic, so an L1 copy can never go stale — the next hit
        # on this replica skips the L2 round trip entirely
        data, _stat = got
        try:
            self._l1.write(name, data)
        except Exception:
            pass  # promotion is an optimization; the serve proceeds
        if self.metrics is not None:
            self.metrics.counter(
                "flyimg_l2_promotions_total",
                "Shared-L2 hits promoted into this replica's L1",
            ).inc()
        return got

    # -- writes ------------------------------------------------------------

    def write(self, name: str, data: bytes) -> Optional[float]:
        """Write-through: L1 first (the local serve path), then L2. An
        L2 failure degrades to single-replica behavior for this key —
        counted, logged, journaled for replay (when the tier supervisor
        is wired), never a request failure. While islanded the L2 leg
        is skipped outright: the journal records the debt and the
        re-promotion replay pays it."""
        mtime = self._l1.write(name, data)
        if self._islanded("write"):
            self._journal(name)
            return mtime
        try:
            faults.fire("l2.storage", op="write", name=name)
            self._l2.write(name, data)
        except Exception as exc:
            self._l2_failed()
            self._journal(name)
            if self.metrics is not None:
                self.metrics.counter(
                    "flyimg_l2_writethrough_failures_total",
                    "Shared-L2 write-throughs that failed (served from "
                    "L1 only)",
                ).inc()
            logging.getLogger(LOGGER).warning(
                "L2 write-through of %s failed: %s", name, exc
            )
            return mtime
        self._l2_ok()
        self._write_sidecar(name, data)
        return mtime

    def _write_sidecar(self, name: str, data: bytes) -> None:
        """Best-effort blake2b sidecar next to a successful L2 write —
        the torn-write witness the scrubber verifies. Skipped for the
        sidecars themselves and for fleet plumbing written through this
        surface (leases/markers go via ``shared`` directly, but guard
        anyway)."""
        if not self.checksum_enable or name.endswith(CHECKSUM_SUFFIX):
            return
        import hashlib

        try:
            self._l2.write(
                checksum_name(name),
                hashlib.blake2b(data).hexdigest().encode("utf-8"),
            )
        except Exception as exc:
            logging.getLogger(LOGGER).warning(
                "L2 checksum sidecar write for %s failed: %s", name, exc
            )

    def replay_to_l2(self, name: str) -> bool:
        """Re-write one journaled artifact into the L2 from its L1 copy
        (runtime/tiersupervisor.py journal replay). Returns False when
        the L1 copy is gone (pruned during the island window — nothing
        left to replay); RAISES on L2 failure so the replay loop can
        abort and re-queue."""
        got = self._l1.fetch(name)
        if got is None:
            return False
        data, _stat = got
        faults.fire("l2.storage", op="replay", name=name)
        self._l2.write(name, data)
        self._write_sidecar(name, data)
        return True

    def delete(self, name: str) -> None:
        """L1 delete propagates (the caller's tier — a failure there is
        its problem to surface); the L2 leg is best-effort, so a dead
        shared tier can never wedge a corrupt-entry discard or an rf_1
        refresh. The partial-failure residual (L1 gone, L2 copy left)
        is bounded: a poisoned artifact that resurrects from the L2 is
        re-sniffed (and re-discarded) at read time, and the scrubber
        eventually purges it at the source."""
        self._l1.delete(name)
        if self._islanded("delete"):
            return
        try:
            faults.fire("l2.storage", op="delete", name=name)
            self._l2.delete(name)
        except Exception as exc:
            self._l2_failed()
            logging.getLogger(LOGGER).warning(
                "L2 delete of %s failed: %s", name, exc
            )
            return
        self._l2_ok()
        if self.checksum_enable and not name.endswith(CHECKSUM_SUFFIX):
            try:
                self._l2.delete(checksum_name(name))
            except Exception:
                pass  # orphan sidecar; the scrubber skips non-artifacts

    def public_url(self, name: str, request_base: Optional[str] = None) -> str:
        return self._l1.public_url(name, request_base)

    def __getattr__(self, name: str):
        # backend extras (LocalStorage.prune) surface only when the L1
        # actually has them, so hasattr() gates in service/app.py keep
        # answering truthfully for S3/GCS L1s
        if name == "prune":
            return getattr(self._l1, "prune")
        raise AttributeError(name)


class L2Lease:
    """Cross-replica single-flight over TTL'd lease markers in the L2.

    Protocol (docs/fleet.md "The lease protocol"):

    1. A replica that missed both tiers calls ``acquire(name)``. If no
       live lease exists it writes its own marker and **confirms by
       reading it back** — last-write-wins storage means the replica
       whose marker survives is the leader; the other sees a foreign
       token and becomes a follower. (Both may confirm in a tight race;
       the cost is one duplicate render, never wrong bytes.)
    2. The leader renders, writes the artifact through both tiers, then
       ``release``s (deletes its own marker — never a stolen one).
    3. Followers poll ``wait`` with backoff for the artifact, bounded by
       the request Deadline; when the lease expires or is released with
       no artifact (leader crashed, or rendered a never-cached degraded
       response), the next ``acquire`` steals it and renders.

    A lease held longer than ``ttl_s`` is simply expired — a slow-but-
    healthy leader past the TTL risks one duplicate render, which is
    why the TTL defaults well above any sane render time.
    """

    def __init__(
        self,
        storage: Storage,
        replica_id: str,
        *,
        ttl_s: float = 30.0,
        poll_s: float = 0.05,
        wait_cap_s: float = 120.0,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.storage = storage
        self.replica_id = replica_id or "replica"
        self.ttl_s = max(float(ttl_s), 0.1)
        self.poll_s = max(float(poll_s), 0.001)
        self.wait_cap_s = float(wait_cap_s)
        self._clock = clock
        self._sleep = sleep
        # optional runtime.tiersupervisor.TierSupervisor wired by the
        # app after handler construction: while islanded, acquire()
        # claims local leadership immediately (dedup degrades to the
        # per-process single-flight) instead of paying marker IO
        # against a dead tier
        self.supervisor = None
        # one unique token per acquisition attempt: the read-back
        # confirm must distinguish our marker from another replica's
        # written in the same race window (replica ids alone cannot —
        # one replica can race itself across worker threads, though the
        # process-local single-flight makes that rare)
        self._token = lambda: uuid.uuid4().hex
        # live follower count (handler._l2_coalesce brackets its poll
        # loop with begin_wait/end_wait): a replica whose threads are
        # parked behind a remote leader is LOADED, not idle — the
        # brownout engine reads this as the `l2_lease` pressure
        # component (runtime/brownout.py; docs/degradation.md)
        self._waiters_lock = threading.Lock()
        self._waiters = 0

    # -- follower-wait accounting ------------------------------------------

    def begin_wait(self) -> None:
        with self._waiters_lock:
            self._waiters += 1

    def end_wait(self) -> None:
        with self._waiters_lock:
            if self._waiters > 0:
                self._waiters -= 1

    @property
    def waiters(self) -> int:
        """Threads currently blocked polling for a remote leader's
        artifact — the brownout `l2_lease` pressure numerator."""
        with self._waiters_lock:
            return self._waiters

    # -- marker IO ---------------------------------------------------------

    def _read(self, name: str, purpose: str = "read") -> Optional[dict]:
        try:
            # fault hook (testing/faults.py l2.lease):
            # ``purpose`` distinguishes an ordinary liveness read from
            # acquire()'s write-confirm read-back — a raising plan on
            # ``confirm`` exercises the claim-leadership degrade path
            faults.fire("l2.lease", op=purpose, name=name)
            raw = self.storage.read(lease_name(name))
            doc = json.loads(raw.decode("utf-8"))
        except Exception:
            return None  # absent or unreadable = no live lease
        return doc if isinstance(doc, dict) else None

    def _expired(self, doc: dict) -> bool:
        try:
            acquired_at = float(doc.get("acquired_at", 0.0))
            ttl = float(doc.get("ttl_s", self.ttl_s))
        except (TypeError, ValueError):
            return True  # malformed marker: treat as stealable
        return self._clock() - acquired_at > ttl

    def _islanded(self, op: str) -> bool:
        sup = self.supervisor
        if sup is None or not sup.islanded():
            return False
        sup.count_skip(op)
        return True

    def holder(self, name: str) -> Optional[str]:
        """The replica id holding a LIVE lease on ``name``, or None."""
        if self._islanded("lease"):
            return None
        doc = self._read(name)
        if doc is None or self._expired(doc):
            return None
        return str(doc.get("owner") or "")

    def acquire(self, name: str) -> Optional[str]:
        """Try to become the leader for ``name``. Returns the winning
        acquisition token (pass to ``release``) or None when another
        replica holds a live lease. While islanded, leadership is
        claimed LOCALLY without marker IO: the per-process single-
        flight (service/handler._SingleFlight) still coalesces this
        replica's threads, and the worst cross-replica cost is the one
        duplicate render the protocol already accepts."""
        if self._islanded("lease"):
            return self._token()
        doc = self._read(name)
        if doc is not None and not self._expired(doc):
            return None
        token = self._token()
        marker = {
            "owner": self.replica_id,
            "token": token,
            "acquired_at": self._clock(),
            "ttl_s": self.ttl_s,
        }
        try:
            faults.fire("l2.lease", op="write", name=name)
            self.storage.write(
                lease_name(name),
                json.dumps(marker, sort_keys=True).encode("utf-8"),
            )
            confirm = self._read(name, purpose="confirm")
        except Exception as exc:
            # an L2 that cannot hold markers degrades to per-process
            # single-flight: claim leadership locally and render
            sup = self.supervisor
            if sup is not None:
                sup.record_failure("lease")
            logging.getLogger(LOGGER).warning(
                "lease write for %s failed (%s); rendering without "
                "cross-replica coalescing", name, exc,
            )
            return token
        sup = self.supervisor
        if sup is not None:
            sup.record_success("lease")
        if confirm is None or confirm.get("token") == token:
            # confirm None = a transient read error (or a racing delete)
            # right after our successful write: claim leadership rather
            # than follow — following would leave OUR live marker with
            # nobody rendering behind it until the TTL, while leading
            # costs at most the one duplicate render the protocol
            # already accepts (same posture as the write-failure path)
            return token
        return None  # lost the write race: the surviving marker leads

    def release(self, name: str, token: str) -> None:
        """Delete OUR marker (identified by ``token``); a marker stolen
        by another replica in the meantime is left untouched. Islanded,
        there is nothing to delete (local leadership wrote no marker;
        a pre-trip marker the TTL reclaims)."""
        if self._islanded("lease"):
            return
        try:
            doc = self._read(name)
            if doc is not None and doc.get("token") != token:
                return
            self.storage.delete(lease_name(name))
        except Exception as exc:
            # TTL expiry reclaims an undeletable marker eventually
            logging.getLogger(LOGGER).warning(
                "lease release for %s failed: %s", name, exc
            )

    @classmethod
    def from_params(cls, params, *, storage: Storage):
        return cls(
            storage,
            str(params.by_key("fleet_replica_id", "") or ""),
            ttl_s=float(params.by_key("l2_lease_ttl_s", 30.0)),
            poll_s=float(params.by_key("l2_lease_poll_ms", 50.0)) / 1000.0,
            wait_cap_s=float(params.by_key("l2_lease_wait_cap_s", 120.0)),
        )
