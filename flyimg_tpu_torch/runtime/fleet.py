"""Fleet routing: rendezvous placement of derived cache keys.

The port of ``flyimg_tpu/runtime/fleet.py`` (docs/fleet.md). The JAX
router proxies through an asyncio HTTP client inside its event loop; this
package's server answers each request on a thread of its own, so the
proxy here is ``http.client`` in that thread, its timeout capped by the
request's remaining budget and ``fleet_proxy_timeout_s``, and the
``/readyz`` health probe runs on a short daemon thread.

"Millions of users" means N replicas behind a load balancer, and a
round-robin balancer sprays the same derived key — and the same compiled
program's traffic — across all of them: every replica misses, fetches,
and renders the hot key, and every replica's batch controller sees a
thin slice of every plan instead of a dense stream of a few. This
module is the placement half of the TensorFlow-style dataflow split
(arXiv 1605.08695): the **decision** of which replica owns a key is
separated from the **execution** (the existing single-process pipeline,
untouched), so same-key traffic concentrates and same-plan batches stay
dense.

Routing is rendezvous hashing (HRW) over a **static replica set** (the
``fleet_replicas`` knob): every replica scores ``hash(replica | key)``
for each replica and the max wins — no coordination, no ring state, and
removing one replica re-homes ONLY that replica's keys (the classic HRW
minimal-disruption property, pinned by test). A non-owner either
**proxies** the request to the owner (``fleet_route=proxy`` — one
internal HTTP hop, marked with ``X-Flyimg-Fleet-Hop`` so config skew can
never loop) or renders **locally** (``fleet_route=local``) and lets the
shared-L2 write-through make the result fleet-visible.

Owner-down fallback rides the existing resilience machinery: one
``CircuitBreaker`` per owner URL (a dead owner sheds the proxy attempt
in microseconds after the breaker trips) and the shared ``RetryPolicy``
for transient transport errors — every failure path degrades to a local
render, never a user-visible error the single-replica tier would not
have produced.

Inert by default: with ``fleet_replicas`` empty ``FleetRouter.enabled``
is False and service/app.py never consults it (byte-identical off
behavior pinned by tests/test_torch_fleet.py).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from flyimg_tpu_torch.runtime.resilience import BreakerRegistry, RetryPolicy
from flyimg_tpu_torch.testing import faults

__all__ = ["FleetRouter", "HOP_HEADER", "route_key", "rendezvous_owner"]

#: marks a request already forwarded once: the receiving replica always
#: renders locally, so replica-set config skew cannot proxy in circles
HOP_HEADER = "X-Flyimg-Fleet-Hop"

#: response headers a proxied reply carries back to the client; everything
#: hop-by-hop or recomputed by the local server is dropped
_FORWARD_RESPONSE_HEADERS = (
    "Content-Type",
    "Cache-Control",
    "Expires",
    "Last-Modified",
    "ETag",
    "Warning",
    "traceparent",
    "X-Flyimg-Degraded",
    "X-Flyimg-Reuse",
    "X-Flyimg-Replica",
    "Server-Timing",
)


#: option short-keys that change ONLY the encode step, never the device
#: plan (docs/url-options.md): requests differing only in these share a
#: compiled program, so routing them to one owner is what concentrates
#: same-plan traffic into dense batches (the affinity half of the fleet
#: tier). rf_ is a cache directive, not an identity component.
_ENCODE_ONLY_KEYS = frozenset(
    {"q", "moz", "sf", "st", "webpl", "rf"}
)


def route_key(options: str, image_src: str, separator: str = ",") -> str:
    """The routing key for one request: a digest of the source plus the
    PLAN-AFFINITY projection of the raw options segment — every option
    token except the encode-only ones (quality, mozjpeg, sampling
    factor, strip, lossless, refresh), order-normalized.

    Deliberately computed from the URL alone, BEFORE any option parsing
    or source probing (both may need the origin), so every replica
    derives the identical key with no coordination. The projection is
    strictly coarser than the derived cache key, so one derived output
    always routes to one owner — and all the quality/encoding variants
    of one geometry land on the SAME owner, whose batch controller then
    sees a dense stream of one program instead of a thin slice of all of
    them. Signed/encrypted
    options fall back to the opaque string — stable routing, no
    affinity grouping."""
    tokens = sorted(
        token
        for token in options.split(separator)
        if token.split("_", 1)[0] not in _ENCODE_ONLY_KEYS
    )
    return hashlib.md5(
        f"{separator.join(tokens)}/{image_src}".encode(
            "utf-8", "surrogatepass"
        )
    ).hexdigest()


def rendezvous_owner(replicas: List[str], key: str) -> str:
    """Highest-random-weight owner of ``key`` over ``replicas``: max of
    ``blake2b(replica | key)``, ties broken by the replica string so the
    choice is total. Every replica computes this identically with no
    shared state."""
    best = None
    best_score = None
    for replica in replicas:
        score = hashlib.blake2b(
            f"{replica}|{key}".encode("utf-8"), digest_size=8
        ).digest()
        if best_score is None or (score, replica) > (best_score, best):
            best, best_score = replica, score
    if best is None:
        raise ValueError("rendezvous_owner needs a non-empty replica set")
    return best


class FleetRouter:
    """Owner resolution + owner proxying for one replica."""

    def __init__(
        self,
        replicas: List[str],
        self_id: str,
        *,
        mode: str = "proxy",
        proxy_timeout_s: float = 30.0,
        health_ttl_s: float = 5.0,
        breakers: Optional[BreakerRegistry] = None,
        retry: Optional[RetryPolicy] = None,
        metrics=None,
    ) -> None:
        self.replicas = [str(r).rstrip("/") for r in replicas if str(r)]
        self.self_id = str(self_id or "").rstrip("/")
        self.mode = mode if mode in ("proxy", "local") else "proxy"
        self.proxy_timeout_s = float(proxy_timeout_s)
        # device-health gating (docs/resilience.md "Backend failover"):
        # how long a peer's device-down verdict holds — both the active
        # /readyz probe's and the passive one read off a relayed
        # X-Flyimg-Degraded: cpu-fallback response. 0 disables the gate
        # (no probes, no marks — the pre-supervisor routing exactly).
        self.health_ttl_s = float(health_ttl_s)
        self.breakers = breakers or BreakerRegistry()
        self.retry = retry
        self.metrics = metrics
        # peer URL -> monotonic expiry of its device-down mark, and the
        # monotonic time its health was last actively probed (at most
        # one /readyz round trip per peer per TTL)
        self._peer_down: Dict[str, float] = {}
        self._peer_checked: Dict[str, float] = {}
        self._probes: List[threading.Thread] = []

    @property
    def enabled(self) -> bool:
        return len(self.replicas) >= 2 and bool(self.self_id)

    @property
    def proxies(self) -> bool:
        return self.enabled and self.mode == "proxy"

    def update_replicas(
        self,
        replicas: List[str],
        self_id: Optional[str] = None,
        source: str = "manual",
    ) -> Dict[str, object]:
        """Swap the replica set online (docs/fleet.md "Dynamic replica
        sets"): the debug-gated ``POST /debug/fleet/replicas`` endpoint
        and the serve-mode SIGHUP config re-read both land here — and so
        does the membership watcher (runtime/membership.py, ``source=
        "membership"``) on every live-set change. The new list replaces
        ``self.replicas`` as ONE reference swap, so every ``owner()``
        call routes against either the old set or the new — never a
        half-updated one — and requests already proxying against an old
        owner complete normally (they captured the owner URL before the
        swap; HRW re-homes only the changed replicas' keys). Returns the
        applied routing snapshot."""
        new = [str(r).rstrip("/") for r in replicas if str(r)]
        if self_id is not None:
            self.self_id = str(self_id).rstrip("/")
        self.replicas = new
        return {
            "replicas": list(new),
            "replica_id": self.self_id,
            "mode": self.mode,
            "enabled": self.enabled,
            "source": source,
        }

    # -- peer device health (docs/resilience.md "Backend failover") --------

    def mark_device_down(self, replica: str) -> None:
        """Record that ``replica`` reported (or served) device-down:
        for ``health_ttl_s`` its keys re-home to the next rendezvous
        choice, so proxy traffic routes around its slow CPU renders
        instead of eating them. Self is never marked — a down replica
        keeps rendering its own traffic locally."""
        if self.health_ttl_s <= 0 or replica == self.self_id:
            return
        self._peer_down[replica] = time.monotonic() + self.health_ttl_s

    def _device_down(self, replica: str) -> bool:
        expires = self._peer_down.get(replica)
        if expires is None:
            return False
        if expires <= time.monotonic():
            # prune on expiry: a transient mark must not leave the dict
            # non-empty forever (owner()'s zero-cost fast path keys on
            # emptiness)
            self._peer_down.pop(replica, None)
            return False
        return True

    def _owner_device_ok(self, owner: str) -> bool:
        """The health gate consulted before each proxy hop. The check is a
        dict read (a marked-down owner sheds at once); the active
        ``/readyz`` probe runs off the request path, at most one daemon
        thread per owner per ``health_ttl_s``, so a slow owner never adds
        probe latency to a request. Its verdict gates the next request to
        that owner; the relayed ``cpu-fallback`` header marks at once."""
        if self._device_down(owner):
            return False
        if self.health_ttl_s <= 0:
            return True
        now = time.monotonic()
        checked = self._peer_checked.get(owner)
        if checked is None or now - checked >= self.health_ttl_s:
            self._peer_checked[owner] = now
            probe = threading.Thread(
                target=self._probe_owner_health, args=(owner,),
                name="flyimg-torch-fleet-probe", daemon=True)
            self._probes = [t for t in self._probes if t.is_alive()] + [probe]
            probe.start()
        return True

    def _probe_owner_health(self, owner: str) -> None:
        """One ``/readyz`` probe: a well-formed answer with ``device:
        down`` marks the owner. Anything else (unreachable, not JSON, no
        device field) reads as healthy: the proxy's own failure handling
        covers a dead owner."""
        try:
            _, _, body = _http_get(f"{owner}/readyz", {},
                                   min(2.0, self.proxy_timeout_s))
            doc = json.loads(body.decode("utf-8"))
        except Exception:
            return
        if isinstance(doc, dict) and doc.get("device") == "down":
            self.mark_device_down(owner)

    def peer_health(self) -> Dict[str, object]:
        """Routing-health snapshot for ``/debug/fleet/status``
        (runtime/observatory.py): per-peer remaining device-down TTL,
        joined there with membership and the digest rollup so one
        document answers "who is alive, who is limping, and who are we
        routing around"."""
        now = time.monotonic()
        down = {
            replica: round(expires - now, 3)
            for replica, expires in dict(self._peer_down).items()
            if expires > now
        }
        return {
            "replicas": list(self.replicas),
            "replica_id": self.self_id,
            "mode": self.mode,
            "enabled": self.enabled,
            "device_down": down,
        }

    def owner(self, key: str) -> str:
        # ONE reference read: a concurrent update_replicas (POST
        # endpoint, SIGHUP) swaps the list between this replica's
        # enabled check and the owner resolution, and an emptied set
        # must resolve to "render locally", never a 500
        replicas = self.replicas
        if not replicas:
            return self.self_id
        if self._peer_down:
            # device-down peers drop out of the rendezvous set: their
            # keys re-home to the next-highest replica (HRW moves ONLY
            # the down replica's keys) until the mark expires. Self
            # always stays — an all-down set must resolve somewhere.
            live = [
                r for r in replicas
                if r == self.self_id or not self._device_down(r)
            ]
            if live:
                replicas = live
        return rendezvous_owner(replicas, key)

    def is_owner(self, key: str) -> bool:
        return self.owner(key) == self.self_id

    def record(self, outcome: str) -> None:
        """One routing decision; ``outcome`` is the fixed vocabulary
        self | hop | proxied | fallback | local (docs/observability.md)."""
        if self.metrics is None:
            return
        self.metrics.counter(
            f'flyimg_fleet_routed_total{{outcome="{outcome}"}}',
            "Fleet routing decisions by outcome",
        ).inc()

    # -- proxying ----------------------------------------------------------

    def close(self, timeout_s: float = 2.5) -> None:
        """Join the health probes still in flight (each is bounded by its
        own timeout)."""
        for probe in self._probes:
            probe.join(timeout_s)
        self._probes = []

    def proxy(
        self,
        owner: str,
        path_qs: str,
        request_headers,
        *,
        timeout_s: Optional[float] = None,
        traceparent: Optional[str] = None,
    ) -> Optional[Tuple[int, Dict[str, str], bytes]]:
        """Forward one request to its owner replica. Returns ``(status,
        headers, body)`` to relay, or None when the owner cannot serve it
        (breaker open, transport failure, timeout, an owner 502/503/504)
        and the caller renders locally. Only deterministic owner answers
        (2xx/3xx/4xx) relay; an owner's 5xx counts as a breaker failure.

        Every attempt and the full-jitter backoff between them share one
        budget: the request's remaining deadline capped at
        ``fleet_proxy_timeout_s``."""
        # the health gate before the breaker's admission: allow() in
        # HALF_OPEN takes the probe slot, and shedding after it without
        # an outcome would hold that slot forever
        if not self._owner_device_ok(owner):
            return None
        breaker = self.breakers.for_host(owner)
        try:
            breaker.allow()
        except Exception:
            return None  # open breaker: shed the hop, render locally
        headers = {HOP_HEADER: self.self_id or "1"}
        for name in ("Accept", "traceparent", "If-None-Match",
                     "If-Modified-Since", "User-Agent"):
            value = request_headers.get(name)
            if value:
                headers[name] = value
        if traceparent:
            # this replica's fleet.route span, so the owner's tree hangs
            # off it instead of forking a sibling trace
            headers["traceparent"] = traceparent
        cap = self.proxy_timeout_s
        if timeout_s is not None:
            cap = min(cap, max(float(timeout_s), 0.001))
        give_up_at = time.monotonic() + cap
        attempts = self.retry.max_attempts if self.retry is not None else 1
        for attempt in range(max(attempts, 1)):
            if attempt and self.retry is not None:
                # the shared full-jitter backoff; one that would overshoot
                # the budget ends the affair now
                delay = self.retry.backoff(attempt)
                if time.monotonic() + delay >= give_up_at:
                    break
                time.sleep(delay)
            remaining = give_up_at - time.monotonic()
            if remaining <= 0:
                break
            try:
                # a raising plan is a transport failure on this hop; a
                # (status, headers, body) return stands in for the owner
                injected = faults.fire("fleet.proxy", owner=owner, attempt=attempt)
            except Exception:
                continue
            if injected is not faults.PASS and injected is not None:
                status, inj_headers, body = injected
                if status in (502, 503, 504):
                    breaker.record_failure()
                    return None
                breaker.record_success()
                return int(status), dict(inj_headers), bytes(body)
            try:
                status, resp_headers, body = _http_get(
                    f"{owner}{path_qs}", headers, remaining)
            except (OSError, http.client.HTTPException):
                continue  # a transient transport error: one more try
            if status in (502, 503, 504):
                breaker.record_failure()
                return None  # a sick owner: render locally instead
            breaker.record_success()
            degraded = resp_headers.get("X-Flyimg-Degraded", "")
            if "cpu-fallback" in degraded.split(","):
                # the owner's renders are on its CPU: relay these (valid)
                # bytes, and re-home its keys for the TTL
                self.mark_device_down(owner)
            out_headers = {name: resp_headers[name]
                           for name in _FORWARD_RESPONSE_HEADERS
                           if name in resp_headers}
            return status, out_headers, body
        breaker.record_failure()
        return None

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "FleetRouter":
        return cls(
            list(params.by_key("fleet_replicas", []) or []),
            str(params.by_key("fleet_replica_id", "") or ""),
            mode=str(params.by_key("fleet_route", "proxy")),
            proxy_timeout_s=float(
                params.by_key("fleet_proxy_timeout_s", 30.0)
            ),
            health_ttl_s=float(params.by_key("fleet_health_ttl_s", 5.0)),
            breakers=BreakerRegistry.from_params(params, metrics=metrics),
            retry=RetryPolicy.from_params(params, metrics=metrics),
            metrics=metrics,
        )


def _http_get(url: str, headers: Dict[str, str], timeout_s: float
              ) -> Tuple[int, Dict[str, str], bytes]:
    """One GET over a fresh connection: (status, the relayable headers by
    their canonical names, body). The timeout covers the connect and each
    socket read."""
    parts = urllib.parse.urlsplit(url)
    conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(parts.hostname, parts.port, timeout=max(timeout_s, 0.001))
    try:
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        conn.request("GET", path, headers=headers)
        resp = conn.getresponse()
        body = resp.read()
        names = {name.lower(): name for name in _FORWARD_RESPONSE_HEADERS}
        out = {names[name.lower()]: value for name, value in resp.getheaders()
               if name.lower() in names}
        return resp.status, out, body
    finally:
        conn.close()
