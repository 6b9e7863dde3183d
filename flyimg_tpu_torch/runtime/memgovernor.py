"""Memory governor: device-memory launch admission and host bounds.

The port of ``flyimg_tpu/runtime/memgovernor.py``.

**Device side** (``MemoryGovernor``): before the batcher launches a group it
asks how many members fit ``mem_device_budget_bytes``. The prediction is a
bytes-per-padded-pixel heuristic over the padded launch (the JAX package
also learns a per-member figure from its cost ledger's compile-time memory
analysis; the port has no cost ledger yet, ROADMAP Queue A 2, so it keeps
the heuristic alone). An over-budget group is pre-split by capping how many
members one launch takes (the rest stays queued). A launch that still fails
with ``torch.OutOfMemoryError`` (``classify_batch_error`` == ``OVERSIZE``)
records a TTL'd capacity ceiling for its plan family: halved on each
out-of-memory, raised by ``probe_step`` after ``probe_successes`` clean
launches at the ceiling (additive increase, multiplicative decrease).

**Host side** (``HostByteAccountant``): a byte-denominated admission gate
over the predicted decoded bytes in flight; past the budget a request sheds
with a 503 + Retry-After instead of the process running out of memory. The
first unit always admits: one huge image must degrade, not deadlock.

``RssWatchdog``: samples the process's RSS (``/proc/self/statm``) as a
pressure normalised to a limit; the ``mem.rss`` fault point overrides the
sample. The JAX package's brownout engine reads it; the port has no
brownout yet (ROADMAP Queue A 4), so nothing does.

Everything here is off by default and inert when off: the batcher skips
every governor call without a governor, and the server makes none unless
``mem_governor_enable`` is set.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from flyimg_tpu_torch.exceptions import ServiceUnavailableException
from flyimg_tpu_torch.testing import faults


def _family_label(key) -> str:
    """A compact stable label of one plan-family key."""
    return hashlib.blake2b(repr(key).encode(), digest_size=8).hexdigest()


class MemoryGovernor:
    """Device-memory launch admission: footprint prediction, pre-split
    caps, and AIMD capacity ceilings by plan family.

    Thread-safe (the batcher calls it from its executor thread and from
    recovery). The clock is injectable for TTL and probe tests.
    """

    def __init__(
        self,
        *,
        enabled: bool = False,
        device_budget_bytes: int = 0,
        heuristic_bytes_per_pixel: float = 64.0,
        ceiling_ttl_s: float = 300.0,
        probe_successes: int = 4,
        probe_step: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.enabled = bool(enabled)
        self.device_budget_bytes = max(int(device_budget_bytes), 0)
        self.heuristic_bytes_per_pixel = max(
            float(heuristic_bytes_per_pixel), 1.0
        )
        self.ceiling_ttl_s = max(float(ceiling_ttl_s), 0.0)
        self.probe_successes = max(int(probe_successes), 1)
        self.probe_step = max(int(probe_step), 1)
        self._clock = clock
        self._lock = threading.Lock()
        # family label -> [cap_members, expires_at, successes_at_cap]
        self._ceilings: Dict[str, list] = {}
        self._presplits_total = 0
        self._oom_launches_total = 0

    @classmethod
    def from_params(cls, params) -> "MemoryGovernor":
        return cls(
            enabled=bool(params.by_key("mem_governor_enable", False)),
            device_budget_bytes=int(
                params.by_key("mem_device_budget_bytes", 0) or 0
            ),
            heuristic_bytes_per_pixel=float(
                params.by_key("mem_heuristic_bytes_per_pixel", 64.0)
            ),
            ceiling_ttl_s=float(params.by_key("mem_ceiling_ttl_s", 300.0)),
            probe_successes=int(params.by_key("mem_probe_successes", 4)),
            probe_step=int(params.by_key("mem_probe_step", 1)),
        )

    # -- prediction --------------------------------------------------------

    def predict_bytes(self, padded_batch: int,
                      in_shape: Optional[Tuple[int, int]]) -> float:
        """Predicted peak device bytes of one launch: the heuristic's bytes
        per padded input pixel."""
        if not in_shape:
            return 0.0
        h, w = int(in_shape[0]), int(in_shape[1])
        return float(padded_batch) * h * w * self.heuristic_bytes_per_pixel

    # -- launch admission (pre-split) --------------------------------------

    def member_cap(
        self,
        family,
        in_shape: Optional[Tuple[int, int]],
        requested: int,
        pad_fn: Callable[[int], int],
    ) -> Optional[int]:
        """The largest member count <= ``requested`` whose padded launch
        fits the device budget and the family's live ceiling, or None when
        nothing constrains the launch. ``pad_fn`` maps a member count to the
        padded batch launched."""
        if not self.enabled or requested <= 1:
            return None
        cap = int(requested)
        ceiling = self._ceiling_cap(family)
        if ceiling is not None:
            cap = min(cap, max(int(ceiling), 1))
        if self.device_budget_bytes > 0:
            while cap > 1 and self.predict_bytes(
                pad_fn(cap), in_shape
            ) > self.device_budget_bytes:
                cap -= 1
        return cap if cap < requested else None

    def record_presplit(self) -> None:
        with self._lock:
            self._presplits_total += 1

    # -- AIMD capacity ceilings --------------------------------------------

    def _ceiling_cap(self, family) -> Optional[int]:
        label = _family_label(family)
        with self._lock:
            entry = self._expire_locked(label)
            return None if entry is None else entry[0]

    def _expire_locked(self, label: str) -> Optional[list]:
        entry = self._ceilings.get(label)
        if entry is None:
            return None
        if self.ceiling_ttl_s > 0 and self._clock() >= entry[1]:
            del self._ceilings[label]
            return None
        return entry

    def record_oom(self, family, n_members: int) -> int:
        """One out-of-memory launch: halve (or set) the family's capacity
        ceiling, refresh its TTL, and return the new cap. It works with the
        governor off too: the ceiling is the capacity found."""
        n = max(int(n_members), 1)
        label = _family_label(family)
        with self._lock:
            self._oom_launches_total += 1
            entry = self._expire_locked(label)
            if entry is None:
                cap = max(n // 2, 1)
            else:
                cap = max(min(entry[0], n) // 2, 1)
            self._ceilings[label] = [cap, self._clock() + self.ceiling_ttl_s, 0]
        return cap

    def record_success(self, family, n_members: int) -> None:
        """One clean launch: launches at or above a live ceiling count
        toward the additive raise; after ``probe_successes`` in a row the
        cap rises by ``probe_step``."""
        if not self.enabled:
            return
        label = _family_label(family)
        with self._lock:
            entry = self._expire_locked(label)
            if entry is None or int(n_members) < entry[0]:
                return
            entry[2] += 1
            if entry[2] >= self.probe_successes:
                entry[0] += self.probe_step
                entry[1] = self._clock() + self.ceiling_ttl_s
                entry[2] = 0

    def has_ceiling(self, family) -> bool:
        return self._ceiling_cap(family) is not None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            now = self._clock()
            ceilings = {
                label: {
                    "cap_members": entry[0],
                    "ttl_remaining_s": round(max(entry[1] - now, 0.0), 3),
                    "successes_at_cap": entry[2],
                }
                for label, entry in self._ceilings.items()
                if self.ceiling_ttl_s <= 0 or now < entry[1]
            }
            return {
                "enabled": self.enabled,
                "device_budget_bytes": self.device_budget_bytes,
                "heuristic_bytes_per_pixel": self.heuristic_bytes_per_pixel,
                "ceilings": ceilings,
                "presplits_total": self._presplits_total,
                "oom_launches_total": self._oom_launches_total,
            }


class HostByteAccountant:
    """Byte-denominated admission of decode work: at most ``budget_bytes``
    of predicted decoded bytes in flight; past that ``admit`` sheds at once
    with a 503 + Retry-After. The first unit always admits. ``budget_bytes``
    <= 0 disables the bound."""

    def __init__(self, *, budget_bytes: int = 0, retry_after_s: float = 1.0) -> None:
        self.budget_bytes = max(int(budget_bytes), 0)
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self._inflight_bytes = 0
        self._inflight_units = 0
        self._rejections_total = 0

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    @classmethod
    def from_params(cls, params) -> "HostByteAccountant":
        return cls(
            budget_bytes=int(params.by_key("mem_host_budget_bytes", 0) or 0),
            retry_after_s=float(params.by_key("shed_retry_after_s", 1.0)),
        )

    def admit(self, predicted_bytes: int) -> int:
        """Charge one unit of decode work; returns the charge (the token
        ``release`` takes back; 0 when disabled). Raises
        ``ServiceUnavailableException`` when the budget is full."""
        if not self.enabled:
            return 0
        charge = max(int(predicted_bytes), 0)
        with self._lock:
            if (
                self._inflight_units > 0
                and self._inflight_bytes + charge > self.budget_bytes
            ):
                self._rejections_total += 1
                exc = ServiceUnavailableException(
                    "host decode byte budget is full "
                    f"({self._inflight_bytes}/{self.budget_bytes} bytes "
                    f"inflight, next unit needs {charge}); shedding load"
                )
                exc.retry_after_s = max(1, int(self.retry_after_s))
                raise exc
            self._inflight_bytes += charge
            self._inflight_units += 1
        return charge

    def release(self, charged: int) -> None:
        """Return one ``admit``'s charge (call it from a finally block: a
        leaked charge shrinks the budget until restart)."""
        with self._lock:
            if self._inflight_units > 0:
                self._inflight_units -= 1
            self._inflight_bytes = max(
                self._inflight_bytes - max(int(charged), 0), 0
            )

    @property
    def inflight_bytes(self) -> int:
        with self._lock:
            return self._inflight_bytes

    @property
    def inflight_units(self) -> int:
        with self._lock:
            return self._inflight_units

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "budget_bytes": self.budget_bytes,
                "inflight_bytes": self._inflight_bytes,
                "inflight_units": self._inflight_units,
                "rejections_total": self._rejections_total,
            }


class RssWatchdog:
    """Process-RSS sampler: ``pressure()`` is RSS / ``limit_bytes`` (1.0 at
    the limit; 0.0 when disabled). A ``mem.rss`` fault plan overrides the
    sample."""

    _PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

    def __init__(self, *, limit_bytes: int = 0) -> None:
        self.limit_bytes = max(int(limit_bytes), 0)
        self._peak_bytes = 0.0

    @property
    def enabled(self) -> bool:
        return self.limit_bytes > 0

    def rss_bytes(self) -> float:
        """The current RSS in bytes (0.0 when unreadable)."""
        forced = faults.fire("mem.rss")
        if forced is not faults.PASS and forced is not None:
            rss = float(forced)
        else:
            rss = self._read_statm()
        if rss > self._peak_bytes:
            self._peak_bytes = rss
        return rss

    def _read_statm(self) -> float:
        try:
            with open("/proc/self/statm", "r", encoding="ascii") as fh:
                fields = fh.read().split()
            return float(fields[1]) * float(self._PAGE_SIZE)
        except (OSError, IndexError, ValueError):
            return 0.0

    def pressure(self) -> float:
        if not self.enabled:
            return 0.0
        return self.rss_bytes() / float(self.limit_bytes)

    def snapshot(self) -> Dict[str, object]:
        return {
            "enabled": self.enabled,
            "limit_bytes": self.limit_bytes,
            "rss_bytes": self.rss_bytes(),
            "peak_bytes": self._peak_bytes,
        }
