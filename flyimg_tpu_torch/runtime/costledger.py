"""Per-program cost ledger: cumulative device accounting keyed by program
identity.

The port of ``flyimg_tpu/runtime/costledger.py``. The JAX package records
each program's XLA compile (its ``cost_analysis()`` FLOPs and bytes, its
``memory_analysis()`` peak and the compile's wall time) and every launch's
device seconds against one key. The port compiles nothing at run time, so:

- the key is ``key_digest`` of the program's identity: the batcher group's
  program key with its device and padded batch (``runtime/batcher.py``),
  or the batch-1 direct program's with its device (``ops/compose.py
  run_plan``);
- ``record_compile`` records a program's build: the first completed launch
  of its ``ProgramHandle`` (``ops/compose.py``), with that launch's wall
  time (dispatch to completed readback, kernel builds and loads included)
  as ``compile_s``, or the handle's ``precompile`` (warm start). FLOPs and bytes stay None: nothing
  here analyses a program, and the JAX module's contract allows nulled cost
  fields (``costed`` False);
- the peak is measured, not estimated: the batcher takes
  ``torch.cuda.max_memory_allocated`` after the first launch of a key is
  enqueued, less what was allocated before it, with the peak statistics
  reset on its executor thread. Allocations of other threads in that window
  count too and make the figure larger: the conservative side for the
  memory governor, which learns its per-member bytes from it
  (``runtime/memgovernor.py observe``). A drain thread freeing an earlier
  launch's tensors inside the window would make it smaller;
- ``record_launch`` takes device seconds from dispatch to completed
  readback, as the JAX batcher's drain measures them.

The ledger is a process-wide singleton (``get_ledger``), bounded at
``max_entries`` entries, least-recently-launched evicted. ``aggregates``
and ``snapshot`` (``/debug/plans``) are the read surface, and
``register_metrics`` exports the ``flyimg_plan_*`` gauges on a server's
registry.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "PlanCostLedger",
    "get_ledger",
    "key_digest",
    "normalize_cost_analysis",
]

# the cost keys carried (XLA's HloCostAnalysis vocabulary, as the JAX
# package names them)
_FLOPS_KEY = "flops"
_BYTES_KEY = "bytes accessed"
_TRANSCENDENTALS_KEY = "transcendentals"


def normalize_cost_analysis(raw) -> Optional[Dict[str, float]]:
    """A cost report as one flat ``{flops, bytes_accessed,
    transcendentals}`` dict, or None when it holds nothing usable: a list
    of one dict per computation is summed, a bare dict is read, None or an
    empty report is None. Sub-metric keys (``bytes accessed0{}``) are
    ignored."""
    if raw is None:
        return None
    if isinstance(raw, (list, tuple)):
        if not raw:
            return None
        merged: Dict[str, float] = {}
        for part in raw:
            if not isinstance(part, dict):
                continue
            for key in (_FLOPS_KEY, _BYTES_KEY, _TRANSCENDENTALS_KEY):
                if key in part:
                    merged[key] = merged.get(key, 0.0) + float(part[key])
        raw = merged
    if not isinstance(raw, dict) or not raw:
        return None
    out: Dict[str, float] = {}
    if _FLOPS_KEY in raw:
        out["flops"] = float(raw[_FLOPS_KEY])
    if _BYTES_KEY in raw:
        out["bytes_accessed"] = float(raw[_BYTES_KEY])
    if _TRANSCENDENTALS_KEY in raw:
        out["transcendentals"] = float(raw[_TRANSCENDENTALS_KEY])
    return out or None


def key_digest(key) -> str:
    """A stable short digest of a program key (a tuple of hashables whose
    repr is deterministic)."""
    return hashlib.blake2b(repr(key).encode("utf-8"), digest_size=8).hexdigest()


class _Entry:
    __slots__ = (
        "key", "descriptor", "flops", "bytes_accessed", "transcendentals",
        "peak_memory_bytes", "compile_s", "compiled_at", "costed",
        "fallback", "launches", "images", "device_s", "last_launch_at",
    )

    def __init__(self, key: str, descriptor: Optional[Dict]) -> None:
        self.key = key
        self.descriptor = descriptor or {}
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.transcendentals: Optional[float] = None
        self.peak_memory_bytes: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.compiled_at: Optional[float] = None
        self.costed = False
        self.fallback = False
        self.launches = 0
        self.images = 0
        self.device_s = 0.0
        self.last_launch_at: Optional[float] = None

    def as_dict(self) -> Dict[str, object]:
        return {
            "key": self.key,
            "descriptor": dict(self.descriptor),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compile_s": (
                round(self.compile_s, 6) if self.compile_s is not None else None
            ),
            "costed": self.costed,
            "fallback": self.fallback,
            "launches": self.launches,
            "images": self.images,
            "device_s": round(self.device_s, 6),
            "flops_executed": (
                self.flops * self.launches if self.flops is not None else None
            ),
            "bytes_executed": (
                self.bytes_accessed * self.launches
                if self.bytes_accessed is not None else None
            ),
        }


class PlanCostLedger:
    """Bounded, thread-safe per-program cost and usage table."""

    def __init__(self, max_entries: int = 256) -> None:
        self._lock = threading.Lock()
        self._max_entries = max(8, int(max_entries))
        self._entries: Dict[str, _Entry] = {}
        # since-boot totals survive eviction
        self._total_compile_s = 0.0
        self._total_compiles = 0
        self._total_uncosted = 0
        self._total_flops_executed = 0.0
        self._total_bytes_executed = 0.0
        self._total_device_s = 0.0

    def configure(self, *, max_entries: Optional[int] = None) -> None:
        """Re-bound the table (the server applies
        ``costledger_max_entries``; the singleton predates it)."""
        if max_entries is not None:
            with self._lock:
                self._max_entries = max(8, int(max_entries))
                self._evict_locked()

    # -- recording ---------------------------------------------------------

    def record_compile(
        self,
        key,
        *,
        descriptor: Optional[Dict] = None,
        compile_s: Optional[float] = None,
        cost: Optional[Dict[str, float]] = None,
        peak_memory_bytes: Optional[float] = None,
        fallback: bool = False,
    ) -> str:
        """One program built (``cost`` normalized, or None: the entry then
        has nulled cost fields). Returns the entry's key digest."""
        digest = key if isinstance(key, str) else key_digest(key)
        with self._lock:
            entry = self._entries.get(digest)
            if entry is None:
                entry = _Entry(digest, descriptor)
                self._entries[digest] = entry
            elif descriptor:
                entry.descriptor = dict(descriptor)
            if cost:
                entry.flops = cost.get("flops")
                entry.bytes_accessed = cost.get("bytes_accessed")
                entry.transcendentals = cost.get("transcendentals")
                entry.costed = entry.flops is not None
            if not entry.costed:
                self._total_uncosted += 1
            entry.peak_memory_bytes = peak_memory_bytes
            entry.compile_s = compile_s
            entry.compiled_at = time.time()
            entry.fallback = bool(fallback)
            self._total_compiles += 1
            if compile_s is not None:
                self._total_compile_s += float(compile_s)
            self._evict_locked()
        return digest

    def record_launch(self, key, *, device_s: Optional[float],
                      images: int = 0) -> None:
        """One launch: cumulative device seconds and images. Creates a
        cost-less entry when the build record was evicted."""
        digest = key if isinstance(key, str) else key_digest(key)
        with self._lock:
            entry = self._entries.get(digest)
            if entry is None:
                entry = _Entry(digest, None)
                self._entries[digest] = entry
            entry.launches += 1
            entry.images += int(images)
            if device_s is not None:
                entry.device_s += float(device_s)
                self._total_device_s += float(device_s)
            entry.last_launch_at = time.time()
            if entry.flops is not None:
                self._total_flops_executed += entry.flops
            if entry.bytes_accessed is not None:
                self._total_bytes_executed += entry.bytes_accessed
            # evict after stamping last_launch_at, so a fresh entry does not
            # sort as least recently launched and evict itself
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._entries) > self._max_entries:
            # least recently launched first; never-launched entries by
            # build time
            victim = min(
                self._entries.values(),
                key=lambda e: (e.last_launch_at or e.compiled_at or 0.0),
            )
            del self._entries[victim.key]

    # -- read surface ------------------------------------------------------

    def peak_memory(self, key) -> Optional[float]:
        """The program's recorded peak device bytes, or None (never built,
        evicted, or not measured)."""
        digest = key if isinstance(key, str) else key_digest(key)
        with self._lock:
            entry = self._entries.get(digest)
            return None if entry is None else entry.peak_memory_bytes

    def entries(self) -> List[Dict[str, object]]:
        with self._lock:
            rows = [e.as_dict() for e in self._entries.values()]
        rows.sort(key=lambda r: r["device_s"], reverse=True)
        return rows

    def aggregates(self) -> Dict[str, float]:
        """Since-boot totals; the peak is the largest of the live
        entries'."""
        with self._lock:
            peak = max(
                (e.peak_memory_bytes for e in self._entries.values()
                 if e.peak_memory_bytes is not None),
                default=0.0,
            )
            return {
                "entries": float(len(self._entries)),
                "compiles": float(self._total_compiles),
                "compile_seconds": self._total_compile_s,
                "uncosted": float(self._total_uncosted),
                "flops_executed": self._total_flops_executed,
                "bytes_executed": self._total_bytes_executed,
                "device_seconds": self._total_device_s,
                "peak_memory_bytes": peak,
            }

    def snapshot(self, limit: int = 64) -> Dict[str, object]:
        """Per-program rows (by cumulative device seconds, descending) and
        the since-boot totals."""
        rows = self.entries()
        truncated = max(len(rows) - int(limit), 0)
        return {
            "plans": rows[: int(limit)],
            "truncated": truncated,
            "aggregates": self.aggregates(),
        }


    def register_metrics(self, registry) -> None:
        """Export the flyimg_plan_* family as render-time gauges on a
        server's registry (the ledger is process-wide, the registry per
        server: callbacks keep them decoupled). FLOPs and bytes read 0, as
        nothing here costs a program."""
        registry.gauge(
            "flyimg_plan_entries",
            "Device programs tracked by the per-plan cost ledger",
            fn=lambda: self.aggregates()["entries"],
        )
        registry.gauge(
            "flyimg_plan_compile_seconds",
            "Cumulative wall time spent compiling device programs",
            fn=lambda: self.aggregates()["compile_seconds"],
        )
        registry.gauge(
            "flyimg_plan_flops_executed",
            "Estimated FLOPs executed through costed device programs",
            fn=lambda: self.aggregates()["flops_executed"],
        )
        registry.gauge(
            "flyimg_plan_bytes_executed",
            "Estimated bytes accessed by costed device programs",
            fn=lambda: self.aggregates()["bytes_executed"],
        )
        registry.gauge(
            "flyimg_plan_peak_memory_bytes",
            "Largest per-program peak device memory estimate in the ledger",
            fn=lambda: self.aggregates()["peak_memory_bytes"],
        )
        registry.gauge(
            "flyimg_plan_uncosted",
            "Compiles whose backend returned no usable cost analysis",
            fn=lambda: self.aggregates()["uncosted"],
        )


# process-wide, as the kernels and their launches are
_LEDGER = PlanCostLedger()


def get_ledger() -> PlanCostLedger:
    return _LEDGER
