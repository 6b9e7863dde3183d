"""Batch flight recorder: a bounded ring of per-launch records, dumped as a
structured artifact when something goes wrong.

The port of ``flyimg_tpu/runtime/flightrecorder.py``. The SLO engine says
*that* a breach happened; by the time an operator looks, the batch-level
evidence (occupancy, plans, queue wait against device time) has scrolled
out of every histogram. The recorder keeps the last N launches verbatim:

- ``record()`` is called by ``runtime/batcher.py`` at every launch
  resolution (primary drains, recovery launches, aux batches and
  failures) with the batch id, controller, plan key (joining the cost
  ledger), occupancy, queue wait, the h2d / dispatch / readback-sync
  device-time split and a member trace id; the host stage pools record
  long queue waits. A record is one dict append under one lock.
- ``dump(reason)`` snapshots the ring into a JSON artifact under
  ``dump_dir``; the server dumps on an SLO breach. Dumps are rate-limited
  (``min_dump_interval_s``) and pruned to the newest ``max_dumps`` files.
- ``/debug/flightrecorder`` (debug-gated, 404 when off) serves the live
  ring and the dump inventory.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["FlightRecorder"]

RECORDER_LOGGER = "flyimg.flightrecorder"


class FlightRecorder:
    """Bounded per-launch ring + structured dump-on-incident."""

    def __init__(
        self,
        *,
        size: int = 256,
        dump_dir: str = "",
        min_dump_interval_s: float = 30.0,
        max_dumps: int = 16,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._ring: deque = deque(maxlen=max(8, int(size)))
        self.dump_dir = dump_dir
        self.min_dump_interval_s = max(float(min_dump_interval_s), 0.0)
        self.max_dumps = max(1, int(max_dumps))
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._last_dump = float("-inf")
        self._dumps_total = 0
        self._dumps_suppressed = 0
        # brownout level source (service/app.py attaches the engine's
        # level getter); absent -> level recorded as None
        self._level_fn: Optional[Callable[[], int]] = None

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "FlightRecorder":
        dump_dir = str(params.by_key("flightrecorder_dump_dir", "") or "")
        if not dump_dir:
            dump_dir = os.path.join(
                str(params.by_key("tmp_dir", "var/tmp")), "flightrecorder"
            )
        return cls(
            size=int(params.by_key("flightrecorder_size", 256)),
            dump_dir=dump_dir,
            min_dump_interval_s=float(
                params.by_key("flightrecorder_min_dump_interval_s", 30.0)
            ),
            max_dumps=int(params.by_key("flightrecorder_max_dumps", 16)),
            metrics=metrics,
        )

    def attach(self, *, level_fn: Optional[Callable[[], int]] = None) -> None:
        self._level_fn = level_fn

    # -- hot path ----------------------------------------------------------

    def record(
        self,
        *,
        controller: str,
        batch_id: Optional[int],
        plan_key: Optional[str],
        occupancy: int,
        capacity: int,
        queue_wait_s: float,
        h2d_s: Optional[float] = None,
        dispatch_s: Optional[float] = None,
        sync_s: Optional[float] = None,
        device_s: Optional[float] = None,
        compile_hit: Optional[bool] = None,
        kind: str = "primary",
        trace_id: Optional[str] = None,
        error: Optional[str] = None,
        stage: Optional[str] = None,
        predicted_bytes: Optional[float] = None,
        budget_bytes: Optional[int] = None,
        mem_event: Optional[str] = None,
    ) -> None:
        """One launch outcome. Runs on the batcher's executor/drain
        threads — the body is one level sample plus a deque append.
        ``stage`` is set on host-pipeline ``host_stage`` records
        (runtime/hostpipeline.py): the per-stage queue-wait joins the
        device launches' h2d/dispatch/sync split in the same ring, so an
        incident dump shows where requests queued — host stage pools or
        device — on one timeline. ``predicted_bytes``/``budget_bytes``/
        ``mem_event`` come from the memory governor when one is wired
        (runtime/memgovernor.py): predicted peak device memory vs the configured
        budget, and which admission intervention — ``presplit``,
        ``ceiling``, or an ``oversize`` failure — touched this launch."""
        level = None
        if self._level_fn is not None:
            try:
                level = int(self._level_fn())
            except Exception:
                level = None

        def _r(value: Optional[float]) -> Optional[float]:
            return round(value, 6) if value is not None else None

        rec = {
            "at_s": round(time.time(), 3),
            "controller": controller,
            "batch_id": batch_id,
            "plan_key": plan_key,
            "occupancy": int(occupancy),
            "capacity": int(capacity),
            "queue_wait_s": _r(queue_wait_s),
            "h2d_s": _r(h2d_s),
            "dispatch_s": _r(dispatch_s),
            "sync_s": _r(sync_s),
            "device_s": _r(device_s),
            "compile_hit": compile_hit,
            "brownout_level": level,
            "kind": kind,
            "stage": stage,
            "trace_id": trace_id,
            "error": error,
            "predicted_bytes": (
                round(predicted_bytes) if predicted_bytes else None
            ),
            "budget_bytes": budget_bytes,
            "mem_event": mem_event,
        }
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str,
             context: Optional[Dict] = None) -> Optional[str]:
        """Snapshot the ring to ``dump_dir`` as one JSON artifact.
        Returns the path, or None when rate-limited / empty / the write
        failed (a broken disk must not fail the request that breached).
        """
        now = self._clock()
        with self._lock:
            records = list(self._ring)
            if not records:
                # nothing to dump — and an evidence-free trigger must
                # not burn the rate-limit window that a later trigger
                # WITH evidence needs
                return None
            if now - self._last_dump < self.min_dump_interval_s:
                self._dumps_suppressed += 1
                return None
            self._last_dump = now
        doc = {
            "reason": reason,
            "at_s": round(time.time(), 3),
            "context": context or {},
            "records": records,
            "summary": self._summarize(records),
        }
        name = time.strftime("flightrecorder-%Y%m%d-%H%M%S") + f"-{reason}.json"
        path = os.path.join(self.dump_dir, name)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=1)
                fh.write("\n")
            self._prune_dumps()
        except OSError as exc:
            logging.getLogger(RECORDER_LOGGER).warning(
                "flight-recorder dump failed: %s", exc
            )
            return None
        self._dumps_total += 1
        if self._metrics is not None:
            from flyimg_tpu_torch.runtime.metrics import escape_label_value

            self._metrics.counter(
                "flyimg_flightrecorder_dumps_total"
                f'{{reason="{escape_label_value(reason)}"}}',
                "Flight-recorder ring dumps by trigger reason",
            ).inc()
        logging.getLogger(RECORDER_LOGGER).warning(
            "flight recorder dumped %d launch records (%s)",
            len(records), reason,
            extra={
                "event": "flightrecorder.dump",
                "reason": reason,
                "path": path,
                "records": len(records),
            },
        )
        return path

    def _prune_dumps(self) -> None:
        dumps = self._dump_files()
        for name, _ in dumps[: max(len(dumps) - self.max_dumps, 0)]:
            try:
                os.unlink(os.path.join(self.dump_dir, name))
            except OSError:
                pass

    def _dump_files(self) -> List:
        try:
            names = [
                n for n in os.listdir(self.dump_dir)
                if n.startswith("flightrecorder-") and n.endswith(".json")
            ]
        except OSError:
            return []
        out = []
        for name in names:
            try:
                out.append(
                    (name, os.path.getmtime(os.path.join(self.dump_dir, name)))
                )
            except OSError:
                continue
        out.sort(key=lambda pair: pair[1])
        return out

    @staticmethod
    def _summarize(records: List[Dict]) -> Dict[str, object]:
        launches = [r for r in records if r.get("error") is None]
        errors = len(records) - len(launches)
        images = sum(r["occupancy"] for r in records)
        slots = sum(r["capacity"] for r in records)
        device = sum(r["device_s"] or 0.0 for r in records)
        queue = sum(r["queue_wait_s"] or 0.0 for r in records)
        compiled = [
            r["compile_hit"] for r in records if r["compile_hit"] is not None
        ]
        return {
            "records": len(records),
            "errors": errors,
            "images": images,
            "mean_occupancy": images / slots if slots else 0.0,
            "device_s": round(device, 6),
            "queue_wait_s": round(queue, 6),
            "compile_misses": sum(1 for hit in compiled if not hit),
            "recovery_launches": sum(
                1 for r in records if r.get("kind") == "recovery"
            ),
            "mem_interventions": sum(
                1 for r in records if r.get("mem_event") is not None
            ),
        }

    # -- artifact retention surface -------------------------------------------

    def dump_files(self) -> List[str]:
        """Dump-file names, oldest first."""
        return [name for name, _ in self._dump_files()]

    def prune_dumps(self) -> None:
        """Re-apply the dump retention bound now. The telemetry pipeline
        calls this after overriding ``max_dumps`` with the unified
        ``telemetry_retention_max_dumps`` knob so a tightened bound
        takes effect without waiting for the next incident dump."""
        self._prune_dumps()

    # -- read surface ------------------------------------------------------

    def snapshot(self, limit: int = 128) -> Dict[str, object]:
        """The /debug/flightrecorder JSON document: newest records first
        plus the dump inventory."""
        with self._lock:
            records = list(self._ring)
            dumps_total = self._dumps_total
            suppressed = self._dumps_suppressed
        records.reverse()
        return {
            "size": self._ring.maxlen,
            "records": records[: max(1, int(limit))],
            "summary": (
                self._summarize(records) if records else {"records": 0}
            ),
            "dumps": {
                "dir": self.dump_dir,
                "written": dumps_total,
                "suppressed_by_rate_limit": suppressed,
                "files": [name for name, _ in self._dump_files()],
            },
        }

    def recent_summary(self, limit: int = 64) -> Dict[str, object]:
        """Aggregate view of the newest ``limit`` launch records — the
        online autotuner's flight-recorder signal (occupancy, queue
        wait vs device time, compile misses over the most recent
        launches; runtime/autotuner.py). One lock hold + one pass; no
        file IO."""
        with self._lock:
            records = list(self._ring)[-max(1, int(limit)):]
        if not records:
            return {"records": 0}
        return self._summarize(records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
