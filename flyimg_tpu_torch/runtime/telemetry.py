"""The telemetry warehouse: a crash-safe, append-only archive of the
signals and the traffic-mix classifier.

The port of ``flyimg_tpu/runtime/telemetry.py``:

- ``TelemetryArchive``: JSONL segments under ``telemetry_dir`` (default
  ``<tmp_dir>/telemetry``), rotated by size and age, the oldest closed
  segments evicted past the retention bounds; a torn last line (a write
  cut by a crash) is cut off when the archive opens, and counted.
- ``TrafficMixClassifier``: a window of requests fingerprinted by plan
  family, size bucket, sizes a source and hit ratio, labelled by the
  nearest of ``thumbnail | cropzoom | multisize | panzoom`` (``mixed`` past
  a radius), the adopted label changing only after ``hysteresis`` beats
  agree.
- ``TelemetryPipeline``: the beat that rides the request path, at most
  every ``telemetry_snapshot_interval_s`` (as ``brownout.evaluate()``
  does), and writes a window record (``SignalWindow``'s signals, the SLO
  burn, the brownout level, the cost ledger's deltas, the mix label) and a
  launch record a flight-recorder record since the last beat (their batch
  ids are the ones the flight recorder and the ``torch.profiler`` ranges
  share).
The beat's signals come from ``runtime/observatory.py``'s
``SignalWindow``, an instance of its own.

Off by default (``telemetry_enable``): no directory, no metrics, the
handler holds None. The archive's vocabulary is ``RECORD_SCHEMAS``: a
field outside it is dropped and counted, never written.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.metrics import escape_label_value
from flyimg_tpu_torch.runtime.observatory import SignalWindow

TELEMETRY_LOGGER = "flyimg.telemetry"

#: every record carries it, so an archive replays under a newer reader
SCHEMA_VERSION = 1

#: the archive's vocabulary: kind -> allowed top-level fields
RECORD_SCHEMAS: Dict[str, Tuple[str, ...]] = {
    # one an archive open: the continuity and recovery marker
    "boot": (
        "schema", "kind", "at_s", "replica", "segment",
        "torn_recovered", "segments", "archive_bytes",
    ),
    # one a beat
    "window": (
        "schema", "kind", "at_s", "replica", "window_s",
        "controllers", "host", "kernel_mode",
        "burn_fast_norm", "burn_slow_norm", "brownout_level",
        "slo", "reuse", "ledger_delta",
        "requests_delta", "hits_delta", "misses_delta", "degraded_delta",
        "mix", "mix_raw", "mix_distance", "mix_features", "mix_samples",
        "segments", "archive_bytes",
    ),
    # one a flight-recorder record (its kind and seq renamed launch_kind
    # and launch_seq, apart from the envelope's)
    "launch": (
        "schema", "kind", "at_s", "replica",
        "controller", "batch_id", "plan_key", "occupancy", "capacity",
        "queue_wait_s", "h2d_s", "dispatch_s", "sync_s", "device_s",
        "compile_hit", "brownout_level", "launch_kind", "stage",
        "trace_id", "error", "launch_seq",
        "predicted_bytes", "budget_bytes", "mem_event",
    ),
}

_SEGMENT_PREFIX = "telemetry-"
_SEGMENT_SUFFIX = ".jsonl"

#: the classifier's labels
MIX_LABELS = ("thumbnail", "cropzoom", "multisize", "panzoom", "mixed")

#: the fingerprint's features, each in [0, 1]
MIX_FEATURES = ("crop_share", "small_share", "bucket_spread",
                "source_fanout", "hit_ratio")

#: the features' weights in the distance (the hit ratio is history, not
#: shape: a weak tie-breaker)
MIX_WEIGHTS = (1.0, 0.8, 0.9, 0.9, 0.4)

#: the centroids, the same in every replica and every replay
MIX_CENTROIDS: Dict[str, Tuple[float, ...]] = {
    "thumbnail": (0.05, 0.95, 0.15, 0.10, 0.50),
    "cropzoom": (0.90, 0.30, 0.30, 0.15, 0.40),
    "multisize": (0.10, 0.50, 0.80, 0.80, 0.35),
    "panzoom": (0.90, 0.35, 0.40, 0.80, 0.55),
}

#: farther than this from every centroid is "mixed"
MIX_RADIUS = 0.55


def request_features(options, source_key: Optional[str]) -> Dict[str, object]:
    """One request's mix features from its options (dict reads and a
    ``bit_length``: it runs for every answer, hits included). ``sig`` names
    the plan's shape (family, size bucket, crop window), so the classifier
    counts distinct shapes a source."""
    try:
        if hasattr(options, "int_option"):
            width = options.int_option("width")
            height = options.int_option("height")
        else:
            width = options.get("width")
            height = options.get("height")
        if hasattr(options, "truthy"):
            crop = options.truthy("crop")
            extract = options.truthy("extract")
        else:
            crop = bool(options.get("crop"))
            extract = options.get("extract") is not None
    except Exception:   # an odd options bag never fails serving
        width = height = None
        crop = extract = False
    dims = []
    for v in (width, height):
        if isinstance(v, bool) or v is None:
            continue
        try:
            dims.append(int(float(v)))
        except (TypeError, ValueError):
            continue
    max_dim = max((d for d in dims if d > 0), default=0)
    # a power-of-two bucket; 0 is the original size
    bucket = min(max_dim.bit_length(), 14) if max_dim > 0 else 0
    window = ""
    if extract:
        try:
            window = ",".join(
                str(options.get(key) or "")
                for key in ("extract-top-x", "extract-top-y",
                            "extract-bottom-x", "extract-bottom-y"))
        except Exception:
            window = ""
    family = "crop" if (crop or extract) else "resize"
    return {"family": family, "bucket": bucket,
            "sig": f"{family}:{bucket}:{window}", "source": source_key or ""}


class TrafficMixClassifier:
    """Nearest-centroid labels of a window of requests, with hysteresis:
    ``record()`` is one append under a lock, ``classify()`` runs on the
    beat."""

    def __init__(self, *, window: int = 256, min_samples: int = 8,
                 hysteresis: int = 2) -> None:
        self.window = max(8, int(window))
        self.min_samples = max(1, int(min_samples))
        self.hysteresis = max(1, int(hysteresis))
        self._lock = threading.Lock()
        self._requests: deque = deque(maxlen=self.window)
        self.label = "mixed"        # adopted
        self._candidate = "mixed"   # proposed by the recent beats
        self._streak = 0
        self.transitions = 0
        self.last_raw: Optional[str] = None
        self.last_distance: Optional[float] = None
        self.last_features: Optional[Dict[str, float]] = None
        self.last_samples = 0

    def record(self, features: Dict[str, object], outcome: str) -> None:
        """``outcome``: hit, stale, coalesced, miss, reuse, degraded or shed."""
        with self._lock:
            self._requests.append((
                features.get("family"), features.get("bucket"),
                features.get("sig"), features.get("source"), outcome,
            ))

    def fingerprint(self) -> Optional[Dict[str, float]]:
        """The window's features, or None under the sample floor."""
        with self._lock:
            rows = list(self._requests)
        if len(rows) < self.min_samples:
            return None
        n = float(len(rows))
        crop = sum(1 for r in rows if r[0] == "crop")
        small = sum(1 for r in rows if 0 < int(r[1] or 0) <= 9)  # <= 512 px
        buckets = {r[1] for r in rows}
        sources = {r[3] for r in rows if r[3]}
        sigs_per_source: Dict[str, set] = {}
        for r in rows:
            if r[3]:
                sigs_per_source.setdefault(r[3], set()).add(r[2])
        if sigs_per_source:
            fanout_mean = sum(len(s) for s in sigs_per_source.values()) / float(
                len(sigs_per_source))
        else:
            fanout_mean = 1.0
        hits = sum(1 for r in rows if r[4] in ("hit", "stale", "coalesced"))
        return {
            "crop_share": crop / n,
            "small_share": small / n,
            "bucket_spread": min((len(buckets) - 1) / 5.0, 1.0),
            "source_fanout": min((fanout_mean - 1.0) / 4.0, 1.0) if sources else 0.0,
            "hit_ratio": hits / n,
        }

    @staticmethod
    def nearest(features: Dict[str, float]) -> Tuple[str, float]:
        """The weighted Euclidean nearest centroid; ``mixed`` past
        MIX_RADIUS."""
        vec = [float(features.get(name, 0.0)) for name in MIX_FEATURES]
        best_label, best_dist = "mixed", float("inf")
        for label, centroid in MIX_CENTROIDS.items():
            dist = math.sqrt(sum(
                (MIX_WEIGHTS[i] * (vec[i] - centroid[i])) ** 2
                for i in range(len(MIX_FEATURES))))
            if dist < best_dist:
                best_label, best_dist = label, dist
        if best_dist > MIX_RADIUS:
            return "mixed", best_dist
        return best_label, best_dist

    def classify(self) -> Dict[str, object]:
        """One beat: fingerprint, raw label, hysteresis; ``changed`` on the
        beat the adopted label flipped."""
        features = self.fingerprint()
        changed = False
        previous = self.label
        if features is None:
            raw, dist = None, None
        else:
            raw, dist = self.nearest(features)
            if raw == self.label:
                self._candidate, self._streak = raw, 0
            elif raw == self._candidate:
                self._streak += 1
                if self._streak >= self.hysteresis:
                    self.label = raw
                    self._streak = 0
                    self.transitions += 1
                    changed = True
            else:
                self._candidate, self._streak = raw, 1
                if self.hysteresis <= 1:
                    self.label = raw
                    self.transitions += 1
                    changed = True
        self.last_raw = raw
        self.last_distance = dist
        self.last_features = features
        self.last_samples = len(self._requests)
        return {
            "label": self.label,
            "raw": raw,
            "distance": round(dist, 4) if dist is not None else None,
            "features": ({k: round(v, 4) for k, v in features.items()}
                         if features else None),
            "samples": self.last_samples,
            "changed": changed,
            "previous": previous,
        }

    def snapshot(self) -> Dict[str, object]:
        return {
            "label": self.label, "raw": self.last_raw,
            "distance": self.last_distance, "features": self.last_features,
            "samples": self.last_samples, "transitions": self.transitions,
            "hysteresis": self.hysteresis, "window": self.window,
        }


class TelemetryArchive:
    """Append-only JSONL segments ``<dir>/telemetry-<seq>.jsonl`` with
    rotation, bounded retention and torn-tail recovery. Only the newest
    segment is written; each record is one line, flushed, so a crash can
    tear only the last line, which the next open cuts off (counted in the
    boot record). Thread-safe; the wall clock is injectable."""

    def __init__(self, directory: str, *,
                 segment_max_bytes: int = 1 << 20,
                 segment_max_age_s: float = 300.0,
                 retention_max_bytes: int = 32 << 20,
                 retention_max_segments: int = 64,
                 clock: Optional[Callable[[], float]] = None,
                 replica_id: str = "") -> None:
        self.directory = directory
        self.segment_max_bytes = max(4096, int(segment_max_bytes))
        self.segment_max_age_s = max(1.0, float(segment_max_age_s))
        self.retention_max_bytes = max(self.segment_max_bytes, int(retention_max_bytes))
        self.retention_max_segments = max(2, int(retention_max_segments))
        self.clock = clock or time.time
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._fh = None
        self._segment_name = ""
        self._segment_bytes = 0
        self._segment_opened_at = 0.0
        self.torn_recovered = 0
        self.rotations = 0
        self.evicted_segments = 0
        self.records_written: Dict[str, int] = {}
        self.dropped_fields = 0
        os.makedirs(self.directory, exist_ok=True)
        self._open_newest()

    # -- segments -------------------------------------------------------------

    def _segment_files(self) -> List[str]:
        try:
            names = [n for n in os.listdir(self.directory)
                     if n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX)]
        except OSError:
            return []
        return sorted(names)  # zero-padded: lexicographic is numeric

    @staticmethod
    def _segment_seq(name: str) -> int:
        try:
            return int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
        except ValueError:
            return 0

    def _segment_path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _recover_tail(self, path: str) -> None:
        """Cut off a torn final line: unterminated, or terminated but not
        JSON. Earlier bad lines are left for readers to skip."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size == 0:
            return
        with open(path, "rb+") as fh:
            fh.seek(max(0, size - 1))
            if fh.read(1) == b"\n":
                fh.seek(0)
                data = fh.read()
                end = len(data) - 1
                start = data.rfind(b"\n", 0, end) + 1
                try:
                    json.loads(data[start:end + 1].decode("utf-8"))
                    return
                except (ValueError, UnicodeDecodeError):
                    fh.truncate(start)
                    self.torn_recovered += 1
                    return
            fh.seek(0)
            data = fh.read()
            fh.truncate(data.rfind(b"\n") + 1)
            self.torn_recovered += 1

    def _open_newest(self) -> None:
        segments = self._segment_files()
        if segments:
            newest = segments[-1]
            self._recover_tail(self._segment_path(newest))
            try:
                size = os.path.getsize(self._segment_path(newest))
            except OSError:
                size = 0
            if size < self.segment_max_bytes:
                self._segment_name = newest
                self._segment_bytes = size
                # a segment found on disk ages from its mtime
                try:
                    self._segment_opened_at = os.path.getmtime(self._segment_path(newest))
                except OSError:
                    self._segment_opened_at = self.clock()
                self._fh = open(self._segment_path(newest), "a", encoding="utf-8")
                return
        self._start_segment((self._segment_seq(segments[-1]) + 1) if segments else 1)

    def _start_segment(self, seq: int) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        name = f"{_SEGMENT_PREFIX}{seq:08d}{_SEGMENT_SUFFIX}"
        self._segment_name = name
        self._segment_bytes = 0
        self._segment_opened_at = self.clock()
        self._fh = open(self._segment_path(name), "a", encoding="utf-8")

    def _rotate_locked(self) -> None:
        self.rotations += 1
        self._start_segment(self._segment_seq(self._segment_name) + 1)
        self._enforce_retention_locked()

    def _enforce_retention_locked(self) -> None:
        """Evict closed segments, oldest first, until both bounds hold (the
        segment being written never goes)."""
        segments = self._segment_files()
        closed = [n for n in segments if n != self._segment_name]
        sizes = {}
        for name in segments:
            try:
                sizes[name] = os.path.getsize(self._segment_path(name))
            except OSError:
                sizes[name] = 0
        total = sum(sizes.values())
        while closed and (total > self.retention_max_bytes
                          or len(closed) + 1 > self.retention_max_segments):
            victim = closed.pop(0)
            try:
                os.unlink(self._segment_path(victim))
            except OSError:
                pass
            total -= sizes.get(victim, 0)
            self.evicted_segments += 1

    # -- writing --------------------------------------------------------------

    def append(self, kind: str, fields: Dict[str, object]) -> bool:
        """One record of a kind of RECORD_SCHEMAS (another kind is
        refused; a field outside its schema is dropped and counted). True
        when a line was written; an IO error never fails a request."""
        allowed = RECORD_SCHEMAS.get(kind)
        if allowed is None:
            return False
        record: Dict[str, object] = {
            "schema": SCHEMA_VERSION, "kind": kind,
            "at_s": round(self.clock(), 3), "replica": self.replica_id or None,
        }
        for key, value in fields.items():
            if key in allowed:
                record[key] = value
            else:
                self.dropped_fields += 1
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with self._lock:
            if self._fh is None:
                return False
            if self.clock() - self._segment_opened_at >= self.segment_max_age_s:
                self._rotate_locked()
            try:
                self._fh.write(line)
                self._fh.flush()
            except (OSError, ValueError):
                return False
            self._segment_bytes += len(line.encode("utf-8"))
            self.records_written[kind] = self.records_written.get(kind, 0) + 1
            if self._segment_bytes >= self.segment_max_bytes:
                self._rotate_locked()
        return True

    # -- reading --------------------------------------------------------------

    def total_bytes(self) -> int:
        total = 0
        for name in self._segment_files():
            try:
                total += os.path.getsize(self._segment_path(name))
            except OSError:
                pass
        return total

    def inventory(self) -> Dict[str, object]:
        return {
            "dir": self.directory,
            "segments": self._segment_files(),
            "active_segment": self._segment_name,
            "bytes": self.total_bytes(),
            "rotations": self.rotations,
            "evicted_segments": self.evicted_segments,
            "torn_recovered": self.torn_recovered,
            "records_written": dict(self.records_written),
            "dropped_fields": self.dropped_fields,
        }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_archive(directory: str,
                 kinds: Optional[Tuple[str, ...]] = None) -> Dict[str, object]:
    """Every record in segment and line order (never timestamp order),
    torn or damaged lines skipped and counted."""
    records: List[Dict] = []
    torn = 0
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX))
    except OSError:
        names = []
    for name in names:
        try:
            with open(os.path.join(directory, name), "r", encoding="utf-8",
                      errors="replace") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        torn += 1
                        continue
                    if not isinstance(rec, dict):
                        torn += 1
                        continue
                    if kinds is not None and rec.get("kind") not in kinds:
                        continue
                    records.append(rec)
        except OSError:
            continue
    return {"records": records, "torn": torn, "segments": names}


class TelemetryPipeline:
    """Archive, classifier and the beat. Off (``from_params`` without
    ``telemetry_enable``): no directory, no metrics, ``evaluate()`` one
    bool check."""

    def __init__(self, *, enabled: bool, directory: str = "",
                 interval_s: float = 10.0,
                 archive: Optional[TelemetryArchive] = None,
                 classifier: Optional[TrafficMixClassifier] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, replica_id: str = "") -> None:
        self.enabled = enabled
        self.directory = directory
        self.interval_s = max(0.05, float(interval_s))
        self.archive = archive
        self.classifier = classifier
        self.clock = clock or time.time
        self.metrics = metrics
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self._last_beat = 0.0
        self._last_launch_seq = 0
        self._prev_ledger: Optional[Dict[str, float]] = None
        self._prev_counters: Dict[str, float] = {}
        self._beat_outcomes: Dict[str, int] = {}
        self.window: Optional[SignalWindow] = None
        self._slo = None
        self._flight_recorder = None
        self._ledger_fn: Optional[Callable[[], Dict]] = None

    @classmethod
    def from_params(cls, params, *, metrics=None,
                    replica_id: str = "") -> "TelemetryPipeline":
        if not bool(params.by_key("telemetry_enable", False)):
            return cls(enabled=False)
        directory = str(params.by_key("telemetry_dir", "") or "")
        if not directory:
            directory = os.path.join(str(params.by_key("tmp_dir", "var/tmp")), "telemetry")
        clock = params.by_key("telemetry_clock") or time.time
        archive = TelemetryArchive(
            directory,
            segment_max_bytes=int(params.by_key("telemetry_segment_max_bytes", 1 << 20)),
            segment_max_age_s=float(params.by_key("telemetry_segment_max_age_s", 300.0)),
            retention_max_bytes=int(params.by_key("telemetry_retention_max_bytes", 32 << 20)),
            retention_max_segments=int(params.by_key("telemetry_retention_max_segments", 64)),
            clock=clock, replica_id=replica_id,
        )
        classifier = TrafficMixClassifier(
            window=int(params.by_key("telemetry_mix_window", 256)),
            min_samples=int(params.by_key("telemetry_mix_min_samples", 8)),
            hysteresis=int(params.by_key("telemetry_mix_hysteresis", 2)),
        )
        pipeline = cls(
            enabled=True, directory=directory,
            interval_s=float(params.by_key("telemetry_snapshot_interval_s", 10.0)),
            archive=archive, classifier=classifier, clock=clock,
            metrics=metrics, replica_id=replica_id,
        )
        if metrics is not None:
            pipeline._register_metrics(metrics)
        return pipeline

    # -- wiring ---------------------------------------------------------------

    def attach(self, *, metrics=None, slo=None, brownout=None,
               host_pipeline=None, flight_recorder=None,
               reuse_fn=None, ledger_fn: Optional[Callable[[], Dict]] = None) -> None:
        """Wire the read surfaces (with a SignalWindow of its own) and write
        the boot record."""
        if not self.enabled:
            return
        self.window = SignalWindow()
        self.window.attach(metrics=metrics, slo=slo, brownout=brownout,
                           host_pipeline=host_pipeline,
                           flight_recorder=flight_recorder, reuse_fn=reuse_fn)
        self._slo = slo
        self._flight_recorder = flight_recorder
        self._ledger_fn = ledger_fn
        inv = self.archive.inventory()
        self.archive.append("boot", {
            "segment": inv["active_segment"],
            "torn_recovered": inv["torn_recovered"],
            "segments": len(inv["segments"]),
            "archive_bytes": inv["bytes"],
        })

    def _register_metrics(self, registry) -> None:
        for label in MIX_LABELS:
            registry.gauge(
                f'flyimg_traffic_mix{{mix="{escape_label_value(label)}"}}',
                "Adopted traffic-mix label (1 = current, 0 = not)",
                fn=lambda lbl=label: 1.0 if self.classifier.label == lbl else 0.0,
            )
        registry.gauge(
            "flyimg_telemetry_segments",
            "Archive segment files currently retained on disk",
            fn=lambda: float(len(self.archive.inventory()["segments"])),
        )
        registry.gauge(
            "flyimg_telemetry_archive_bytes",
            "Total bytes across retained archive segments",
            fn=lambda: float(self.archive.total_bytes()),
        )

    # -- the request path ------------------------------------------------------

    def record_request(self, *, options, source_key: Optional[str], outcome: str) -> None:
        """One answer into the classifier's window: no IO."""
        if not self.enabled:
            return
        try:
            self.classifier.record(request_features(options, source_key), outcome)
            with self._lock:
                self._beat_outcomes[outcome] = self._beat_outcomes.get(outcome, 0) + 1
        except Exception:
            logging.getLogger(TELEMETRY_LOGGER).debug(
                "mix feature recording failed", exc_info=True)

    # -- the beat --------------------------------------------------------------

    def evaluate(self) -> bool:
        """The beat, at most every ``interval_s``; True when a window record
        was written."""
        if not self.enabled:
            return False
        now = self.clock()
        with self._lock:
            if now - self._last_beat < self.interval_s:
                return False
            since = now - (self._last_beat or now)
            self._last_beat = now
            outcomes = dict(self._beat_outcomes)
            self._beat_outcomes.clear()
        try:
            self._drain_launches()
            self._write_window(since, outcomes)
            return True
        except Exception:
            logging.getLogger(TELEMETRY_LOGGER).warning("telemetry beat failed",
                                                        exc_info=True)
            return False

    def _drain_launches(self) -> None:
        """Every flight record past the last beat's sequence number becomes
        one launch record."""
        recorder = self._flight_recorder
        if recorder is None:
            return
        doc = recorder.snapshot(limit=len(recorder) or 1)
        fresh = [r for r in doc.get("records", [])
                 if int(r.get("seq") or 0) > self._last_launch_seq]
        fresh.sort(key=lambda r: int(r.get("seq") or 0))
        for rec in fresh:
            fields = dict(rec)
            fields["launch_kind"] = fields.pop("kind", None)
            fields["launch_seq"] = fields.pop("seq", None)
            fields.pop("at_s", None)    # the envelope stamps the archive's time
            self.archive.append("launch", fields)
            self._count_record("launch")
        if fresh:
            self._last_launch_seq = int(fresh[-1].get("launch_seq")
                                        or fresh[-1].get("seq") or 0)

    def _ledger_delta(self) -> Optional[Dict[str, float]]:
        if self._ledger_fn is None:
            return None
        try:
            aggregates = {k: float(v) for k, v in self._ledger_fn().items()
                          if isinstance(v, (int, float))}
        except Exception:
            return None
        prev = self._prev_ledger or {}
        self._prev_ledger = aggregates
        return {k: round(v - prev.get(k, 0.0), 6) for k, v in aggregates.items()}

    def _counter_delta(self, family: str) -> float:
        if self.metrics is None:
            return 0.0
        try:
            total = float(self.metrics.family_total(family))
        except Exception:
            return 0.0
        prev = self._prev_counters.get(family, total)
        self._prev_counters[family] = total
        return max(0.0, total - prev)

    def _write_window(self, since_s: float, outcomes: Dict[str, int]) -> None:
        mix = self.classifier.classify()
        if mix["changed"]:
            self._on_mix_change(mix)
        signals = self.window.assemble() if self.window is not None else {}
        slo_fields = {}
        slo = self._slo
        if slo is not None and getattr(slo, "enabled", False):
            try:
                slo_fields = dict(slo.digest_fields())
            except Exception:
                slo_fields = {}
        inv = self.archive.inventory()
        record = {
            "window_s": round(since_s, 3),
            "controllers": signals.get("controllers") or {},
            "host": signals.get("host") or {},
            "kernel_mode": signals.get("kernel_mode"),
            "burn_fast_norm": signals.get("burn_fast_norm"),
            "burn_slow_norm": signals.get("burn_slow_norm"),
            "brownout_level": signals.get("brownout_level"),
            "slo": slo_fields or None,
            "reuse": signals.get("reuse"),
            "ledger_delta": self._ledger_delta(),
            "requests_delta": self._counter_delta("flyimg_requests_total"),
            "hits_delta": sum(outcomes.get(k, 0) for k in ("hit", "stale", "coalesced")),
            "misses_delta": sum(outcomes.get(k, 0) for k in ("miss", "reuse")),
            "degraded_delta": outcomes.get("degraded", 0) + outcomes.get("shed", 0),
            "mix": mix["label"],
            "mix_raw": mix["raw"],
            "mix_distance": mix["distance"],
            "mix_features": mix["features"],
            "mix_samples": mix["samples"],
            "segments": len(inv["segments"]),
            "archive_bytes": inv["bytes"],
        }
        if self.archive.append("window", record):
            self._count_record("window")
        tracing.add_event("telemetry.window", mix=mix["label"], samples=mix["samples"])

    def _on_mix_change(self, mix: Dict[str, object]) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "flyimg_traffic_mix_transitions_total"
                f'{{to="{escape_label_value(str(mix["label"]))}"}}',
                "Adopted traffic-mix label flips by destination "
                "(edge-triggered, after hysteresis)",
            ).inc()
        tracing.add_event("telemetry.mix_changed", to=mix["label"],
                          previous=mix["previous"], distance=mix["distance"])
        logging.getLogger(TELEMETRY_LOGGER).info(
            "traffic mix changed: %s -> %s", mix["previous"], mix["label"],
            extra={
                "event": "telemetry.mix_changed", "to": mix["label"],
                "previous": mix["previous"], "distance": mix["distance"],
                "features": mix["features"], "samples": mix["samples"],
                "replica": self.replica_id or None,
            },
        )

    def _count_record(self, kind: str) -> None:
        if self.metrics is None:
            return
        self.metrics.counter(
            f'flyimg_telemetry_records_total{{kind="{escape_label_value(kind)}"}}',
            "Records appended to the telemetry archive, by kind",
        ).inc()

    def adopt_dump_retention(self, recorder, max_dumps: int) -> None:
        """The flight recorder's dumps join the archive's retention: a
        positive ``telemetry_retention_max_dumps`` overrides
        ``flightrecorder_max_dumps``."""
        if not self.enabled or recorder is None:
            return
        if max_dumps > 0:
            recorder.max_dumps = int(max_dumps)
            recorder.prune_dumps()
        self._flight_recorder = recorder

    def snapshot(self) -> Dict[str, object]:
        """The /debug/telemetry document."""
        if not self.enabled:
            return {"enabled": False}
        doc: Dict[str, object] = {
            "enabled": True, "schema": SCHEMA_VERSION, "interval_s": self.interval_s,
            "mix": self.classifier.snapshot(), "archive": self.archive.inventory(),
        }
        recorder = self._flight_recorder
        if recorder is not None:
            try:
                doc["artifacts"] = {"dumps": recorder.dump_files(),
                                    "dump_dir": recorder.dump_dir,
                                    "max_dumps": recorder.max_dumps}
            except Exception:
                doc["artifacts"] = None
        return doc

    def close(self) -> None:
        """A last beat, so the shutdown window is on disk, then close."""
        if not self.enabled:
            return
        with self._lock:
            self._last_beat = 0.0
        self.evaluate()
        self.archive.close()
