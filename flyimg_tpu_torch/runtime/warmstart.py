"""Warm start: the program cache and the autotuner's policy seeded from
manifests in the store.

The port of ``flyimg_tpu/runtime/warmstart.py``. A server that starts cold
builds every program its traffic needs at the first request of each, and
on the card a program's first launch also pays for loading its kernels and
the allocator's first reservations. So:

- **recording**: while serving, the server notes the IDENTITY of every
  program it builds: the fields of the ``build_program`` /
  ``build_batched_program`` key without the device (``record_single`` and
  ``record_batched`` fire inside the lru bodies, so once a key and never
  on a hit), and publishes them as a digest-stamped JSON **program
  manifest** to the store at shutdown (``maybe_publish``), merged by
  digest with what is there;
- **seeding**: a server that starts reads the manifest and builds each
  entry through ``ProgramHandle.precompile`` on its own device, so its
  first request of a known program is a cache hit.

**Validation** (a foreign blob is never executed): the manifest carries
program identities, never built artifacts; seeding builds locally, from
this package's own code, on its own device. Each entry is digest-stamped
(blake2b over its canonical JSON); a corrupted or tampered entry fails the
digest and is counted ``mismatch`` and skipped (that program builds on
demand), an unknown kind is ``skipped``, an entry whose fields do not make
a program is ``failed``; none of them fails the start. The entries are the
JAX package's, field for field and digest for digest: the device and
the mesh stay out, and ``sharded`` says whether the program ran sharded
over a data-parallel mesh; a seeding server builds a sharded entry against
its own mesh (``seed_programs(device, mesh)``), or unsharded without one.

Where the JAX package compiles an entry without executing it, the port's
``precompile`` runs the program once on a zero batch: the port compiles
nothing per program, and the first launch's kernel loads and allocations
are what warm start takes off the first request.

The **policy table** rides the same mechanism: the autotuner's known-good
knob values are published as one digest-stamped document, and a server
that starts adopts them through ``PolicyAutotuner.seed_known_good``, every
value clamped to its own envelopes; a failed digest discards the whole
table.

Off by default: with ``warmstart_enable`` off the recorder is never
installed (the hooks are one module-level ``None`` check), no manifest is
read or written and no metric registers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
from typing import Any, Dict, List, Optional

from flyimg_tpu_torch.testing import faults

__all__ = [
    "WarmStartCache",
    "PROGRAMS_MANIFEST",
    "POLICY_MANIFEST",
    "record_single",
    "record_batched",
    "install",
    "uninstall",
]

LOGGER = "flyimg.fleet"

#: the store's object names (flat: the local store takes a name's basename)
PROGRAMS_MANIFEST = "warmstart-programs.manifest"
POLICY_MANIFEST = "warmstart-policy.manifest"

#: TransformPlan fields whose JSON lists turn back into tuples, so the
#: rebuilt plan is hash- and eq-identical to the recorded one (the lru key)
_PLAN_TUPLE_FIELDS = frozenset({
    "src_size", "resize_to", "extent", "background", "unsharp",
    "sharpen", "blur", "extract",
})


def _entry_digest(entry: Dict[str, Any]) -> str:
    """The digest of an entry's canonical JSON without its digest field."""
    doc = {k: v for k, v in entry.items() if k != "digest"}
    return hashlib.blake2b(
        json.dumps(doc, sort_keys=True).encode("utf-8"), digest_size=16
    ).hexdigest()


def _tupled(value):
    return tuple(value) if isinstance(value, (list, tuple)) else value


def _plan_from_doc(doc: Dict[str, Any]):
    from flyimg_tpu_torch.spec.plan import TransformPlan

    names = {f.name for f in dataclasses.fields(TransformPlan)}
    if not isinstance(doc, dict) or set(doc) - names:
        raise ValueError("unknown TransformPlan fields in manifest entry")
    return TransformPlan(**{
        k: (_tupled(v) if k in _PLAN_TUPLE_FIELDS else v) for k, v in doc.items()
    })


class _Recorder:
    """The bounded, deduplicated set of program identities this server
    built; ``note`` runs inside the lru bodies (once a program)."""

    def __init__(self, max_entries: int) -> None:
        self.max_entries = max(int(max_entries), 1)
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self.dirty = False
        self.dropped = 0

    def note(self, entry: Dict[str, Any]) -> None:
        entry = dict(entry)
        entry["digest"] = _entry_digest(entry)
        with self._lock:
            if entry["digest"] in self._entries:
                return
            if len(self._entries) >= self.max_entries:
                self.dropped += 1       # counted in the snapshot
                return
            self._entries[entry["digest"]] = entry
            self.dirty = True

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            self.dirty = False
            return list(self._entries.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class WarmStartCache:
    """One server's recorder, manifest publisher and seeder. Every read and
    write of the store is advisory: a failure leaves a cold start or an
    unpublished manifest, never a failed request or start."""

    def __init__(self, storage, *, enabled: bool = False, max_entries: int = 64,
                 metrics=None) -> None:
        self.storage = storage
        self.enabled = bool(enabled)
        self.max_entries = max(int(max_entries), 1)
        self.metrics = metrics
        self.recorder = _Recorder(self.max_entries)
        self._autotuner = None
        self._published_policy: Optional[Dict[str, float]] = None
        self.stats: Dict[str, int] = {
            "seeded": 0, "mismatch": 0, "skipped": 0, "failed": 0,
            "policy_applied": 0,
        }

    def _count(self, outcome: str, n: int = 1) -> None:
        self.stats[outcome] = self.stats.get(outcome, 0) + n
        if self.metrics is not None:
            self.metrics.counter(
                "flyimg_warmstart_programs_total"
                f'{{outcome="{outcome}"}}',
                "Warm-start manifest entries by seeding outcome "
                "(mismatch = digest validation failed; the program "
                "recompiles on demand instead)",
            ).inc(n)

    # -- recording ---------------------------------------------------------

    def install(self) -> "WarmStartCache":
        """Arm the process-wide recorder hooks (the server pairs it with
        ``uninstall`` when it closes)."""
        if self.enabled:
            install(self)
        return self

    def attach_autotuner(self, autotuner) -> None:
        self._autotuner = autotuner

    def note_single(self, in_shape, resample_out, pad_canvas, pad_offset,
                    plan, band_taps) -> None:
        self.recorder.note({
            "kind": "single",
            "in_shape": list(in_shape),
            "resample_out": list(resample_out) if resample_out else None,
            "pad_canvas": list(pad_canvas) if pad_canvas else None,
            "pad_offset": list(pad_offset),
            "plan": dataclasses.asdict(plan),
            "band_taps": list(band_taps) if band_taps else None,
        })

    def note_batched(self, batch_size, in_shape, resample_out, pad_canvas,
                     pad_offset, plan, rotate_dynamic, sharded,
                     band_taps) -> None:
        # the device stays out: a seeding server builds on its own
        self.recorder.note({
            "kind": "batched",
            "batch_size": int(batch_size),
            "in_shape": list(in_shape),
            "resample_out": list(resample_out) if resample_out else None,
            "pad_canvas": list(pad_canvas) if pad_canvas else None,
            "pad_offset": list(pad_offset),
            "plan": dataclasses.asdict(plan),
            "rotate_dynamic": bool(rotate_dynamic),
            "sharded": bool(sharded),
            "band_taps": list(band_taps) if band_taps else None,
        })

    # -- publishing --------------------------------------------------------

    def _read_manifest(self, name: str) -> Optional[dict]:
        try:
            # a raising plan models the store refusing the read: seeding
            # starts cold, a publish replaces instead of merging
            faults.fire("warmstart.cache", op="read", name=name)
            doc = json.loads(self.storage.read(name).decode("utf-8"))
        except Exception:
            return None
        return doc if isinstance(doc, dict) else None

    def _write_manifest(self, name: str, doc: dict) -> bool:
        try:
            faults.fire("warmstart.cache", op="write", name=name)
            self.storage.write(name, json.dumps(doc, sort_keys=True).encode("utf-8"))
            return True
        except Exception as exc:
            logging.getLogger(LOGGER).warning(
                "warm-start manifest write of %s failed (next publish "
                "retries): %s", name, exc,
            )
            return False

    def publish(self) -> None:
        """Merge the recorded program identities into the stored manifest
        (union by digest, newest last, the oldest trimmed past
        ``warmstart_max_entries``), and write the policy document when the
        known-good table moved."""
        if not self.enabled:
            return
        recorded = self.recorder.drain()
        if recorded:
            merged: Dict[str, Dict[str, Any]] = {}
            existing = self._read_manifest(PROGRAMS_MANIFEST) or {}
            for entry in existing.get("entries", []) or []:
                if (isinstance(entry, dict) and entry.get("digest")
                        and entry["digest"] == _entry_digest(entry)):
                    merged[entry["digest"]] = entry
            for entry in recorded:
                merged[entry["digest"]] = entry
            entries = list(merged.values())[-self.max_entries:]
            self._write_manifest(PROGRAMS_MANIFEST, {"version": 1, "entries": entries})
        if self._autotuner is not None and getattr(self._autotuner, "enabled", False):
            table = self._autotuner.known_good()
            if table and table != self._published_policy:
                doc = {"version": 1, "policy": table}
                doc["digest"] = _entry_digest(doc)
                if self._write_manifest(POLICY_MANIFEST, doc):
                    self._published_policy = table

    def maybe_publish(self) -> None:
        """Publish only when something moved (new programs recorded, or a
        changed known-good table)."""
        if not self.enabled:
            return
        tuner = self._autotuner
        policy_moved = (
            tuner is not None and getattr(tuner, "enabled", False)
            and bool(tuner.known_good())
            and tuner.known_good() != self._published_policy
        )
        if self.recorder.dirty or policy_moved:
            self.publish()

    # -- seeding -----------------------------------------------------------

    def _seed_one(self, entry: Dict[str, Any], device: str, mesh) -> None:
        plan = _plan_from_doc(entry["plan"])
        in_shape = _tupled(entry["in_shape"])
        resample_out = _tupled(entry.get("resample_out"))
        pad_canvas = _tupled(entry.get("pad_canvas"))
        pad_offset = _tupled(entry["pad_offset"])
        band_taps = _tupled(entry.get("band_taps"))
        # positional, as the serving paths call them: the lru keys a
        # positional and a keyword spelling apart
        if entry["kind"] == "single":
            from flyimg_tpu_torch.ops.compose import build_program

            handle = build_program(in_shape, resample_out, pad_canvas, pad_offset,
                                   plan, band_taps, device)
        else:
            from flyimg_tpu_torch.runtime.batcher import build_batched_program

            handle = build_batched_program(
                int(entry["batch_size"]), in_shape, resample_out, pad_canvas,
                pad_offset, plan, device, bool(entry.get("rotate_dynamic", False)),
                band_taps, mesh if entry.get("sharded") else None)
        handle.precompile()

    def seed_programs(self, device: str, mesh=None) -> Dict[str, int]:
        """Before the first request: build and precompile every
        digest-valid manifest entry on ``device`` (``str`` of the batcher's
        device), a sharded one over ``mesh`` (the batcher's data-parallel
        mesh; unsharded when None). Returns the outcome counts (kept in
        ``stats``)."""
        if not self.enabled:
            return {}
        manifest = self._read_manifest(PROGRAMS_MANIFEST)
        if manifest is None:
            return dict(self.stats)
        for entry in (manifest.get("entries") or [])[:self.max_entries]:
            if not isinstance(entry, dict) or entry.get("kind") not in ("single", "batched"):
                self._count("skipped")
                continue
            if entry.get("digest") != _entry_digest(entry):
                # a tampered identity is never built, let alone run
                self._count("mismatch")
                logging.getLogger(LOGGER).warning(
                    "warm-start manifest entry failed digest validation; "
                    "skipping (the program recompiles on demand)",
                )
                continue
            try:
                self._seed_one(entry, device, mesh)
            except Exception as exc:
                self._count("failed")
                logging.getLogger(LOGGER).warning(
                    "warm-start compile of one manifest entry failed "
                    "(recompiles on demand): %s", exc,
                )
                continue
            self._count("seeded")
        return dict(self.stats)

    def seed_policy(self, autotuner) -> Dict[str, float]:
        """Before the first request: adopt the stored known-good knob table
        through the autotuner's envelope clamps; a failed digest discards
        the whole document."""
        self.attach_autotuner(autotuner)
        if not self.enabled or not getattr(autotuner, "enabled", False):
            return {}
        doc = self._read_manifest(POLICY_MANIFEST)
        if doc is None:
            return {}
        if doc.get("digest") != _entry_digest(doc):
            self._count("mismatch")
            logging.getLogger(LOGGER).warning(
                "warm-start policy table failed digest validation; "
                "booting with local defaults",
            )
            return {}
        table = doc.get("policy")
        if not isinstance(table, dict):
            return {}
        applied = autotuner.seed_known_good(table)
        if applied:
            self.stats["policy_applied"] = len(applied)
            # what was adopted is what the store holds: no re-publish
            self._published_policy = autotuner.known_good()
        return applied

    def snapshot(self) -> Dict[str, object]:
        return {
            "enabled": self.enabled,
            "max_entries": self.max_entries,
            "recorded": len(self.recorder),
            "recorder_dropped": self.recorder.dropped,
            "stats": dict(self.stats),
        }

    @classmethod
    def from_params(cls, params, *, storage, metrics=None) -> "WarmStartCache":
        return cls(
            storage,
            enabled=bool(params.by_key("warmstart_enable", False)),
            max_entries=int(params.by_key("warmstart_max_entries", 64)),
            metrics=metrics,
        )


# the process-wide recorder hooks (the faults.install/clear pattern): the
# program caches call these inside their lru bodies, once a program; one
# None check when warm start is off

_active: Optional[WarmStartCache] = None


def install(cache: WarmStartCache) -> WarmStartCache:
    global _active
    _active = cache
    return cache


def uninstall() -> None:
    global _active
    _active = None


def record_single(in_shape, resample_out, pad_canvas, pad_offset, plan,
                  band_taps) -> None:
    """Called by ``ops/compose.build_program`` on each lru miss."""
    cache = _active
    if cache is None:
        return
    try:
        cache.note_single(in_shape, resample_out, pad_canvas, pad_offset, plan, band_taps)
    except Exception:   # recording never fails a build
        logging.getLogger(LOGGER).debug(
            "warm-start recording failed for one single program", exc_info=True)


def record_batched(batch_size, in_shape, resample_out, pad_canvas,
                   pad_offset, plan, rotate_dynamic, sharded,
                   band_taps) -> None:
    """Called by ``runtime/batcher.build_batched_program`` on each lru
    miss."""
    cache = _active
    if cache is None:
        return
    try:
        cache.note_batched(batch_size, in_shape, resample_out, pad_canvas,
                           pad_offset, plan, rotate_dynamic, sharded, band_taps)
    except Exception:
        logging.getLogger(LOGGER).debug(
            "warm-start recording failed for one batched program", exc_info=True)
