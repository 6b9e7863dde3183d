"""The per-source variant index behind derivative reuse.

The port of ``flyimg_tpu/runtime/variantindex.py``. The output cache is
keyed by the whole derived name, so one source asked for at many sizes
costs a fetch, a decode and a render a size. This table maps a source
digest (``OptionsBag.hash_original_image_url``) to the renditions of that
source already stored that a smaller request may render from instead of
the origin (``spec.plan.rewrite_for_reuse`` decides), with the facts that
decision needs. Only pure renditions (full-frame resamples, nothing else
baked in) are kept.

Bounds: ``reuse_index_max_variants`` a source (the smallest goes first),
``reuse_index_max_sources`` sources (least recently used goes), and
``reuse_index_ttl_s``, after which an entry is read again from storage.

Every record and discard writes the source's manifest
(``<source-digest>.variants.json``) beside the outputs, outside the
table's lock, in the JAX package's JSON layout: a manifest written by
either package reads in the other. A cold process rebuilds an entry from
its manifest at the first lookup. The index is a cache of what storage
holds: a missing or damaged manifest costs misses, and an ancestor whose
bytes are gone is dropped by the handler when it reads them.

Thread-safe; no storage IO under the table's lock. Nothing here runs
unless ``reuse_enable`` is on.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

LOGGER = "flyimg.reuse"

#: the manifest's format version (a manifest of another version is ignored)
MANIFEST_VERSION = 1

#: how long "no manifest in storage" is remembered
NEGATIVE_TTL_S = 30.0


def manifest_name(source_key: str) -> str:
    """The storage name of a source's variant manifest."""
    return f"{source_key}.variants.json"


@dataclass(frozen=True)
class VariantFacts:
    """What the reuse rewriter needs to know of one stored rendition,
    without its bytes."""

    name: str                                   # the output's cache name
    out_w: int                                  # stored pixel size
    out_h: int
    extension: str                              # png | jpg | webp
    quality: int                                # the encode's quality
    lossy: bool                                 # jpg, or webp without webpl_1
    pure: bool                                  # a full-frame resample only
    colorspace: Optional[str]                   # the plan's colorspace
    monochrome: bool
    background: Optional[Tuple[int, int, int]]
    generations: int                            # lossy re-encodes behind it
    src_w: int                                  # the decoded source size the
    src_h: int                                  # render's plan was built on
    frame_key: str                              # page/density/time/gif-frame
    stored_at: float = 0.0

    @property
    def area(self) -> int:
        return self.out_w * self.out_h


@dataclass
class SourceEntry:
    """A lookup's snapshot of one source, handed out of the lock."""

    source_key: str
    source_mime: str
    variants: Tuple[VariantFacts, ...] = ()

    def candidates(self) -> List[VariantFacts]:
        """The pure renditions, the largest first (the safest parent)."""
        return sorted((v for v in self.variants if v.pure),
                      key=lambda v: v.area, reverse=True)


@dataclass
class _SourceState:
    source_mime: str
    variants: Dict[str, VariantFacts] = field(default_factory=dict)
    loaded_at: float = 0.0
    negative: bool = False      # "no manifest in storage"


class VariantIndex:
    """The bounded, thread-safe source digest -> renditions table."""

    def __init__(self, *, max_sources: int = 512, max_variants: int = 16,
                 ttl_s: float = 3600.0, storage=None,
                 clock: Callable[[], float] = time.time) -> None:
        self.max_sources = max(1, int(max_sources))
        self.max_variants = max(1, int(max_variants))
        self.ttl_s = float(ttl_s)
        self._storage = storage
        self._clock = clock
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()  # serializes manifest writes
        self._sources: "OrderedDict[str, _SourceState]" = OrderedDict()
        # the tier supervisor (runtime/tiersupervisor.py), when the server
        # has one: manifest writes feed its storm counter, and while it
        # holds the island they are journaled instead of written
        self._supervisor = None

    def attach_supervisor(self, supervisor) -> None:
        self._supervisor = supervisor

    @classmethod
    def from_params(cls, params, *, storage=None) -> "VariantIndex":
        return cls(
            max_sources=int(params.by_key("reuse_index_max_sources", 512)),
            max_variants=int(params.by_key("reuse_index_max_variants", 16)),
            ttl_s=float(params.by_key("reuse_index_ttl_s", 3600.0)),
            storage=storage,
        )

    # -- lookups -----------------------------------------------------------

    def lookup(self, source_key: str) -> Optional[SourceEntry]:
        """The source's entry, or None when nothing reusable is known. A
        fresh in-memory state answers at once; a stale or absent one reads
        the manifest again (outside the lock)."""
        now = self._clock()
        with self._lock:
            state = self._sources.get(source_key)
            if state is not None and self._fresh_locked(state, now):
                self._sources.move_to_end(source_key)
                return self._snapshot_locked(source_key, state)
        doc = self._load_manifest(source_key)
        now = self._clock()
        with self._lock:
            # a record() that landed meanwhile is newer than the manifest
            state = self._sources.get(source_key)
            if state is not None and self._fresh_locked(state, now):
                self._sources.move_to_end(source_key)
                return self._snapshot_locked(source_key, state)
            state = self._state_from_doc(doc, now)
            self._sources[source_key] = state
            self._sources.move_to_end(source_key)
            self._bound_sources_locked()
            return self._snapshot_locked(source_key, state)

    def _fresh_locked(self, state: _SourceState, now: float) -> bool:
        ttl = min(self.ttl_s, NEGATIVE_TTL_S) if state.negative else self.ttl_s
        return now - state.loaded_at <= ttl

    @staticmethod
    def _snapshot_locked(source_key: str, state: _SourceState) -> Optional[SourceEntry]:
        if state.negative or not state.variants:
            return None
        return SourceEntry(source_key=source_key, source_mime=state.source_mime,
                           variants=tuple(state.variants.values()))

    # -- population --------------------------------------------------------

    def record(self, source_key: str, source_mime: str, facts: VariantFacts) -> None:
        """Index one rendition just stored (impure ones are dropped) and
        write the manifest through, outside the lock."""
        if not facts.pure:
            return
        now = self._clock()
        with self._lock:
            state = self._sources.get(source_key)
            known = state is not None and not state.negative
        seeded: Optional[_SourceState] = None
        if not known:
            # a cold record: the stored manifest may list renditions this
            # process never saw, and the write-through must keep them
            seeded = self._state_from_doc(self._load_manifest(source_key), now)
        with self._lock:
            state = self._sources.get(source_key)
            if state is None or state.negative:
                if seeded is not None and not seeded.negative:
                    state = seeded
                else:
                    state = _SourceState(source_mime=source_mime, loaded_at=now)
                self._sources[source_key] = state
            state.source_mime = source_mime or state.source_mime
            state.loaded_at = now
            state.negative = False
            state.variants[facts.name] = facts
            while len(state.variants) > self.max_variants:
                smallest = min(state.variants.values(), key=lambda v: v.area)
                del state.variants[smallest.name]
            self._sources.move_to_end(source_key)
            self._bound_sources_locked()
        self._persist(source_key)

    def discard(self, source_key: str, name: str) -> None:
        """Drop one rendition (gone, damaged or refreshed) and rewrite the
        manifest."""
        with self._lock:
            state = self._sources.get(source_key)
            if state is None or name not in state.variants:
                return
            del state.variants[name]
        self._persist(source_key)

    def discard_name(self, name: str) -> None:
        """Drop one rendition by its output name alone (the scrubber knows
        what it purged, not which source indexed it)."""
        with self._lock:
            owners = [key for key, state in self._sources.items()
                      if name in state.variants]
        for source_key in owners:
            self.discard(source_key, name)

    def _bound_sources_locked(self) -> None:
        while len(self._sources) > self.max_sources:
            self._sources.popitem(last=False)

    def __len__(self) -> int:
        """Indexed renditions of every source (``flyimg_variant_index_entries``)."""
        with self._lock:
            return sum(len(s.variants) for s in self._sources.values() if not s.negative)

    # -- manifests -------------------------------------------------------------

    def _persist(self, source_key: str) -> None:
        """The write-through, one at a time, the document taken under the
        table lock inside the IO lock: the last write holds the newest
        state."""
        if self._storage is None:
            return
        with self._io_lock:
            with self._lock:
                state = self._sources.get(source_key)
                doc = (self._doc_locked(state)
                       if state is not None and not state.negative else None)
            if doc is None:
                return
            self._store_manifest(source_key, doc)

    def _store_manifest(self, source_key: str, doc: dict) -> None:
        sup = self._supervisor
        if sup is not None and sup.islanded():
            # islanded: the merge intent is journaled and replayed at
            # re-promotion, instead of waiting out the dead tier
            sup.count_skip("manifest")
            sup.journal_manifest(source_key, doc)
            return
        try:
            self._storage.write(manifest_name(source_key),
                                json.dumps(doc, sort_keys=True).encode("utf-8"))
        except Exception as exc:
            # a manifest only helps a cold process: never fail the render
            if sup is not None:
                sup.record_failure("manifest")
                sup.journal_manifest(source_key, doc)
            logging.getLogger(LOGGER).warning(
                "variant manifest write for %s failed: %s", source_key, exc)
            return
        if sup is not None:
            sup.record_success("manifest")

    @staticmethod
    def _doc_locked(state: _SourceState) -> dict:
        return {
            "v": MANIFEST_VERSION,
            "source_mime": state.source_mime,
            "variants": {name: asdict(facts) for name, facts in state.variants.items()},
        }

    def _load_manifest(self, source_key: str) -> Optional[dict]:
        if self._storage is None:
            return None
        sup = self._supervisor
        if sup is not None and sup.islanded():
            # a read against the dead tier would wait out its timeout on
            # the render path; absent is the honest answer
            sup.count_skip("manifest")
            return None
        try:
            doc = json.loads(self._storage.read(manifest_name(source_key)).decode("utf-8"))
        except Exception:
            return None     # absent or damaged: remembered as negative
        if not isinstance(doc, dict) or doc.get("v") != MANIFEST_VERSION:
            return None
        return doc

    @staticmethod
    def _state_from_doc(doc: Optional[dict], now: float) -> _SourceState:
        if doc is None:
            return _SourceState(source_mime="", loaded_at=now, negative=True)
        variants: Dict[str, VariantFacts] = {}
        for name, row in (doc.get("variants") or {}).items():
            try:
                bg = row.get("background")
                variants[name] = VariantFacts(
                    name=str(name),
                    out_w=int(row["out_w"]),
                    out_h=int(row["out_h"]),
                    extension=str(row["extension"]),
                    quality=int(row["quality"]),
                    lossy=bool(row["lossy"]),
                    pure=bool(row["pure"]),
                    colorspace=row.get("colorspace"),
                    monochrome=bool(row.get("monochrome", False)),
                    background=tuple(bg) if bg is not None else None,
                    generations=int(row.get("generations", 0)),
                    src_w=int(row["src_w"]),
                    src_h=int(row["src_h"]),
                    frame_key=str(row.get("frame_key", "")),
                    stored_at=float(row.get("stored_at", 0.0)),
                )
            except (KeyError, TypeError, ValueError):
                continue    # one bad row does not lose the source
        return _SourceState(source_mime=str(doc.get("source_mime") or ""),
                            variants=variants, loaded_at=now, negative=False)


def replay_manifest(storage, source_key: str, doc: dict) -> None:
    """Merge one journaled manifest into the live one on the shared tier
    (the tier supervisor's replay). The live document is read afresh and
    the journaled variants merge into it by name, so renditions another
    replica stored meanwhile survive; a missing, damaged or foreign-version
    live document leaves the journaled one alone. A storage failure
    raises, so the replay stops and queues the intent again."""
    try:
        live = json.loads(storage.read(manifest_name(source_key)).decode("utf-8"))
    except Exception:
        live = None
    merged = dict(doc.get("variants") or {})
    source_mime = str(doc.get("source_mime") or "")
    if isinstance(live, dict) and live.get("v") == MANIFEST_VERSION:
        base = dict(live.get("variants") or {})
        base.update(merged)
        merged = base
        source_mime = source_mime or str(live.get("source_mime") or "")
    storage.write(manifest_name(source_key), json.dumps(
        {"v": MANIFEST_VERSION, "source_mime": source_mime, "variants": merged},
        sort_keys=True).encode("utf-8"))
