"""Local-disk output store: the port of ``flyimg_tpu/storage/local.py``.

Rendered outputs live under ``upload_dir`` keyed by the reference's
content-addressed cache name (options hash + extension), so a repeat
request for the same options and source is served from disk. Writes are
atomic: each writer fills its own temporary file (``<name>.part-<pid>-
<thread>``, so two writers of one name never share one) and renames it
into place, so a reader sees a whole old file or a whole new one. The
public URL follows the reference: ``HOSTNAME_URL`` when set, else the
request's scheme://host, then ``/uploads/<name>``. ``prune`` keeps the
store under a byte budget and reclaims temporaries a killed writer left.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from typing import Optional

from flyimg_tpu_torch.storage.base import Storage, StorageStat

UPLOAD_WEB_DIR = "uploads/"

# local-disk errnos worth a retry: transient I/O pressure, not a missing
# file or a permission problem
_TRANSIENT_ERRNOS = frozenset(
    {errno.EIO, errno.EAGAIN, errno.EBUSY, errno.EINTR, errno.ENOSPC}
)


def is_temporary(name: str) -> bool:
    """A writer's temporary: the JAX package's ``<name>.part`` or this
    package's ``<name>.part-<pid>-<thread>``. Never an output."""
    return name.endswith(".part") or ".part-" in name


class LocalStorage(Storage):
    def __init__(self, params) -> None:
        self.root = os.path.abspath(params.by_key("upload_dir", "web/uploads"))
        os.makedirs(self.root, exist_ok=True)

    @staticmethod
    def _is_transient(exc: Exception) -> bool:
        return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS

    def _path(self, name: str) -> str:
        # content-addressed names are md5 hex + extension; never trust them
        # as paths
        return os.path.join(self.root, os.path.basename(name))

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def read(self, name: str) -> bytes:
        def _read():
            with open(self._path(name), "rb") as fh:
                return fh.read()

        return self._with_retry("read", _read)

    def write(self, name: str, data: bytes) -> Optional[float]:
        """Store ``data`` under ``name``; returns the stored mtime."""
        def _write():
            path = self._path(name)
            tmp = f"{path}.part-{os.getpid()}-{threading.get_ident()}"
            try:
                with open(tmp, "wb") as fh:
                    fh.write(data)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            try:
                return os.path.getmtime(path)
            except OSError:
                return None

        return self._with_retry("write", _write)

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def stat(self, name: str) -> Optional[StorageStat]:
        try:
            return StorageStat(mtime=os.stat(self._path(name)).st_mtime)
        except OSError:
            return None

    def list_names(self, prefix: str):
        """One scandir pass; temporaries stay invisible, so a listed name
        is always a completed atomic write."""
        names = []
        try:
            with os.scandir(self.root) as it:
                for entry in it:
                    if (entry.is_file() and entry.name.startswith(prefix)
                            and not is_temporary(entry.name)):
                        names.append(entry.name)
        except OSError:
            return []
        return names

    def fetch(self, name: str):
        """(bytes, StorageStat) of a stored output in one open, or None
        when absent."""
        def _fetch():
            with open(self._path(name), "rb") as fh:
                data = fh.read()
                mtime = os.fstat(fh.fileno()).st_mtime
            return data, StorageStat(mtime=mtime)

        try:
            return self._with_retry("fetch", _fetch)
        except OSError:
            return None

    def public_url(self, name: str, request_base: Optional[str] = None) -> str:
        base = os.environ.get("HOSTNAME_URL") or request_base or ""
        return f"{base.rstrip('/')}/{UPLOAD_WEB_DIR}{name}"

    def prune(self, max_bytes: int, part_ttl_s: float = 0.0) -> dict:
        """Evict least-recently-modified outputs until the store fits
        ``max_bytes`` (every output is recomputable, so eviction is always
        safe). Strict age cutoff: newest-first accumulation stops at the
        first output that would overflow the budget, and that one and
        everything older go, so every kept output is newer than every
        evicted one.

        ``part_ttl_s`` > 0 also reclaims temporaries older than the TTL (a
        writer killed between its open and its rename leaves one, invisible
        to listing and to the budget). The TTL must exceed any sane write.

        Returns {kept, deleted, bytes, parts}: ``bytes`` is what remains on
        disk (an output that failed to delete counts as kept), ``parts``
        the temporaries reclaimed."""
        entries = []
        parts = 0
        now = time.time()
        with os.scandir(self.root) as it:
            for entry in it:
                if not entry.is_file():
                    continue
                if is_temporary(entry.name):
                    if part_ttl_s > 0:
                        try:
                            if now - entry.stat().st_mtime > part_ttl_s:
                                os.remove(entry.path)
                                parts += 1
                        except OSError:  # a racing writer or prune: skip
                            pass
                    continue
                try:
                    st = entry.stat()
                except OSError:  # deleted concurrently
                    continue
                entries.append((st.st_mtime, st.st_size, entry.path))
        entries.sort(reverse=True)  # newest first
        total = kept = deleted = 0
        evicting = False
        for _mtime, size, path in entries:
            if not evicting and total + size <= max_bytes:
                total += size
                kept += 1
                continue
            evicting = True
            try:
                os.remove(path)
                deleted += 1
            except OSError:  # still on disk: report it honestly
                kept += 1
                total += size
        return {"kept": kept, "deleted": deleted, "bytes": total,
                "parts": parts}
