"""Local-disk output store (the JAX package's storage/local.py, reduced).

Rendered outputs live under ``upload_dir`` keyed by the reference's
content-addressed cache name (options hash + extension), so a repeat
request for the same options and source is served from disk. Writes are
atomic: each writer fills its own temporary file and renames it into
place, so a reader sees a whole old file or a whole new one.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple


class LocalStorage:
    def __init__(self, upload_dir: str) -> None:
        self.root = os.path.abspath(upload_dir)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        # content-addressed names are md5 hex + extension; never trust them
        # as paths
        return os.path.join(self.root, os.path.basename(name))

    def fetch(self, name: str) -> Optional[Tuple[bytes, float]]:
        """(bytes, mtime) of a stored output, or None when absent."""
        try:
            with open(self._path(name), "rb") as fh:
                data = fh.read()
                mtime = os.fstat(fh.fileno()).st_mtime
        except OSError:
            return None
        return data, mtime

    def write(self, name: str, data: bytes) -> Optional[float]:
        """Store ``data`` under ``name``; returns the stored mtime."""
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

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass
