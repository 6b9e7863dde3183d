"""Google Cloud Storage backend: the port of ``flyimg_tpu/storage/gcs.py``,
gated on google-cloud-storage.

Beyond the reference (flyimg ships local and S3 only): GCS is a natural
shared store for the multi-host serving tier. Same validator contract as
the S3 provider: write() returns the object's own stamp so miss responses
and later cache hits carry the identical Last-Modified. Cache hits use the
base-class fetch() (metadata GET + download — the GCS client does not
surface object metadata from a media download, so unlike S3 there is no
single-call path)."""

from __future__ import annotations

import time
from typing import Optional

from flyimg_tpu_torch.exceptions import MissingParamsException
from flyimg_tpu_torch.storage.base import Storage, StorageStat


class GCSStorage(Storage):
    def __init__(self, params) -> None:
        conf = params.by_key("gcs", {}) or {}
        self.bucket_name = conf.get("bucket_name", "")
        if not self.bucket_name:
            raise MissingParamsException(
                "gcs storage selected but gcs.bucket_name is not set"
            )
        try:
            from google.cloud import storage as gcs
        except ImportError as exc:
            raise MissingParamsException(
                "gcs storage selected but google-cloud-storage is not "
                "installed"
            ) from exc
        # project/credentials resolve via Application Default Credentials,
        # the standard on GCP hosts
        self._client = gcs.Client(project=conf.get("project") or None)
        self._bucket = self._client.bucket(self.bucket_name)
        # split connect/read timeouts (the fetch-policy contract,
        # docs/resilience.md): google-cloud-storage takes them per call
        # as a (connect, read) tuple, not at client construction. 0 =
        # library default; with both unset no kwarg is passed at all, so
        # calls are byte-identical (and fakes without a timeout param
        # keep working).
        connect_t = float(
            params.by_key("storage_connect_timeout_s", 0.0) or 0.0
        )
        read_t = float(params.by_key("storage_read_timeout_s", 0.0) or 0.0)
        if connect_t > 0 and read_t > 0:
            self._call_kwargs = {"timeout": (connect_t, read_t)}
        elif connect_t > 0 or read_t > 0:
            self._call_kwargs = {"timeout": connect_t or read_t}
        else:
            self._call_kwargs = {}

    @staticmethod
    def _is_transient(exc: Exception) -> bool:
        """google-api-core's own retryable set, duck-typed on ``code``
        (429 throttling + 5xx server errors), plus transport-level
        connection failures / timeouts (requests/urllib3 raise these with
        no ``code``), name-stem-matched like the S3 classifier."""
        if getattr(exc, "code", None) in (429, 500, 502, 503, 504):
            return True
        name = type(exc).__name__
        return "ConnectionError" in name or "Timeout" in name

    @staticmethod
    def _is_not_found(exc: Exception) -> bool:
        """Missing objects only (404); outages AND permission errors must
        propagate (a miss triggers recompute+rewrite, so an error misread
        as 'absent' is a silent cost amplification). Unlike S3, GCS never
        answers a missing key with 403 — 403 strictly means permission
        denied, so it propagates. Duck-typed on google-api-core
        exceptions' ``code`` attribute so the import stays gated."""
        return getattr(exc, "code", None) == 404

    def has(self, name: str) -> bool:
        try:
            return self._bucket.blob(name).exists(**self._call_kwargs)
        except Exception as exc:
            if self._is_not_found(exc):
                return False
            raise

    def read(self, name: str) -> bytes:
        return self._with_retry(
            "read",
            lambda: self._bucket.blob(name).download_as_bytes(
                **self._call_kwargs
            ),
        )

    def write(self, name: str, data: bytes) -> Optional[float]:
        def _write():
            blob = self._bucket.blob(name)
            blob.upload_from_string(data, **self._call_kwargs)
            # upload_from_string refreshes blob metadata from the response:
            # the object's OWN stamp, so hits serve the identical validator
            updated = getattr(blob, "updated", None)
            return (
                updated.timestamp() if updated is not None else time.time()
            )

        return self._with_retry("write", _write)

    def delete(self, name: str) -> None:
        try:
            self._bucket.blob(name).delete(**self._call_kwargs)
        except Exception as exc:
            if not self._is_not_found(exc):
                raise

    def stat(self, name: str) -> Optional[StorageStat]:
        try:
            blob = self._bucket.get_blob(name, **self._call_kwargs)
        except Exception as exc:
            if self._is_not_found(exc):
                return None
            raise
        if blob is None:
            return None
        updated = getattr(blob, "updated", None)
        return StorageStat(
            mtime=updated.timestamp() if updated is not None else None
        )

    def public_url(self, name: str, request_base: Optional[str] = None) -> str:
        return f"https://storage.googleapis.com/{self.bucket_name}/{name}"
