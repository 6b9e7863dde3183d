"""S3 storage: the port of ``flyimg_tpu/storage/s3.py`` (reference
S3StorageProvider.php), gated on boto3.

Validates credentials up front like the reference (S3StorageProvider.php:
27-29) and exposes the same public-URL pattern
``https://s3.{region}.amazonaws.com/{bucket}/{name}`` (:33)."""

from __future__ import annotations

import time
from typing import Optional

from flyimg_tpu_torch.exceptions import MissingParamsException
from flyimg_tpu_torch.storage.base import Storage, StorageStat


class S3Storage(Storage):
    def __init__(self, params) -> None:
        conf = params.by_key("aws_s3", {}) or {}
        self.access_id = conf.get("access_id", "")
        self.secret_key = conf.get("secret_key", "")
        self.region = conf.get("region", "")
        self.bucket = conf.get("bucket_name", "")
        if not all([self.access_id, self.secret_key, self.region, self.bucket]):
            raise MissingParamsException(
                "s3 storage selected but aws_s3 access_id/secret_key/region/"
                "bucket_name are not all set"
            )
        try:
            import boto3
        except ImportError as exc:
            raise MissingParamsException(
                "s3 storage selected but boto3 is not installed"
            ) from exc
        # split connect/read timeouts (the fetch-policy contract,
        # docs/resilience.md): a blackholed endpoint must fail at the
        # connect cap, not botocore's default (60s each). 0 = library
        # default, and no Config object is built at all — construction
        # is byte-identical with the knobs unset.
        client_kwargs = {}
        connect_t = float(
            params.by_key("storage_connect_timeout_s", 0.0) or 0.0
        )
        read_t = float(params.by_key("storage_read_timeout_s", 0.0) or 0.0)
        if connect_t > 0 or read_t > 0:
            from botocore.config import Config as _BotoConfig

            timeouts = {}
            if connect_t > 0:
                timeouts["connect_timeout"] = connect_t
            if read_t > 0:
                timeouts["read_timeout"] = read_t
            client_kwargs["config"] = _BotoConfig(**timeouts)
        self._client = boto3.client(
            "s3",
            aws_access_key_id=self.access_id,
            aws_secret_access_key=self.secret_key,
            region_name=self.region,
            **client_kwargs,
        )
        self._warned_403 = False

    @staticmethod
    def _error_code(exc: Exception) -> str:
        """botocore ClientError's Error.Code, duck-typed so the boto3
        import stays gated; '' when the shape doesn't match."""
        response = getattr(exc, "response", None)
        if isinstance(response, dict):
            return str(response.get("Error", {}).get("Code", ""))
        return ""

    # retryable S3 answers: throttling + internal errors (AWS's own SDK
    # retry classification, duck-typed on the error code so the boto3
    # import stays gated) and transport-level connection failures
    _TRANSIENT_CODES = frozenset(
        {
            "SlowDown", "Throttling", "ThrottlingException",
            "RequestTimeout", "RequestTimeoutException", "InternalError",
            "ServiceUnavailable", "500", "502", "503", "504",
        }
    )

    @classmethod
    def _is_transient(cls, exc: Exception) -> bool:
        if cls._error_code(exc) in cls._TRANSIENT_CODES:
            return True
        # botocore transport errors (EndpointConnectionError,
        # ConnectionClosedError, ReadTimeoutError...) share these name
        # stems; duck-typed like _error_code
        name = type(exc).__name__
        return "ConnectionError" in name or "Timeout" in name

    @classmethod
    def _is_not_found(cls, exc: Exception) -> bool:
        """Only genuine not-found responses mean "cache miss". Anything
        else (throttling, network) must PROPAGATE: treating an S3 outage
        as a miss would silently recompute + rewrite every request — a
        cost amplification with no error signal."""
        code = cls._error_code(exc)
        if code in ("404", "NoSuchKey", "NotFound"):
            return True
        # 403/AccessDenied is S3's documented answer for a MISSING key —
        # on HeadObject AND GetObject — when credentials lack s3:ListBucket
        # (a common least-privilege setup), so it must read as a miss on
        # every probe; propagating would 500 every uncached request under
        # that IAM shape. The cost: a genuinely denied read policy also
        # presents as a permanent miss (recompute + rewrite forever), so
        # fetch() logs the first swallowed GetObject 403 to give that
        # misconfiguration an error signal.
        return code in ("403", "AccessDenied")

    def has(self, name: str) -> bool:
        try:
            self._client.head_object(Bucket=self.bucket, Key=name)
            return True
        except Exception as exc:
            if self._is_not_found(exc):
                return False
            raise

    def read(self, name: str) -> bytes:
        def _read():
            obj = self._client.get_object(Bucket=self.bucket, Key=name)
            return obj["Body"].read()

        return self._with_retry("read", _read)

    def write(self, name: str, data: bytes) -> Optional[float]:
        self._with_retry(
            "write",
            lambda: self._client.put_object(
                Bucket=self.bucket, Key=name, Body=data
            ),
        )
        # PutObject returns no LastModified; read back the object's OWN
        # stamp so the miss response and every later cache hit serve the
        # IDENTICAL validator (Date-header/local-clock approximations can
        # disagree with LastModified by a second — enough to make a CDN
        # re-fetch unchanged bytes). One HeadObject per miss; hits pay
        # nothing (fetch() rides GetObject's LastModified). Best-effort:
        # the bytes ARE stored — a throttled metadata read-back must not
        # turn a successful write into a failed request.
        try:
            st = self.stat(name)
        except Exception:
            return time.time()
        return st.mtime if st is not None else time.time()

    def delete(self, name: str) -> None:
        self._client.delete_object(Bucket=self.bucket, Key=name)

    def stat(self, name: str):
        try:
            head = self._client.head_object(Bucket=self.bucket, Key=name)
            return StorageStat(mtime=head["LastModified"].timestamp())
        except Exception as exc:
            if self._is_not_found(exc):
                return None
            raise

    def fetch(self, name: str):
        try:
            obj = self._with_retry(
                "fetch",
                lambda: self._client.get_object(
                    Bucket=self.bucket, Key=name
                ),
            )
        except Exception as exc:
            if self._is_not_found(exc):
                code = self._error_code(exc)
                if code in ("403", "AccessDenied") and not self._warned_403:
                    self._warned_403 = True
                    import logging

                    logging.getLogger(__name__).warning(
                        "S3 GetObject on %r returned 403 — treated as a "
                        "cache miss (least-privilege IAM without "
                        "s3:ListBucket answers 403 for missing keys). If "
                        "reads are genuinely denied, every request will "
                        "recompute: check the bucket read policy.",
                        name,
                    )
                return None
            raise
        mtime = None
        if "LastModified" in obj:
            mtime = obj["LastModified"].timestamp()
        return obj["Body"].read(), StorageStat(mtime=mtime)

    def public_url(self, name: str, request_base: Optional[str] = None) -> str:
        return f"https://s3.{self.region}.amazonaws.com/{self.bucket}/{name}"
