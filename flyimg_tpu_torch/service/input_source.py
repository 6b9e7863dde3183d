"""Source fetching + the level-1 (original bytes) cache.

The port of ``flyimg_tpu/service/input_source.py``, on the standard
library: originals are cached at ``tmp_dir/original-<md5(url-sans-query)>``
(the reference's InputImage.php:76-101), a refresh (rf_1) rewrites the
cached original, local filesystem paths and ``file://`` URLs work as
sources, and ``http(s)`` sources go through ``urllib.request`` with the
configured extra headers, a timeout, no redirects, and the transfer
aborted past the ``mem_max_source_bytes`` parameter (``MAX_SOURCE_BYTES``
by default) or when the request's deadline is spent
(the body is read in chunks, so a slow-drip origin cannot hold it). Each
attempt passes the origin's circuit breaker, and a transient failure
(a connection or transport error, an answer of 429 or 5xx) is retried with
full-jitter backoff within the deadline (``FetchPolicy``, from the
``retry_*``, ``breaker_*`` and ``fetch_read_timeout_s`` parameters); the
``fetch.http`` fault point fires in each attempt.
"""

from __future__ import annotations

import http.client
import os
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

from flyimg_tpu_torch.codecs import MediaInfo, media_info
from flyimg_tpu_torch.exceptions import (
    AppException,
    ReadFileException,
    UnsupportedMediaException,
)
from flyimg_tpu_torch.runtime.resilience import (
    BreakerRegistry,
    Deadline,
    RetryPolicy,
    host_of,
)
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.testing import faults

#: the default bound of a source's bytes; the ``mem_max_source_bytes``
#: parameter sets a server's (``FetchPolicy.max_source_bytes``)
MAX_SOURCE_BYTES = 256 * 1024 * 1024
#: seconds an http(s) fetch may take to connect or between reads
FETCH_TIMEOUT_S = 10.0
_CHUNK = 1 << 16


def is_transient_fetch_error(exc: BaseException) -> bool:
    """The one transient-or-deterministic split of source fetch failures,
    shared by the retries and the breaker: no answer (refused, reset,
    timed out, cut off) or an answer of 429 or 5xx is transient; any other
    answer, and the byte cap, are the request's."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code == 429 or 500 <= exc.code <= 599
    return isinstance(exc, (urllib.error.URLError, TimeoutError, ConnectionError,
                            http.client.HTTPException))


@dataclass
class FetchPolicy:
    """A server's fetch resilience: the per-read timeout, the retry policy,
    the per-host breakers and the source byte bound (0: the module's
    ``MAX_SOURCE_BYTES``)."""

    timeout_s: float = FETCH_TIMEOUT_S
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    breakers: BreakerRegistry = field(default_factory=BreakerRegistry)
    max_source_bytes: int = 0

    @classmethod
    def from_params(cls, params) -> "FetchPolicy":
        return cls(
            timeout_s=float(params.by_key("fetch_read_timeout_s", FETCH_TIMEOUT_S)),
            retry=RetryPolicy.from_params(params),
            breakers=BreakerRegistry.from_params(params),
            max_source_bytes=int(params.by_key("mem_max_source_bytes", 0) or 0),
        )


def _source_byte_cap(policy: Optional[FetchPolicy]) -> int:
    """The bound of a source's bytes: the policy's when set, else
    ``MAX_SOURCE_BYTES``."""
    if policy is not None and policy.max_source_bytes > 0:
        return int(policy.max_source_bytes)
    return MAX_SOURCE_BYTES


@dataclass
class InputSource:
    """Fetched source, ready for decode."""

    data: bytes
    info: MediaInfo
    cache_path: str
    source_url: str


def _parse_extra_headers(header_extra_options: str) -> dict:
    headers = {}
    for line in (header_extra_options or "").splitlines():
        if ":" in line:
            name, value = line.split(":", 1)
            headers[name.strip()] = value.strip()
    return headers


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):  # reference: max_redirects 0
        return None


def _read_capped(stream, cap: int, what: str,
                 deadline: Optional[Deadline] = None) -> bytes:
    chunks, total = [], 0
    while True:
        if deadline is not None:
            deadline.check("fetch")
        chunk = stream.read(min(_CHUNK, cap + 1 - total))
        if not chunk:
            return b"".join(chunks)
        total += len(chunk)
        if total > cap:
            raise ReadFileException(f"source {what} exceeds {cap} bytes")
        chunks.append(chunk)


def _http_fetch_once(image_url: str, headers: dict, timeout: float,
                     deadline: Optional[Deadline] = None,
                     cap: int = MAX_SOURCE_BYTES) -> bytes:
    """ONE fetch attempt of at most ``cap`` bytes; the retries and the
    breaker are the caller's."""
    injected = faults.fire("fetch.http", url=image_url)
    if injected is not faults.PASS:
        return injected
    opener = urllib.request.build_opener(_NoRedirect)
    request = urllib.request.Request(image_url, headers=headers)
    with opener.open(request, timeout=timeout) as resp:
        length = resp.headers.get("Content-Length")
        if length and length.isdigit() and int(length) > cap:
            raise ReadFileException(f"source {image_url} exceeds {cap} bytes")
        return _read_capped(resp, cap, image_url, deadline)


def _http_fetch(image_url: str, headers: dict, policy: FetchPolicy,
                deadline: Optional[Deadline]) -> bytes:
    """The fetch with the origin's breaker and the retry policy, within the
    request's deadline."""
    breaker = policy.breakers.for_host(host_of(image_url))

    def attempt() -> bytes:
        # nothing may fail between allow() and the record_* calls, or an
        # admitted half-open probe would leave the breaker half-open
        timeout = policy.timeout_s
        if deadline is not None:
            deadline.check("fetch")
            timeout = deadline.timeout(timeout)
        breaker.allow()
        try:
            data = _http_fetch_once(image_url, headers, timeout, deadline,
                                    _source_byte_cap(policy))
        except BaseException as exc:
            if is_transient_fetch_error(exc):
                breaker.record_failure()
            else:
                breaker.record_success()    # the origin answered
            raise
        breaker.record_success()
        return data

    try:
        return policy.retry.run(attempt, retryable=is_transient_fetch_error,
                                deadline=deadline, point="fetch")
    except AppException:
        raise
    except (urllib.error.URLError, OSError, ValueError,
            http.client.HTTPException) as exc:
        raise ReadFileException(
            f"Unable to fetch source image: {image_url}: {exc}"
        ) from exc


def fetch_original(
    image_url: str,
    tmp_dir: str,
    *,
    refresh: bool = False,
    header_extra_options: str = "",
    policy: Optional[FetchPolicy] = None,
    deadline: Optional[Deadline] = None,
) -> str:
    """Fetch (or reuse) the original source; returns its cache path."""
    os.makedirs(tmp_dir, exist_ok=True)
    cache_path = os.path.join(
        tmp_dir, OptionsBag.hash_original_image_url(image_url)
    )
    if os.path.exists(cache_path) and not refresh:
        return cache_path
    if deadline is not None:
        deadline.check("fetch")
    scheme = urllib.parse.urlsplit(image_url).scheme.lower()
    if scheme in ("http", "https"):
        data = _http_fetch(
            image_url, _parse_extra_headers(header_extra_options),
            policy if policy is not None else FetchPolicy(), deadline,
        )
    elif scheme in ("", "file"):
        path = (
            urllib.parse.unquote(urllib.parse.urlsplit(image_url).path)
            if scheme == "file" else image_url
        )
        if not os.path.isfile(path):
            raise ReadFileException(f"Unable to read file: {image_url}")
        with open(path, "rb") as fh:
            data = _read_capped(fh, _source_byte_cap(policy), image_url)
    else:
        raise ReadFileException(f"Unable to read file: {image_url}")
    # unique temp per writer, atomic rename: concurrent fetches of one URL
    # never share a partial file
    tmp = f"{cache_path}.part-{os.getpid()}-{threading.get_ident()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, cache_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return cache_path


def load_source(
    image_url: str,
    options: OptionsBag,
    tmp_dir: str,
    *,
    header_extra_options: str = "",
    policy: Optional[FetchPolicy] = None,
    deadline: Optional[Deadline] = None,
) -> InputSource:
    """Fetch a source and sniff it. Video and PDF ingestion are not ported
    yet and raise ``UnsupportedMediaException``."""
    cache_path = fetch_original(
        image_url, tmp_dir, refresh=options.wants_refresh(),
        header_extra_options=header_extra_options,
        policy=policy, deadline=deadline,
    )
    with open(cache_path, "rb") as fh:
        data = fh.read()
    info = media_info(data)
    if info.is_video or info.is_pdf:
        raise UnsupportedMediaException(
            f"{info.mime} ingestion is not ported to the PyTorch package yet"
        )
    return InputSource(
        data=data, info=info, cache_path=cache_path, source_url=image_url
    )
