"""Source fetching + the level-1 (original bytes) cache.

The port of ``flyimg_tpu/service/input_source.py``, on the standard
library: originals are cached at ``tmp_dir/original-<md5(url-sans-query)>``
(the reference's InputImage.php:76-101), a refresh (rf_1) rewrites the
cached original, local filesystem paths and ``file://`` URLs work as
sources, and ``http(s)`` sources go through ``http.client`` with the
configured extra headers, the JAX policy's split timeouts (connect, then
the socket's write timeout for the request and its read timeout for the
answer, each capped by the request's remaining deadline), no redirects,
and the transfer
aborted past the ``mem_max_source_bytes`` parameter (``MAX_SOURCE_BYTES``
by default) or when the request's deadline is spent
(the body is read in chunks, so a slow-drip origin cannot hold it). Each
attempt passes the origin's circuit breaker, and a transient failure
(a connection or transport error, an answer of 429 or 5xx) is retried with
full-jitter backoff within the deadline (``FetchPolicy``, from the
``retry_*``, ``breaker_*`` and ``fetch_{connect,read,write}_timeout_s``
parameters); the
``fetch.http`` fault point fires in each attempt. With
``negative_cache_ttl_s`` an origin whose retries ran out, or whose breaker
is open, answers 502 at once for that long (``runtime/brownout.py
NegativeCache``; the origin cache is read first). Video and PDF sources
are swapped for a frame or a page before decode (``load_source``).
"""

from __future__ import annotations

import http.client
import os
import threading
import urllib.error
import urllib.parse
from dataclasses import dataclass, field
from typing import Dict, Optional

from flyimg_tpu_torch.codecs import MediaInfo, media_info
from flyimg_tpu_torch.exceptions import (
    AppException,
    OriginUnavailableException,
    ReadFileException,
)
from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.brownout import NegativeCache
from flyimg_tpu_torch.runtime.resilience import (
    BreakerRegistry,
    CircuitOpenException,
    Deadline,
    RetryPolicy,
    host_of,
)
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.testing import faults

#: the default bound of a source's bytes; the ``mem_max_source_bytes``
#: parameter sets a server's (``FetchPolicy.max_source_bytes``)
MAX_SOURCE_BYTES = 256 * 1024 * 1024
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
    """A server's fetch resilience: the split timeouts (seconds to connect,
    between reads of the answer, and to send the request), the retry
    policy, the per-host breakers and the source byte bound (0: the
    module's ``MAX_SOURCE_BYTES``)."""

    connect_timeout_s: float = 3.0
    read_timeout_s: float = 10.0
    write_timeout_s: float = 10.0
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    breakers: BreakerRegistry = field(default_factory=BreakerRegistry)
    max_source_bytes: int = 0
    #: the negative origin cache (``negative_cache_ttl_s`` > 0), or None
    negative: Optional[NegativeCache] = None

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "FetchPolicy":
        negative_ttl = float(params.by_key("negative_cache_ttl_s", 0.0) or 0.0)
        return cls(
            connect_timeout_s=float(params.by_key("fetch_connect_timeout_s", 3.0)),
            read_timeout_s=float(params.by_key("fetch_read_timeout_s", 10.0)),
            write_timeout_s=float(params.by_key("fetch_write_timeout_s", 10.0)),
            retry=RetryPolicy.from_params(params, metrics=metrics),
            breakers=BreakerRegistry.from_params(params, metrics=metrics),
            max_source_bytes=int(params.by_key("mem_max_source_bytes", 0) or 0),
            negative=(
                NegativeCache(
                    negative_ttl,
                    max_entries=int(params.by_key("negative_cache_max_entries", 1024)),
                    metrics=metrics,
                )
                if negative_ttl > 0 else None
            ),
        )

    def timeouts(self, flat_cap: Optional[float] = None) -> Dict[str, float]:
        """The component timeouts (``connect``, ``read``, ``write`` and
        ``pool``, the JAX policy's ``httpx.Timeout`` fields), each capped by
        ``flat_cap`` (the remaining deadline) when given."""

        def cap(v: float) -> float:
            return min(v, flat_cap) if flat_cap is not None else v

        return {"connect": cap(self.connect_timeout_s), "read": cap(self.read_timeout_s),
                "write": cap(self.write_timeout_s), "pool": cap(self.connect_timeout_s)}


def _source_byte_cap(policy: Optional[FetchPolicy]) -> int:
    """The bound of a source's bytes: the policy's when set, else
    ``MAX_SOURCE_BYTES``."""
    if policy is not None and policy.max_source_bytes > 0:
        return int(policy.max_source_bytes)
    return MAX_SOURCE_BYTES


@dataclass
class InputSource:
    """Fetched source, ready for decode: ``data`` is the image (a video's
    frame or a PDF's page where the original is one), ``info`` the sniff of
    the ORIGINAL (the output format resolves against it, as in the JAX
    package) and ``data_info`` the sniff of ``data`` (what decodes)."""

    data: bytes
    info: MediaInfo
    cache_path: str
    source_url: str
    data_info: Optional[MediaInfo] = None

    def __post_init__(self) -> None:
        if self.data_info is None:
            self.data_info = self.info


def _parse_extra_headers(header_extra_options: str) -> dict:
    headers = {}
    for line in (header_extra_options or "").splitlines():
        if ":" in line:
            name, value = line.split(":", 1)
            headers[name.strip()] = value.strip()
    return headers


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


def _http_fetch_once(image_url: str, headers: dict, timeouts: Dict[str, float],
                     deadline: Optional[Deadline] = None,
                     cap: int = MAX_SOURCE_BYTES) -> bytes:
    """ONE fetch attempt of at most ``cap`` bytes (``FetchPolicy.timeouts``:
    connect, then the request sent under the write timeout and the answer
    read under the read timeout); no redirect is followed (the reference's
    max_redirects 0): any answer but 2xx raises ``HTTPError``, as urllib's
    does. The retries and the breaker are the caller's."""
    injected = faults.fire("fetch.http", url=image_url)
    if injected is not faults.PASS:
        return injected
    parts = urllib.parse.urlsplit(image_url)
    if parts.scheme not in ("http", "https"):
        raise urllib.error.URLError(f"unknown url type: {parts.scheme}")
    conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                else http.client.HTTPConnection)
    conn = conn_cls(parts.hostname, parts.port, timeout=timeouts["connect"])
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    try:
        try:
            conn.connect()
            conn.sock.settimeout(timeouts["write"])
            conn.request("GET", target, headers={**headers, "Connection": "close"})
        except OSError as exc:  # nothing answered: urllib's URLError
            raise urllib.error.URLError(exc) from exc
        conn.sock.settimeout(timeouts["read"])
        resp = conn.getresponse()
        if not 200 <= resp.status < 300:
            raise urllib.error.HTTPError(image_url, resp.status, resp.reason,
                                         resp.headers, None)
        length = resp.headers.get("Content-Length")
        if length and length.isdigit() and int(length) > cap:
            raise ReadFileException(f"source {image_url} exceeds {cap} bytes")
        return _read_capped(resp, cap, image_url, deadline)
    finally:
        conn.close()


def _http_fetch(image_url: str, headers: dict, policy: FetchPolicy,
                deadline: Optional[Deadline]) -> bytes:
    """The fetch with the origin's breaker and the retry policy, within the
    request's deadline. With a negative cache an origin that failed
    recently answers 502 at once; an open breaker enters the origin, and
    retries used up on a transient failure the origin (nothing connected)
    or the resource (the origin answered 5xx)."""
    negative = policy.negative
    if negative is not None:
        cached_error = negative.hit(image_url)
        if cached_error is not None:
            host = negative.key_for(image_url)[0]
            tracing.add_event("fetch.negative_cache_hit", host=host, error=cached_error)
            raise OriginUnavailableException(
                f"origin {host} is negative-cached as recently failing "
                f"({cached_error}); not re-fetching {image_url}")
    breaker = policy.breakers.for_host(host_of(image_url))

    def attempt() -> bytes:
        # nothing may fail between allow() and the record_* calls, or an
        # admitted half-open probe would leave the breaker half-open
        flat = None
        if deadline is not None:
            deadline.check("fetch")
            rem = deadline.remaining()
            flat = rem if rem != float("inf") else None
        timeouts = policy.timeouts(flat)
        breaker.allow()
        try:
            data = _http_fetch_once(image_url, headers, timeouts, deadline,
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
    except CircuitOpenException:
        if negative is not None:
            negative.add(image_url, "circuit_open")
        raise
    except AppException:
        raise
    except (urllib.error.URLError, OSError, ValueError,
            http.client.HTTPException) as exc:
        if negative is not None and is_transient_fetch_error(exc):
            # the origin, not this request, is at fault: an answer of 5xx
            # or 429 proves only this resource bad
            negative.add(image_url, type(exc).__name__,
                         resource=isinstance(exc, urllib.error.HTTPError))
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
    device="cuda",
) -> InputSource:
    """Fetch and ingest a source: a video becomes its frame at ``tm_``
    (``codecs/video.py``: OpenCV or ffmpeg; 415 without both), a PDF its
    page at ``pg_``/``dnst_`` (``codecs/pdf.py``: ghostscript, else the
    image-only rasterizer, its DCT images through the JPEG kernels on
    ``device``). Frames and pages are cached beside the original under the
    JAX package's names (``<original>-<time>.jpg``, ``-p<page>-d<density>.png``,
    the reference's ``<src>-<time>`` frame cache, VideoProcessor.php:28-33);
    ``rf_1`` makes them anew."""
    refresh = options.wants_refresh()
    cache_path = fetch_original(
        image_url, tmp_dir, refresh=refresh,
        header_extra_options=header_extra_options,
        policy=policy, deadline=deadline,
    )
    with open(cache_path, "rb") as fh:
        data = fh.read()
    info = media_info(data)
    data_path = cache_path
    if info.is_video:
        from flyimg_tpu_torch.codecs import video

        time_spec = str(options.get("time") or "00:00:01")
        # ':' and '.' stay distinguishable in the name (tm_1.5 is not
        # tm_15) and the name stays a file name
        safe_time = time_spec.replace(":", "-").replace(".", "_")
        data_path = f"{cache_path}-{safe_time}.jpg"
        if not os.path.exists(data_path) or refresh:
            video.extract_frame(cache_path, time_spec, data_path)
    elif info.is_pdf:
        from flyimg_tpu_torch.codecs import pdf

        page = options.int_option("page_number", 1) or 1
        density = options.int_option("density")
        data_path = f"{cache_path}-p{page}-d{density or 0}.png"
        if not os.path.exists(data_path) or refresh:
            pdf.rasterize_page(cache_path, data_path, page, density, device=device)
    if data_path == cache_path:
        return InputSource(data=data, info=info, cache_path=cache_path, source_url=image_url)
    with open(data_path, "rb") as fh:
        page_data = fh.read()
    return InputSource(data=page_data, info=info, cache_path=cache_path,
                       source_url=image_url, data_info=media_info(page_data))
