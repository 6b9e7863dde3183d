"""Source fetching + the level-1 (original bytes) cache.

The port of ``flyimg_tpu/service/input_source.py``, on the standard
library: originals are cached at ``tmp_dir/original-<md5(url-sans-query)>``
(the reference's InputImage.php:76-101), a refresh (rf_1) rewrites the
cached original, local filesystem paths and ``file://`` URLs work as
sources, and ``http(s)`` sources go through ``urllib.request`` with the
configured extra headers, a timeout, no redirects, and the transfer
aborted past ``MAX_SOURCE_BYTES``.
"""

from __future__ import annotations

import os
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

from flyimg_tpu_torch.codecs import MediaInfo, media_info
from flyimg_tpu_torch.exceptions import (
    ReadFileException,
    UnsupportedMediaException,
)
from flyimg_tpu_torch.spec.options import OptionsBag

MAX_SOURCE_BYTES = 256 * 1024 * 1024
#: seconds an http(s) fetch may take to connect or between reads
FETCH_TIMEOUT_S = 10.0


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


def _read_capped(stream, cap: int, what: str) -> bytes:
    data = stream.read(cap + 1)
    if len(data) > cap:
        raise ReadFileException(f"source {what} exceeds {cap} bytes")
    return data


def _http_fetch(image_url: str, headers: dict, timeout: float) -> bytes:
    opener = urllib.request.build_opener(_NoRedirect)
    request = urllib.request.Request(image_url, headers=headers)
    try:
        with opener.open(request, timeout=timeout) as resp:
            length = resp.headers.get("Content-Length")
            if length and length.isdigit() and int(length) > MAX_SOURCE_BYTES:
                raise ReadFileException(
                    f"source {image_url} exceeds {MAX_SOURCE_BYTES} bytes"
                )
            return _read_capped(resp, MAX_SOURCE_BYTES, image_url)
    except (urllib.error.URLError, OSError, ValueError) as exc:
        raise ReadFileException(
            f"Unable to fetch source image: {image_url}: {exc}"
        ) from exc


def fetch_original(
    image_url: str,
    tmp_dir: str,
    *,
    refresh: bool = False,
    header_extra_options: str = "",
) -> str:
    """Fetch (or reuse) the original source; returns its cache path."""
    os.makedirs(tmp_dir, exist_ok=True)
    cache_path = os.path.join(
        tmp_dir, OptionsBag.hash_original_image_url(image_url)
    )
    if os.path.exists(cache_path) and not refresh:
        return cache_path
    scheme = urllib.parse.urlsplit(image_url).scheme.lower()
    if scheme in ("http", "https"):
        data = _http_fetch(
            image_url, _parse_extra_headers(header_extra_options),
            FETCH_TIMEOUT_S,
        )
    elif scheme in ("", "file"):
        path = (
            urllib.parse.unquote(urllib.parse.urlsplit(image_url).path)
            if scheme == "file" else image_url
        )
        if not os.path.isfile(path):
            raise ReadFileException(f"Unable to read file: {image_url}")
        with open(path, "rb") as fh:
            data = _read_capped(fh, MAX_SOURCE_BYTES, image_url)
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
) -> InputSource:
    """Fetch a source and sniff it. Video and PDF ingestion are not ported
    yet and raise ``UnsupportedMediaException``."""
    cache_path = fetch_original(
        image_url, tmp_dir, refresh=options.wants_refresh(),
        header_extra_options=header_extra_options,
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
