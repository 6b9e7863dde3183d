"""HTTP response header policy.

Copied from the JAX package's service/response.py (the port of the
reference Response entity, src/Core/Entity/Response.php): CDN-friendly
long-cache headers, security headers, and the rf_1 debug/no-cache behavior.
``result`` is the handler's ``ProcessedImage``, duck-typed, so this module
does not import the handler.
"""

from __future__ import annotations

import email.utils
import time
from typing import Dict

SECURITY_HEADERS = {
    # reference Response.php:83-91
    "Strict-Transport-Security": "max-age=31536000; includeSubDomains",
    "Content-Security-Policy": "script-src 'self'",
    "X-Frame-Options": "SAMEORIGIN",
    "X-XSS-Protection": "1; mode=block",
    "X-Content-Type-Options": "nosniff",
    "Referrer-Policy": "strict-origin",
}


def image_headers(result, header_cache_days: int) -> Dict[str, str]:
    """reference Response.php:43-67."""
    headers = dict(SECURITY_HEADERS)
    headers["Content-Type"] = result.spec.mime
    headers["Content-Disposition"] = f'inline;filename="{result.spec.name}"'
    # ETag = content-addressed name (md5 of option values + source) PLUS
    # the stored artifact's mtime: the name alone identifies the REQUEST,
    # not the bytes — an rf_1 refresh rewrites new bytes under the same
    # name, and the mtime component is what mints a fresh validator then
    # (otherwise revalidating CDNs would 304 into stale bytes for up to
    # header_cache_days). The reference sends validators but never
    # answers 304s; conditional revalidation is pure bandwidth savings.
    if result.modified_at is not None:
        headers["ETag"] = f'"{result.spec.name}-{int(result.modified_at)}"'
    else:
        headers["ETag"] = f'"{result.spec.name}"'
    if result.spec.negotiated:
        # o_auto bodies depend on the Accept header (webp negotiation);
        # without Vary a shared cache serves one client's variant to all
        headers["Vary"] = "Accept"

    # brownout markers (runtime/brownout.py; docs/degradation.md): absent
    # entirely — no new headers — unless this response was actually
    # degraded, so the engine-off path stays byte-for-byte identical
    degraded_modes = list(result.degraded)
    if result.stale:
        degraded_modes.append("stale")
        # RFC 9111 stale marker: the bytes are a cache entry past its
        # freshness TTL, served while a background refresh re-renders
        headers["Warning"] = '110 - "Response is Stale"'
    if degraded_modes:
        headers["X-Flyimg-Degraded"] = ",".join(
            dict.fromkeys(degraded_modes)
        )

    refresh = result.options.wants_refresh()
    if refresh:
        headers["Cache-Control"] = "no-cache, private"
        # debug headers (reference Response.php:58-64): the exact device
        # program description stands in for the convert command line
        headers["im-command"] = result.spec.command_repr[:2000]
        if result.spec.identify_repr:
            # reference Response.php:62: `identify` line for the output
            headers["im-identify"] = result.spec.identify_repr[:2000]
        if result.timings:
            headers["x-flyimg-timings"] = ",".join(
                f"{k}={v * 1000:.1f}ms" for k, v in result.timings.items()
            )
    elif result.degraded or result.stale:
        # brownout artifacts must not be pinned downstream for a year of
        # max-age: plan-degraded bytes are never even stored in our own
        # cache, and a stale serve is bytes the server itself declared
        # expired — a CDN holding either for the long-cache period would
        # keep serving them long after the background refresh (the whole
        # point of SWR) produced fresh ones. One minute rides out the
        # spike.
        headers["Cache-Control"] = "max-age=60, public"
    else:
        long_cache = 3600 * 24 * int(header_cache_days)
        headers["Cache-Control"] = (
            f"max-age={long_cache}, public, s-maxage={long_cache}"
        )
        headers["Expires"] = email.utils.formatdate(
            time.time() + 365 * 24 * 3600, usegmt=True
        )
    # stored artifact's mtime like the reference (Response.php:72-78);
    # now() only when the backend can't say (e.g. S3 head failure)
    headers["Last-Modified"] = email.utils.formatdate(
        result.modified_at if result.modified_at is not None else time.time(),
        usegmt=True,
    )
    return headers


# headers a 304 must carry so caches can refresh stored metadata (RFC 9110
# section 15.4.5); body and entity headers stay home
NOT_MODIFIED_HEADERS = (
    "ETag", "Cache-Control", "Expires", "Last-Modified", "Vary",
)


def is_not_modified(request_headers, response_headers: Dict[str, str]) -> bool:
    """Did the client's conditional validators match? If-None-Match wins
    over If-Modified-Since (RFC 9110 section 13.2.2); debug/no-cache
    responses (rf_1) never shortcut — the client asked for a recompute."""
    if "no-cache" in response_headers.get("Cache-Control", ""):
        return False
    etag = response_headers.get("ETag", "")
    inm = request_headers.get("If-None-Match", "")
    if inm and etag:
        tags = [t.strip().removeprefix("W/") for t in inm.split(",")]
        return "*" in tags or etag in tags
    ims = request_headers.get("If-Modified-Since", "")
    last_mod = response_headers.get("Last-Modified", "")
    if ims and last_mod:
        try:
            return (
                email.utils.parsedate_to_datetime(last_mod)
                <= email.utils.parsedate_to_datetime(ims)
            )
        except (TypeError, ValueError):
            return False
    return False
