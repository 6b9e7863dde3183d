"""Typed exception hierarchy.

Mirrors the reference's marker exceptions (reference: src/Core/Exception/*.php)
so the HTTP layer can map failure classes to status codes the same way.
"""


class AppException(Exception):
    """Base application error (reference: src/Core/Exception/AppException.php)."""


class ExecFailedException(AppException):
    """A processing stage failed (reference: ExecFailedException.php).

    In the reference this wraps a non-zero exit code from an exec()'d binary
    (src/Core/Processor/Processor.php:53-59); here it wraps codec or device
    pipeline failures.
    """


class InvalidArgumentException(AppException):
    """Bad request option value (reference: InvalidArgumentException.php)."""


class MissingParamsException(AppException):
    """Server configuration is missing a required parameter."""


class ReadFileException(AppException):
    """Source image could not be fetched/read (reference: ReadFileException.php,
    raised at src/Core/Entity/Image/InputImage.php:92-97)."""


class SecurityException(AppException):
    """Signed-URL or domain-restriction violation (reference: SecurityException.php)."""


class UnsupportedMediaException(AppException):
    """Input media type needs an ingestion backend that is not available
    (e.g. video without ffmpeg, PDF without ghostscript). Not present in the
    reference (its Docker image bundles those binaries); this framework gates
    them at runtime instead."""


class OriginUnavailableException(AppException):
    """The source origin is negative-cached as recently failing
    (runtime/brownout.py NegativeCache): the fetch short-circuits to an
    immediate 502 instead of burning connect/read timeouts and deadline
    budget re-proving a dead origin. Distinct from ReadFileException
    (404: THIS source could not be read) — a 502 tells the caller the
    upstream, not the request, is the problem."""


class ServiceUnavailableException(AppException):
    """The service is shedding this request: a wedged device pipeline, a
    full admission queue, or an open upstream circuit. Maps to 503 (+
    Retry-After from the ``retry_after_s`` attribute when set) so load
    balancers shed/retry instead of holding sockets open. No reference
    analog (its per-request exec model cannot wedge followers)."""

    #: advisory client backoff, surfaced as the Retry-After header
    retry_after_s: int = 1


class PayloadTooLargeException(AppException):
    """The source exceeds a configured byte or pixel bound
    (``mem_max_source_bytes`` / ``mem_max_source_pixels``,
    docs/resilience.md "Memory governor"): rejected from the header
    sniff, BEFORE the full body is buffered or decoded, so one
    pathological source cannot balloon host memory. Maps to 413 — the
    request, not the service, is over the limit, and retrying the same
    bytes will never succeed."""


class DeadlineExceededException(AppException):
    """The per-request latency budget (runtime/resilience.py Deadline) ran
    out mid-pipeline. Maps to 504: the request fails fast instead of
    holding a socket for the sum of every remaining stage timeout."""


class NotPortedException(AppException):
    """The plan needs a device stage this package does not carry yet
    (pad, grayscale, monochrome, rotate, unsharp, sharpen or blur). Raised
    when the program is built, naming the stage, so a request never
    silently skips work. Maps to 501."""
