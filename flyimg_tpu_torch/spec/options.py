"""URL options DSL: short-key grammar, defaults, and cache-key hashing.

Re-implements the reference's option handling so URLs (and, where possible,
cache names) are drop-in compatible:

- short->canonical key map and defaults: reference config/parameters.yml:43-120
- parse/merge semantics:                 reference src/Core/Entity/OptionsBag.php:40-56
- cache-key hashing:                     reference src/Core/Entity/OptionsBag.php:65-91

Parsing rules preserved exactly:
- the options string splits on the configured separator (default ","),
- each piece splits on underscores; only the FIRST two underscore-separated
  fields are used (``explode('_', $option)[1]`` in PHP — so ``tm_00:00:10``
  keeps its value because ':' is not '_', while a value containing '_' is
  truncated at the first '_', matching the reference),
- unknown short keys are silently ignored,
- parsed values override defaults but keep each key's position from the
  defaults table (PHP array_merge semantics), which matters for the cache hash.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, Optional

# reference: config/parameters.yml:43-80 (options_keys)
OPTIONS_KEYS: Dict[str, str] = {
    "moz": "mozjpeg",
    "q": "quality",
    "o": "output",
    "unsh": "unsharp",
    "sh": "sharpen",
    "blr": "blur",
    "fc": "face-crop",
    "fcp": "face-crop-position",
    "fb": "face-blur",
    "w": "width",
    "h": "height",
    "c": "crop",
    "bg": "background",
    "st": "strip",
    "rz": "resize",
    "g": "gravity",
    "f": "filter",
    "r": "rotate",
    "sc": "scale",
    "sf": "sampling-factor",
    "rf": "refresh",
    "smc": "smart-crop",
    "ett": "extent",
    "par": "preserve-aspect-ratio",
    "pns": "preserve-natural-size",
    "webpl": "webp-lossless",
    "gf": "gif-frame",
    "e": "extract",
    "p1x": "extract-top-x",
    "p1y": "extract-top-y",
    "p2x": "extract-bottom-x",
    "p2y": "extract-bottom-y",
    "pg": "page_number",
    "tm": "time",
    "clsp": "colorspace",
    "mnchr": "monochrome",
    "dnst": "density",
}

# reference: config/parameters.yml:82-120 (default_options); insertion order is
# load-bearing for hashed_options (PHP implode over the merged array).
DEFAULT_OPTIONS: Dict[str, Any] = {
    "mozjpeg": 1,
    "quality": 90,
    "output": "auto",
    "unsharp": None,
    "sharpen": None,
    "blur": None,
    "face-crop": 0,
    "face-crop-position": 0,
    "face-blur": 0,
    "width": None,
    "height": None,
    "crop": None,
    "background": None,
    "strip": 1,
    "resize": None,
    "gravity": "Center",
    "filter": "Lanczos",
    "rotate": None,
    "scale": None,
    "sampling-factor": "1x1",
    "refresh": False,
    "smart-crop": False,
    "extent": None,
    "preserve-aspect-ratio": 1,
    "preserve-natural-size": 1,
    "webp-lossless": 0,
    "gif-frame": 0,
    "extract": None,
    "extract-top-x": None,
    "extract-top-y": None,
    "extract-bottom-x": None,
    "extract-bottom-y": None,
    "page_number": 1,
    "time": "00:00:01",
    "colorspace": "sRGB",
    "monochrome": None,
    "density": None,
}


def _php_str(value: Any) -> str:
    """String conversion with PHP's implode() coercion rules, so cache names
    stay byte-compatible with the reference (OptionsBag.php:76)."""
    if value is None or value is False:
        return ""
    if value is True:
        return "1"
    return str(value)


def strip_query(url: str) -> str:
    """Drop '?' and everything after (reference: OptionsBag.php:68
    ``preg_replace('/\\?.*/', '', $imageUrl)``)."""
    idx = url.find("?")
    return url if idx < 0 else url[:idx]


class OptionsBag:
    """Parsed per-request options.

    Mirrors the reference's dual view (src/Core/Entity/OptionsBag.php:12-18):
    ``parsed`` is consumed destructively by :meth:`extract_key` while
    ``collection`` stays stable for :meth:`get_option`.
    """

    def __init__(
        self,
        options_string: str,
        *,
        options_keys: Optional[Dict[str, str]] = None,
        default_options: Optional[Dict[str, Any]] = None,
        separator: str = ",",
    ) -> None:
        keys = options_keys if options_keys is not None else OPTIONS_KEYS
        defaults = default_options if default_options is not None else DEFAULT_OPTIONS
        parsed: Dict[str, Any] = dict(defaults)
        for piece in options_string.split(separator):
            fields = piece.split("_")
            short = fields[0]
            if short in keys and keys[short]:
                # PHP reads index [1] only; a piece with no '_' raised a
                # notice in PHP and yielded null — treat as empty string.
                parsed[keys[short]] = fields[1] if len(fields) > 1 else None
        self.parsed: Dict[str, Any] = parsed
        self.collection: Dict[str, Any] = dict(parsed)

    # --- reference OptionsBag API ------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self.parsed.get(key, default)

    def has(self, key: str) -> bool:
        return key in self.parsed

    def remove(self, key: str) -> None:
        self.parsed.pop(key, None)

    def extract_key(self, key: str) -> Any:
        """Destructive read from the parsed view (reference:
        src/Core/Entity/Image/InputImage.php:150-160)."""
        value = self.parsed.pop(key, "")
        return value

    def get_option(self, key: str) -> Any:
        """Stable read (reference: OptionsBag.php:144-147; missing -> '')."""
        return self.collection.get(key, "")

    def set_option(self, key: str, value: Any) -> "OptionsBag":
        self.collection[key] = value
        return self

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.parsed)

    # --- cache keys --------------------------------------------------------

    def hashed_options_as_string(self, image_url: str) -> str:
        """Content-addressed output name (reference: OptionsBag.php:65-77):
        md5 of '.'-joined option values (with refresh nulled) + url sans query.
        """
        url = strip_query(image_url)
        values = dict(self.parsed)
        refresh = values.get("refresh")
        if refresh and str(refresh) == "1":
            values["refresh"] = None
        joined = ".".join(_php_str(v) for v in values.values())
        return hashlib.md5((joined + url).encode("utf-8")).hexdigest()

    @staticmethod
    def hash_original_image_url(image_url: str) -> str:
        """Source-fetch cache basename (reference: OptionsBag.php:86-91);
        the caller prefixes the tmp directory."""
        url = strip_query(image_url)
        return "original-" + hashlib.md5(url.encode("utf-8")).hexdigest()

    # --- typed accessors (this framework's additions) ----------------------

    def int_option(self, key: str, default: Optional[int] = None) -> Optional[int]:
        value = self.get_option(key)
        if value in ("", None):
            return default
        try:
            return int(value)
        except (TypeError, ValueError):
            # IM parses geometry numbers with strtod: leading numeric prefix
            # (incl. exponents), trailing garbage ignored — 'w_200.5' resizes
            # to ~200, 'w_200px' to 200, 'w_2e3' to 2000. (Hex floats, which
            # strtod also accepts, are not supported.)
            match = re.match(r"\s*[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", str(value))
            if not match:
                return default
            try:
                return int(float(match.group(0)))
            except (TypeError, ValueError, OverflowError):
                return default

    def float_option(self, key: str, default: Optional[float] = None) -> Optional[float]:
        value = self.get_option(key)
        if value in ("", None):
            return default
        try:
            return float(value)
        except (TypeError, ValueError):
            return default

    def wants_refresh(self) -> bool:
        """The rf_1 debug-refresh predicate — ONE definition for all
        consumers (source-fetch bust, output-cache bust, identify_repr,
        debug headers); the reference checks ``$options['refresh'] ===
        true`` after its '1' cast (ImageHandler.php / Response.php)."""
        return str(self.get("refresh") or "") == "1"

    def truthy(self, key: str) -> bool:
        """PHP-style truthiness used all over the reference handler
        (e.g. ``if ($smartCrop && ...)``): '', '0', 0, None, False are falsy —
        and, faithfully to PHP, the STRING 'false' is truthy (so ``c_false``
        does enable cropping, exactly as in the reference)."""
        value = self.get_option(key)
        if value is None or value is False:
            return False
        return str(value) not in ("0", "")
