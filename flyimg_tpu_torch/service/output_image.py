"""Output naming + content negotiation.

Port of the reference's OutputImage entity (src/Core/Entity/Image/
OutputImage.php): the content-addressed output name (options-hash +
page/time suffixes + extension) and the o_auto/o_input negotiation rules.
"""

from __future__ import annotations

from dataclasses import dataclass

from flyimg_tpu_torch.codecs.sniff import (
    GIF_MIME,
    JPEG_MIME,
    PDF_MIME,
    PNG_MIME,
    WEBP_MIME,
)
from flyimg_tpu_torch.exceptions import InvalidArgumentException
from flyimg_tpu_torch.spec.options import OptionsBag

EXT_PNG, EXT_JPG, EXT_GIF, EXT_WEBP = "png", "jpg", "gif", "webp"
ALLOWED_OUT_EXTENSIONS = (EXT_PNG, EXT_JPG, EXT_GIF, EXT_WEBP)

_MIME_TO_EXT = {
    PNG_MIME: EXT_PNG,
    WEBP_MIME: EXT_WEBP,
    JPEG_MIME: EXT_JPG,
    GIF_MIME: EXT_GIF,
    PDF_MIME: EXT_JPG,
}

EXT_TO_MIME = {
    EXT_PNG: PNG_MIME,
    EXT_WEBP: WEBP_MIME,
    EXT_GIF: GIF_MIME,
    EXT_JPG: JPEG_MIME,
}


def negotiate_extension(
    requested: str, source_mime: str, accepts_webp: bool
) -> str:
    """reference OutputImage.php:183-220:
    - 'auto' + browser webp support -> webp
    - 'auto'/'input' -> by source MIME (pdf -> jpg; unknown -> jpg)
    - else must be one of {png,jpg,gif,webp} or InvalidArgumentException
      (note: 'jpeg' is NOT accepted, faithfully to the reference)."""
    if requested == "auto" and accepts_webp:
        return EXT_WEBP
    if requested in ("auto", "input"):
        return _MIME_TO_EXT.get(source_mime, EXT_JPG)
    if requested not in ALLOWED_OUT_EXTENSIONS:
        raise InvalidArgumentException(
            f"Invalid file output requested : {requested}"
        )
    return requested


@dataclass
class OutputSpec:
    """Resolved output identity for one request."""

    name: str                       # storage key (hash[-page|-time].ext)
    extension: str
    mime: str
    command_repr: str = ""          # rf_1 debug header (plan repr here)
    identify_repr: str = ""
    # o_auto: the body depends on the request's Accept header (webp
    # negotiation), so responses must carry `Vary: Accept` or a shared
    # cache would serve one client's variant to every client
    negotiated: bool = False

    @property
    def is_gif(self) -> bool:
        return self.extension == EXT_GIF


def resolve_output(
    options: OptionsBag,
    image_url: str,
    source_mime: str,
    *,
    accepts_webp: bool = False,
) -> OutputSpec:
    """Build the output spec; name layout matches OutputImage.php:50-66
    (options-hash, then '-{page}' for PDFs, '-{time-sans-punct}' for video,
    then '.{ext}')."""
    requested = str(options.extract_key("output") or "auto")
    extension = negotiate_extension(requested, source_mime, accepts_webp)
    name = options.hashed_options_as_string(image_url)
    if source_mime == PDF_MIME:
        name += f"-{options.get('page_number', 1)}"
    if source_mime.startswith("video/"):
        time_spec = str(options.get("time") or "00:00:01")
        name += "-" + time_spec.replace(".", "").replace(":", "")
    name += f".{extension}"
    return OutputSpec(
        name=name, extension=extension, mime=EXT_TO_MIME[extension],
        negotiated=requested == "auto",
    )
