"""``st_0`` metadata in the PyTorch package (flyimg_tpu_torch/codecs/metadata.py
and the handler's encode step) against the JAX package's
(flyimg_tpu/codecs/metadata.py, flyimg_tpu/service/handler.py).

- ``collect`` on JPEG, PNG and WebP sources (EXIF with an orientation, ICC
  profiles of one and of several APP2 chunks, XMP) equals the JAX
  function's result, field by field;
- ``inject`` of each source's metadata into each output container equals
  the JAX function's bytes, including a JPEG without APP0 (nvJPEG writes
  none) and the port's own WebP files (VP8, VP8L, VP8X + ALPH);
- through the handlers: a ``st_0`` answer in each output format carries
  what ``collect`` reads from the JAX handler's answer to the same request,
  its chunks where the JAX answer has them, orientation 1; ``st_1`` (the
  default) carries none; under ``clsp_CMYK`` the ICC profile is dropped.
JPEG sources and answers go through the nvJPEG calls' Pillow stand-in
(tests/torch_jpeg_stand_in.py). Bound: exact.
"""

import io
import struct

import numpy as np
import pytest
import torch
import torch_jpeg_stand_in as stand_in
from PIL import Image, ImageCms

from flyimg_tpu.codecs import metadata as jmeta
from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import exif, metadata
from flyimg_tpu_torch.service.handler import ImageHandler, graft_metadata
from flyimg_tpu_torch.service.output_image import resolve_output
from flyimg_tpu_torch.spec.options import OptionsBag

torch.set_num_threads(1)

SRGB = ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()
XMP = b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF/></x:xmpmeta>'
MIMES = {"jpg": "image/jpeg", "png": "image/png", "webp": "image/webp"}
FORMATS = {"jpg": "JPEG", "png": "PNG", "webp": "WEBP"}


def _exif(orientation=6):
    e = Image.Exif()
    e[0x0112] = orientation
    e[0x010F] = "flyimg test camera"
    return e.tobytes()


def _pixels(h=30, w=40, seed=7):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _source(fmt: str, icc: bytes = SRGB, xmp: bool = True, orientation=6) -> bytes:
    buf = io.BytesIO()
    kw = {"exif": _exif(orientation), "icc_profile": icc}
    if xmp and fmt != "png":    # Pillow writes PNG XMP as iTXt, which no one reads
        kw["xmp"] = XMP
    if fmt == "webp":
        kw["lossless"] = True
    Image.fromarray(_pixels()).save(buf, FORMATS[fmt], **kw)
    return buf.getvalue()


def _same_meta(got, want):
    assert (got.exif_tiff, got.icc, got.xmp) == (want.exif_tiff, want.icc, want.xmp)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("icc_size", [0, 588, 150_000])
def test_collect_matches_jax(fmt, icc_size):
    """One, three APP2 ICC chunks (150,000 bytes) or none."""
    icc = SRGB if icc_size == 588 else bytes(np.random.default_rng(1).integers(
        0, 256, icc_size, dtype=np.uint8)) if icc_size else None
    data = _source(fmt, icc=icc)
    got, want = metadata.collect(data, MIMES[fmt]), jmeta.collect(data, MIMES[fmt])
    _same_meta(got, want)
    assert got.exif_tiff is not None and exif.tiff_orientation(got.exif_tiff) == 1
    assert (got.icc is not None) == bool(icc_size)


def _strip_app0(jpeg: bytes) -> bytes:
    """A JPEG with its JFIF APP0 taken out, as nvJPEG writes one."""
    assert jpeg[2:4] == b"\xff\xe0"
    (seglen,) = struct.unpack(">H", jpeg[4:6])
    return jpeg[:2] + jpeg[4 + seglen:]


def _outputs():
    """Encoded answers of each container, as the port and the JAX package
    write them."""
    px = _pixels(seed=3)
    alpha = np.random.default_rng(4).integers(0, 256, px.shape[:2], dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", quality=90)
    return {
        "jpg_app0": buf.getvalue(),
        "jpg_no_app0": _strip_app0(buf.getvalue()),
        "png": codecs.encode(px, "png"),
        "png_alpha": codecs.encode(px, "png", alpha),
        "webp_vp8": codecs.encode(px, "webp", quality=80),
        "webp_vp8l": codecs.encode(px, "webp", webp_lossless=True),
        "webp_vp8x_alph": codecs.encode(px, "webp", alpha, quality=80),
        "webp_vp8l_alpha": codecs.encode(px, "webp", alpha, webp_lossless=True),
    }


OUTPUTS = _outputs()


@pytest.mark.parametrize("src", sorted(FORMATS))
@pytest.mark.parametrize("out", sorted(OUTPUTS))
def test_inject_is_the_jax_bytes(src, out):
    data = _source(src, icc=bytes(range(256)) * 300)   # an ICC train of 2 chunks
    meta = metadata.collect(data, MIMES[src])
    ext = out.split("_")[0]
    got = metadata.inject(OUTPUTS[out], ext, meta)
    want = jmeta.inject(OUTPUTS[out], ext, jmeta.collect(data, MIMES[src]))
    assert got == want and got != OUTPUTS[out]
    back = metadata.collect(got, MIMES[ext])
    assert (back.exif_tiff, back.icc) == (meta.exif_tiff, meta.icc)
    assert back.xmp == (meta.xmp if ext != "png" else None)  # PNG carries no XMP
    decoded = codecs.decode(got) if ext != "jpg" else None
    if decoded is not None:     # the graft leaves the image as it was
        np.testing.assert_array_equal(decoded.rgb, codecs.decode(OUTPUTS[out]).rgb)


def test_inject_into_a_jpeg_without_app0_goes_after_soi():
    meta = metadata.collect(_source("jpg"), "image/jpeg")
    got = metadata.inject(OUTPUTS["jpg_no_app0"], "jpg", meta)
    assert got[:4] == b"\xff\xd8\xff\xe1" and got[6:12] == b"Exif\x00\x00"
    assert got.endswith(OUTPUTS["jpg_no_app0"][2:])


def _markers(jpeg: bytes):
    return [(m, jpeg[off:off + 12]) for m, off, _n in metadata._jpeg_segments(jpeg)]


def _layout(content: bytes, ext: str):
    """Where the metadata sits: the JPEG's segments before the first
    non-APP one, the PNG's chunk types, the WebP's fourccs."""
    if ext == "jpg":
        return [(m, head[:4]) for m, head in _markers(content) if 0xE0 <= m <= 0xEF]
    if ext == "png":
        return [t for t, _o, _n in metadata._png_chunks(content)]
    return [f for f, _o, _n in metadata._webp_chunks(content, limit=len(content))]


def _jax_handler(root):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    jparams = JAppParameters({"upload_dir": str(root / "ju"), "tmp_dir": str(root / "jt")})
    return JImageHandler(make_storage(jparams), jparams)


ANSWERS = ["o_png", "o_jpg", "o_webp", "o_webp,webpl_1"]


@pytest.mark.parametrize("src_fmt", sorted(FORMATS))
@pytest.mark.parametrize("answer", ANSWERS)
def test_st_0_answer_carries_the_jax_handler_s_metadata(src_fmt, answer, tmp_path,
                                                        monkeypatch):
    stand_in.install(monkeypatch)
    src = tmp_path / f"source.{src_fmt}"
    src.write_bytes(_source(src_fmt))
    port = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "u"),
                                       "tmp_dir": str(tmp_path / "t")}), device="cpu")
    jax = _jax_handler(tmp_path)
    opts = f"w_30,st_0,{answer}"
    got = port.process_image(opts, str(src))
    want = jax.process_image(opts, str(src))
    ext = got.spec.extension
    assert ext == want.spec.extension
    got_meta, want_meta = (metadata.collect(r.content, MIMES[ext]) for r in (got, want))
    _same_meta(got_meta, want_meta)
    assert got_meta.exif_tiff is not None and got_meta.icc == SRGB
    assert got_meta.xmp == (XMP if src_fmt != "png" and ext != "png" else None)
    assert _layout(got.content, ext) == _layout(want.content, ext)
    orientation = {"jpg": exif.jpeg_orientation, "png": metadata.png_orientation,
                   "webp": metadata.webp_orientation}[ext]
    assert orientation(got.content) == 1
    # st_1, the default: no metadata
    plain = port.process_image(f"w_30,{answer}", str(src)).content
    assert not metadata.collect(plain, MIMES[ext])


@pytest.mark.parametrize("opts,keeps_icc", [("w_30,st_0,o_jpg", True),
                                            ("w_30,st_0,o_jpg,clsp_CMYK", False)])
def test_icc_is_dropped_under_clsp_cmyk(opts, keeps_icc):
    """The encode step's graft, as the JAX handler's: an RGB profile must
    not describe CMYK samples; EXIF and XMP still carry."""
    data = _source("jpg")
    options = OptionsBag(opts)
    spec = resolve_output(options, "source.jpg", "image/jpeg")
    got = graft_metadata(OUTPUTS["jpg_app0"], data, "image/jpeg", spec, options)
    meta = metadata.collect(got, "image/jpeg")
    assert (meta.icc == SRGB) == keeps_icc and meta.exif_tiff and meta.xmp == XMP
    want = jmeta.collect(data, "image/jpeg")
    if not keeps_icc:
        want.icc = None
    assert got == jmeta.inject(OUTPUTS["jpg_app0"], "jpg", want)
