"""The port's PDF ingestion (``flyimg_tpu_torch/codecs/pdf.py``,
``pdf_mini.py``, ``service/input_source.py``) held against the JAX package's
on the CPU.

- Every test of ``tests/test_pdf_mini.py`` runs again with the JAX
  rasterizer's entry points swapped for ones that run both rasterizers on
  the same bytes (``MiniPdf`` and its ``rasterize``, ``decoded_stream``,
  ``_png_unfilter``, ``rasterize_page_mini``, ``pdf.rasterize_page``): each
  page is equal (max difference 0), each refusal the same class with the
  same message. Those documents cover FlateDecode with PNG predictors,
  ObjStm, ``/Decode``, SMask, ``/Rotate``, the q/Q/cm/Do interpreter, the
  resource ceilings and every refusal class.
- Documents with DCTDecode images (the port's JPEG decoder against the JAX
  package's native decode, built as ``tests/jax_fastcodec.py`` builds it),
  with SMasks and placements that resize (Pillow's BILINEAR over a box, an
  RGBA image premultiplied), at several densities.
- Ghostscript's command line, through a stub ``gs``.
- The handler: the JAX ``ImageHandler`` and the port's
  ``ImageHandler(device="cpu")`` answer the same requests the same way:
  the page the source cache holds (max difference 0), the answer's type
  and size and its pixels within PERF.md section 2's bound, every refusal
  the same exception class.

Documents are assembled byte by byte (no generator in the loop) or written
by Pillow; pixels come from numpy with fixed seeds.
"""

import functools
import inspect
import io
import os
import zlib

import numpy as np
import pytest
from PIL import Image

import jpeg_test_files as jt
import test_pdf_mini as tpm
from jax_fastcodec import fastcodec, use_in_jax  # noqa: F401 (fixture)
from flyimg_tpu.codecs import pdf as jax_pdf
from flyimg_tpu.codecs import pdf_mini as jax_mini
from flyimg_tpu_torch.codecs import pdf as port_pdf
from flyimg_tpu_torch.codecs import pdf_mini as port_mini
from flyimg_tpu_torch.codecs import png

# ---------------------------------------------------------------- both ways


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs), None
    except Exception as exc:  # noqa: BLE001 - compared below
        return None, exc


def _same_failure(want, got):
    """The same refusal: class name (the two packages' classes differ) and
    message."""
    assert (want is None) == (got is None), (want, got)
    if want is not None:
        assert type(got).__name__ == type(want).__name__, (want, got)
        assert str(got) == str(want)


def _port_ref(ref):
    return port_mini._Ref(ref.num) if isinstance(ref, jax_mini._Ref) else ref


class _Both:
    """A MiniPdf that is the JAX package's and the port's at once: each
    call runs on both and must give the same answer."""

    def __init__(self, data, *args, **kwargs):
        self.jax, want = _outcome(jax_mini.MiniPdf, data, *args, **kwargs)
        self.port, got = _outcome(port_mini.MiniPdf, data, *args, device="cpu", **kwargs)
        _same_failure(want, got)
        if want is not None:
            raise want
        assert len(self.port.pages) == len(self.jax.pages)

    def rasterize(self, page, dpi):
        want, jerr = _outcome(self.jax.rasterize, page, dpi)
        got, perr = _outcome(self.port.rasterize, page, dpi)
        _same_failure(jerr, perr)
        if jerr is not None:
            raise jerr
        np.testing.assert_array_equal(got, want)
        return want

    def decoded_stream(self, ref):
        want, jerr = _outcome(self.jax.decoded_stream, ref)
        got, perr = _outcome(self.port.decoded_stream, _port_ref(ref))
        _same_failure(jerr, perr)
        if jerr is not None:
            raise jerr
        assert got == want
        return want

    def __getattr__(self, name):
        # the packages' _Ref classes differ: compare their reprs
        assert repr(getattr(self.port, name)) == repr(getattr(self.jax, name)), name
        return getattr(self.jax, name)


def _both_unfilter(*args, **kwargs):
    """``_png_unfilter`` both ways. A document's own budget callback is
    debited by the JAX call alone (the port's document keeps its own, held
    equal through ``_scalar_budget_left``)."""
    want, jerr = _outcome(_JAX_UNFILTER, *args, **kwargs)
    if jerr is not None and kwargs.get("consume_scalar") is not None:
        raise jerr
    if kwargs.get("consume_scalar") is not None:
        kwargs = dict(kwargs, consume_scalar=lambda n: None)
    got, perr = _outcome(port_mini._png_unfilter, *args, **kwargs)
    _same_failure(jerr, perr)
    if jerr is not None:
        raise jerr
    assert got == want
    return want


_JAX_UNFILTER = jax_mini._png_unfilter


def _both_pages(jax_fn, port_fn):
    """A rasterize-to-PNG function run both ways into two files: the PNGs
    hold the same pixels."""

    @functools.wraps(jax_fn)
    def run(pdf_path, out_path, *args, **kwargs):
        port_out = out_path + ".port.png"
        want, jerr = _outcome(jax_fn, pdf_path, out_path, *args, **kwargs)
        got, perr = _outcome(port_fn, pdf_path, port_out, *args, device="cpu", **kwargs)
        _same_failure(jerr, perr)
        if jerr is not None:
            raise jerr
        with open(port_out, "rb") as fh:
            rgb, alpha = png.decode(fh.read())
        assert alpha is None
        np.testing.assert_array_equal(rgb, np.asarray(Image.open(out_path).convert("RGB")))
        return want
    return run


def _mini_cases():
    """(test name, its parameters) for every test of tests/test_pdf_mini.py,
    one case a parameter set."""
    cases = []
    for name, fn in sorted(inspect.getmembers(tpm, inspect.isfunction)):
        if not name.startswith("test_"):
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            cases.append((name, {}))
            continue
        (argname, values), = [m.args for m in marks]
        cases += [(name, {argname: v}) for v in values]
    return cases


@pytest.mark.parametrize("name,params", _mini_cases(),
                         ids=[f"{n}-{'-'.join(map(str, p.values()))}".rstrip("-")
                              for n, p in _mini_cases()])
def test_mini_rasterizer_documents_equal_the_jax_package(name, params, monkeypatch, tmp_path,
                                                          fastcodec):  # noqa: F811
    """One test of tests/test_pdf_mini.py, every rasterizer call in it made
    by both packages on the same bytes and held equal."""
    use_in_jax(monkeypatch, fastcodec)
    monkeypatch.setattr(tpm, "MiniPdf", _Both)
    monkeypatch.setattr(jax_mini, "_png_unfilter", _both_unfilter)
    monkeypatch.setattr(jax_mini, "rasterize_page_mini",
                        _both_pages(jax_mini.rasterize_page_mini, port_mini.rasterize_page_mini))
    monkeypatch.setattr(jax_pdf, "GHOSTSCRIPT", None)
    monkeypatch.setattr(port_pdf, "GHOSTSCRIPT", None)
    monkeypatch.setattr(jax_pdf, "rasterize_page",
                        _both_pages(jax_pdf.rasterize_page, port_pdf.rasterize_page))
    fn = getattr(tpm, name)
    kwargs = dict(params)
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs["tmp_path"] = tmp_path
    fn(**kwargs)


# ---------------------------------------------------------------- DCT images


def _dct_image(jpeg: bytes, w: int, h: int, extra: bytes = b"",
               colorspace: bytes = b"/DeviceRGB") -> bytes:
    head = (b"/Type /XObject /Subtype /Image /Width %d /Height %d /Filter /DCTDecode "
            b"/BitsPerComponent 8 /ColorSpace %s %s" % (w, h, colorspace, extra))
    return tpm._stream(jpeg, head)


@pytest.fixture(scope="module")
def enc(tmp_path_factory):
    from jax_fastcodec import tool

    reason = tool.missing()
    if reason:
        pytest.skip(reason)
    return jt.encoder(str(tmp_path_factory.mktemp("pdf_jpeg_encoder")))


def _scan_pdf(enc, w, h, sampling=(2, 2), smask=True, content=None, media=None,
              pages=1, seed=31):
    """Pages of a scan: a DCTDecode image (``sampling``) with an 8-bit
    FlateDecode SMask, placed over the MediaBox (``content``: the page's
    operators; ``media``: its box, Letter by default)."""
    objs = {1: b"<< /Type /Catalog /Pages 2 0 R >>"}
    kids = []
    for p in range(pages):
        base = 10 + 10 * p
        rgb = jt.photo(w, h, seed + p)
        img_extra = b"/SMask %d 0 R " % (base + 2) if smask else b""
        objs[base + 1] = _dct_image(enc(rgb, 88, sampling), w, h, img_extra)
        if smask:
            yy, xx = np.mgrid[0:h, 0:w]
            alpha = ((xx * 255 // max(w - 1, 1)) ^ (yy * 7 % 256)).astype(np.uint8)
            objs[base + 2] = tpm._flate_image(alpha[..., None], b"/DeviceGray")
        objs[base + 3] = tpm._stream(content or b"q 612 0 0 792 0 0 cm /im Do Q")
        objs[base] = (b"<< /Type /Page /Parent 2 0 R /MediaBox " + (media or b"[0 0 612 792]")
                      + b" /Resources << /XObject << /im %d 0 R >> >> /Contents %d 0 R >>"
                      % (base + 1, base + 3))
        kids.append(b"%d 0 R" % base)
    objs[2] = b"<< /Type /Pages /Count %d /Kids [%s] >>" % (pages, b" ".join(kids))
    return tpm._pdf(objs)


@pytest.mark.parametrize("dpi", [24, 72, 96, 150])
@pytest.mark.parametrize("layout", ["smask_420", "no_mask_444", "smask_422_inset",
                                    "gray_mirrored", "cropped_by_page"])
def test_dct_pages_equal_the_jax_rasterizer(enc, monkeypatch, fastcodec,  # noqa: F811
                                            layout, dpi):
    """Scans as DCTDecode images, alone or over an SMask (resized
    premultiplied), placed over the whole page, inset (a scaled blit), a
    gray image mirrored, and one placed past the page's edges (a box
    resize of the part on the canvas): the port's page equals
    ``MiniPdf.rasterize``'s."""
    use_in_jax(monkeypatch, fastcodec)
    w, h = 203, 157
    content, sampling, smask, colorspace = None, (2, 2), True, None
    if layout == "no_mask_444":
        sampling, smask = (1, 1), False
    elif layout == "smask_422_inset":
        sampling, content = (2, 1), b"q 300 0 0 200 100 300 cm /im Do Q"
    elif layout == "gray_mirrored":
        content = b"q -400 0 0 300 500 100 cm /im Do Q"
    elif layout == "cropped_by_page":
        content = b"q 900 0 0 700 -150 200 cm /im Do Q"
    data = _scan_pdf(enc, w, h, sampling, smask, content)
    if layout == "gray_mirrored":
        gray = enc(jt.photo(w, h, 5)[..., 0], 90, (1, 1))
        data = data.replace(b"/ColorSpace /DeviceRGB /SMask", b"/ColorSpace /DeviceGray /SMask")
        start = data.index(b"11 0 obj")
        end = data.index(b"endobj", start)
        data = data[:start] + b"11 0 obj" + _dct_image(
            gray, w, h, b"/SMask 12 0 R ", b"/DeviceGray") + data[end:]
    want = jax_mini.MiniPdf(data).rasterize(1, dpi)
    got = port_mini.MiniPdf(data, device="cpu").rasterize(1, dpi)
    assert got.shape == want.shape == (round(792 * dpi / 72), round(612 * dpi / 72), 3)
    np.testing.assert_array_equal(got, want)


def test_dct_image_of_another_size_than_declared_is_refused(enc):
    data = _scan_pdf(enc, 40, 30, smask=False).replace(b"/Width 40 /Height 30",
                                                         b"/Width 41 /Height 30")
    for mini in (jax_mini, port_mini):
        with pytest.raises(Exception, match="DCT stream is 40x30"):
            mini.MiniPdf(data).rasterize(1, 72)


def test_letter_scan_pages_equal_their_references():
    """chip_smoke.py phase 16's PDF: the port's own encode of the 2550x3300
    scan is the JPEG whose SHA-256 reference.json holds, and the port's
    rasterizer gives page 1 at 96 dpi and page 2 (rotated, an inset box
    resize) at 150 dpi as the JAX package's ``MiniPdf.rasterize`` did
    (tools/make_ingest_fixtures.py)."""
    import hashlib
    import json

    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.testing import ingest

    with open(os.path.join(os.path.dirname(__file__), "data", "ingest",
                           "reference.json")) as fh:
        want = json.load(fh)["letter_scan.pdf"]
    jpeg = codecs.encode(ingest.scan_rgb(), "jpg", quality=85, mozjpeg=False,
                         sampling_factor="2x2", device="cpu")
    assert hashlib.sha256(jpeg).hexdigest() == want["jpeg_sha256"]
    pdf = ingest.letter_pdf(jpeg, ingest.SCAN_W, ingest.SCAN_H, ingest.scan_alpha())
    assert hashlib.sha256(pdf).hexdigest() == want["pdf_sha256"]
    doc = port_mini.MiniPdf(pdf, device="cpu")
    for key, ref in want["pages"].items():
        page, dpi = (int(v[1:]) for v in key.split("-"))
        got = doc.rasterize(page, dpi)
        assert list(got.shape) == ref["shape"], key
        assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() == ref["sha256"]


# ---------------------------------------------------------------- dispatch


def test_ghostscript_command_line_is_the_jax_package_s(tmp_path, monkeypatch):
    """Where ``gs`` exists both packages run it with the same arguments
    (``-r`` the density, the one page), and a failing ``gs`` raises the same
    class."""
    log = tmp_path / "gs.log"
    page = tmp_path / "page.png"
    page.write_bytes(png.encode(np.full((4, 5, 3), 90, np.uint8)))
    stub = tmp_path / "gs"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'for a in "$@"; do case "$a" in -sOutputFile=*) '
        f'cp "{page}" "${{a#-sOutputFile=}}";; esac; done\n'
        'case "$*" in *fail.pdf*) exit 3;; esac\n')
    stub.chmod(0o755)
    monkeypatch.setattr(jax_pdf, "GHOSTSCRIPT", str(stub))
    monkeypatch.setattr(port_pdf, "GHOSTSCRIPT", str(stub))
    src = tmp_path / "doc.pdf"
    src.write_bytes(b"%PDF-1.4 not parsed by the stub")
    for density in (None, 150):
        jax_pdf.rasterize_page(str(src), str(tmp_path / "j.png"), 3, density)
        port_pdf.rasterize_page(str(src), str(tmp_path / "j.png"), 3, density)
    lines = log.read_text().splitlines()
    assert len(lines) == 4 and lines[0] == lines[1] and lines[2] == lines[3]
    assert "-r96 -dFirstPage=3 -dLastPage=3" in lines[0] and "-r150" in lines[2]
    bad = tmp_path / "fail.pdf"
    bad.write_bytes(b"%PDF-1.4")
    errors = []
    for mod in (jax_pdf, port_pdf):
        with pytest.raises(Exception) as info:
            mod.rasterize_page(str(bad), str(tmp_path / "f.png"), 1, None)
        errors.append(info.value)
    assert type(errors[1]).__name__ == type(errors[0]).__name__ == "ExecFailedException"


@pytest.mark.parametrize("density", [0, -96, 9601])
def test_density_is_checked_before_either_backend(tmp_path, density):
    src = tmp_path / "doc.pdf"
    src.write_bytes(tpm._pdf(tpm._page_objs(b"")))
    outcomes = []
    for mod in (jax_pdf, port_pdf):
        outcomes.append(_outcome(mod.rasterize_page, str(src), str(tmp_path / "o.png"),
                                 1, density))
    _same_failure(outcomes[0][1], outcomes[1][1])


# ---------------------------------------------------------------- handler


def _handlers(tmp_path):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.service.handler import ImageHandler

    params = AppParameters({"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t")})
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"),
                              "tmp_dir": str(tmp_path / "jt")})
    return ImageHandler(params, device="cpu"), JImageHandler(make_storage(jparams), jparams)


def _pixels(content: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB")).astype(np.int64)


def _assert_close(got: np.ndarray, want: np.ndarray):
    """PERF.md section 2's pixel bound: 1 level on at most 1e-4 of values."""
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (diff.max(), (diff > 0).mean())


@pytest.fixture(scope="module")
def scan_doc(enc, tmp_path_factory):
    path = tmp_path_factory.mktemp("pdf_sources") / "scan.pdf"
    path.write_bytes(_scan_pdf(enc, 320, 410, pages=2))
    return str(path)


HANDLER_CASES = ["w_300,h_250,c_1", "w_300,h_250,c_1,o_png", "w_300,h_250,c_1,pg_2,dnst_150",
                 "w_300,h_250,c_1,pg_2,dnst_150,o_png", "o_png", "dnst_0,o_png",
                 "pg_9,o_png", "dnst_-5,o_png", "dnst_9601,w_100"]


@pytest.mark.parametrize("opts", HANDLER_CASES)
def test_handler_pdf_answers_match_the_jax_handler(scan_doc, tmp_path, monkeypatch,
                                                   fastcodec, opts):  # noqa: F811
    """``/upload/{opts}/{pdf}``: the same type and size, pixels within the
    bound (the JPEG answers compared through o_png's), the page each caches
    under ``-p{page}-d{density}.png`` equal to the JAX package's (max
    difference 0), and a page past the end or a density out of range the
    same exception class."""
    use_in_jax(monkeypatch, fastcodec)
    monkeypatch.setattr(jax_pdf, "GHOSTSCRIPT", None)
    monkeypatch.setattr(port_pdf, "GHOSTSCRIPT", None)
    handler, jhandler = _handlers(tmp_path)
    want, jerr = _outcome(jhandler.process_image, opts, scan_doc)
    got, perr = _outcome(handler.process_image, opts, scan_doc)
    if jerr is not None:
        assert perr is not None and type(perr).__name__ == type(jerr).__name__, (jerr, perr)
        return
    assert perr is None, perr
    assert Image.open(io.BytesIO(got.content)).format == \
        Image.open(io.BytesIO(want.content)).format
    if "o_png" in opts:
        _assert_close(_pixels(got.content), _pixels(want.content))
    else:
        assert _pixels(got.content).shape == _pixels(want.content).shape
    pages = sorted(f for f in os.listdir(tmp_path / "t") if "-p" in f)
    jpages = sorted(f for f in os.listdir(tmp_path / "jt") if "-p" in f)
    assert pages == jpages and len(pages) == 1
    with open(tmp_path / "t" / pages[0], "rb") as fh:
        page, _ = png.decode(fh.read())
    np.testing.assert_array_equal(page, _pixels((tmp_path / "jt" / jpages[0]).read_bytes()))


@pytest.mark.parametrize("doc", ["text", "vector_path", "clipped", "not_a_pdf"])
def test_handler_refusals_answer_the_same_class(tmp_path, monkeypatch, doc):
    """Documents outside the image-only subset answer the JAX handler's
    refusal (PdfRefusal, an UnsupportedMediaException: 415) with the same
    message, ghostscript absent."""
    monkeypatch.setattr(jax_pdf, "GHOSTSCRIPT", None)
    monkeypatch.setattr(port_pdf, "GHOSTSCRIPT", None)
    objs = tpm._page_objs(b"q 20 0 0 10 0 0 cm /im Do Q")
    objs[4] = tpm._flate_image(tpm._solid(2, 2, (1, 2, 3)))
    data = {
        "text": None,
        "vector_path": tpm._pdf({**objs, 5: tpm._stream(b"0 0 m 10 10 l S")}),
        "clipped": tpm._pdf({**objs, 5: tpm._stream(b"0 0 5 5 re W n /im Do")}),
        "not_a_pdf": b"%PDF-1.4\n" + zlib.compress(b"garbage" * 10),
    }[doc]
    if data is None:
        import test_pdf as tp

        data = tp.TEXT_PDF
    src = tmp_path / f"{doc}.pdf"
    src.write_bytes(data)
    handler, jhandler = _handlers(tmp_path)
    _, jerr = _outcome(jhandler.process_image, "o_png", str(src))
    _, perr = _outcome(handler.process_image, "o_png", str(src))
    from flyimg_tpu_torch.exceptions import UnsupportedMediaException

    assert jerr is not None and isinstance(perr, UnsupportedMediaException)
    assert type(perr).__name__ == type(jerr).__name__ == "PdfRefusal"
    assert str(perr) == str(jerr)
