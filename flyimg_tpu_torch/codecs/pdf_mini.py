"""Minimal from-scratch rasterizer for image-only PDFs.

The port of the JAX package's ``codecs/pdf_mini.py``: the reference
rasterizes PDFs through ImageMagick's ghostscript delegate (reference
src/Core/Processor/ImageProcessor.php:70-84), and where ghostscript is not
installed this module rasterizes the image-only subset. Every step is the
JAX module's, on the same numbers, so a page equals its raster; two helpers
that lean on Pillow there are the port's own here (the card machine has no
Pillow): a DCTDecode image decodes with the port's JPEG decoder (kernels
K18 and K19 on ``device``), and a placed image resizes with
``models/thumbnail.py``'s copy of Pillow's BILINEAR over a box (an SMask
image premultiplied, as ``Image.resize`` does an RGBA image).

This module covers the *image-centric* subset of PDF: pages
whose content streams only position and draw image XObjects (scanned
documents, PIL/img2pdf output, camera-roll exports). That subset needs no
font engine and no path rasterizer, just:

  - the COS object layer (dictionaries, arrays, streams, references),
  - FlateDecode + DCTDecode stream filters (zlib / the port's JPEG decoder),
  - the page tree with attribute inheritance (MediaBox, Resources),
  - a four-op content interpreter: q / Q / cm / Do (+ no-paint state ops).

Anything it cannot honor exactly — text showing, path painting, shading,
rotated CTMs, exotic color spaces — is REFUSED with a clear error rather
than rendered approximately: a blank page where a paragraph should be is
a wrong output. Ghostscript, when installed, remains the preferred backend
for full PDF (codecs/pdf.py dispatches).

Object discovery scans the raw bytes for ``N G obj … endobj`` spans
instead of trusting the xref table — tolerant of the mildly broken xrefs
real generators emit. PDF 1.5 compressed object streams (/Type /ObjStm,
what post-2005 generators emit alongside cross-reference streams) are
covered by the same principle: the *containers* are ordinary raw objects
the scan finds, so their packed objects are unpacked directly — the xref
stream itself never needs to be trusted (or even parsed; its /Root key is
found in the raw trailer bytes like any other). FlateDecode PNG
predictors (/Predictor >= 10), which xref/object streams almost always
use, are implemented in _png_unfilter.
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass

import numpy as np

from flyimg_tpu_torch.exceptions import ExecFailedException, UnsupportedMediaException


class PdfRefusal(UnsupportedMediaException):
    """Document uses PDF features outside the image-only subset."""


# Resource ceilings: rasterization runs IN-PROCESS (ghostscript ran in a
# subprocess where -dSAFER + the OOM killer bounded the blast radius), so
# hostile dimensions/zip-bombs must be refused before allocation.
MAX_RASTER_PIXELS = 100_000_000     # ~100 MP canvas (IM-style limit)
MAX_RASTER_SIDE = 32_768
MAX_STREAM_BYTES = 256 * 1024 * 1024  # decompressed stream ceiling


def _bounded_inflate(data: bytes, cap: int = MAX_STREAM_BYTES) -> bytes:
    d = zlib.decompressobj()
    out = d.decompress(data, cap)
    if d.unconsumed_tail:
        raise PdfRefusal("compressed stream expands past the size ceiling")
    return out


# Predictor-filtered streams decode through a per-row pass with a scalar
# fallback for average/Paeth rows — unlike plain Flate images (a single
# frombuffer), the work is CPU-bound Python. Bound it the same way the
# raster ceilings bound allocation: enough for A4-at-600dpi gray or
# A4-at-300dpi RGB scans, refusal beyond (ghostscript covers the rest).
MAX_PREDICTOR_BYTES = 48 * 1024 * 1024
# The none/up/sub filters are vectorized (numpy row ops); average/Paeth
# run the bytearray scalar loop at ~0.4 s/MB. A hostile all-Paeth stream
# at the 48 MB cap would still burn ~18 s of CPU per request, so SCALAR
# rows get their own much tighter cumulative ceiling (~5 s worst case;
# covers an A4 300-dpi gray scan even if its encoder chose Paeth for
# every row — bigger all-Paeth documents go to ghostscript). The budget
# is DOCUMENT-wide when decoding through a MiniPdf (one shared counter
# across every stream), not per-stream: N hostile streams in one
# document must not multiply the ceiling by N. Legitimate multi-page
# scans get one extra base budget per page up to a small cap — total
# CPU stays bounded (~cap x 5 s) whatever the document declares, while
# a benign 2-3 page all-Paeth scan still decodes.
MAX_PREDICTOR_SCALAR_BYTES = 12 * 1024 * 1024
MAX_SCALAR_BUDGET_PAGES = 3


def _png_unfilter(data: bytes, columns: int, colors: int,
                  consume_scalar=None) -> bytes:
    """Reverse PNG row filters (predictors 10-15: each row is one filter
    byte + filtered samples). 8-bit samples only — that covers xref/object
    streams (W-width integer columns) and the 8bpc images this subset
    admits. 'none'/'up'/'sub' rows are vectorized; 'average'/'paeth' run a
    bytearray scalar loop (C-speed indexing), with total input bounded by
    MAX_PREDICTOR_BYTES and scalar rows debited from ``consume_scalar``
    (MiniPdf passes its DOCUMENT-wide counter; standalone callers get a
    fresh per-call budget) so hostile all-Paeth streams cost bounded CPU
    however many of them a document carries."""
    if columns <= 0 or colors <= 0:
        raise PdfRefusal("bad predictor geometry")
    if len(data) > MAX_PREDICTOR_BYTES:
        raise PdfRefusal("predictor stream exceeds the size ceiling")
    if consume_scalar is None:
        local = [MAX_PREDICTOR_SCALAR_BYTES]

        def consume_scalar(n: int, _left=local) -> None:
            _left[0] -= n
            if _left[0] < 0:
                raise PdfRefusal(
                    "predictor stream exceeds the average/Paeth CPU ceiling"
                )

    rowlen = columns * colors
    stride = rowlen + 1
    nrows, rem = divmod(len(data), stride)
    if nrows == 0 or rem:
        raise PdfRefusal("predictor data is not a whole number of rows")
    bpp = colors
    out = bytearray(nrows * rowlen)
    prev = bytes(rowlen)
    mv = memoryview(data)
    for r in range(nrows):
        ft = data[r * stride]
        row = mv[r * stride + 1 : (r + 1) * stride]
        if ft == 0:
            cur = bytes(row)
        elif ft == 2:  # up
            cur = (
                (np.frombuffer(row, np.uint8).astype(np.int16)
                 + np.frombuffer(prev, np.uint8)) & 255
            ).astype(np.uint8).tobytes()
        elif ft == 1:  # sub: running sum per byte lane, mod 256
            arr = np.frombuffer(row, np.uint8).reshape(columns, bpp)
            cur = (np.cumsum(arr.astype(np.int64), axis=0) & 255).astype(
                np.uint8
            ).tobytes()
        elif ft in (3, 4):
            consume_scalar(rowlen)
            rb = bytes(row)
            buf = bytearray(rowlen)
            for i in range(rowlen):
                left = buf[i - bpp] if i >= bpp else 0
                up = prev[i]
                if ft == 3:
                    p = (left + up) >> 1
                else:
                    ul = prev[i - bpp] if i >= bpp else 0
                    pa = up - ul
                    if pa < 0:
                        pa = -pa
                    pb = left - ul
                    if pb < 0:
                        pb = -pb
                    pc = left + up - 2 * ul
                    if pc < 0:
                        pc = -pc
                    if pa <= pb and pa <= pc:
                        p = left
                    elif pb <= pc:
                        p = up
                    else:
                        p = ul
                buf[i] = (rb[i] + p) & 255
            cur = bytes(buf)
        else:
            raise PdfRefusal(f"unknown PNG row filter {int(ft)}")
        out[r * rowlen : (r + 1) * rowlen] = cur
        prev = cur
    return bytes(out)


def _apply_decode_parms(data: bytes, parms, ncomp_default: int = 1,
                        consume_scalar=None) -> bytes:
    """Apply a fully-RESOLVED FlateDecode /DecodeParms dict to inflated
    bytes (callers resolve indirect refs/arrays via MiniPdf._parms_for).
    ``consume_scalar`` threads the document-wide scalar-predictor budget
    through to ``_png_unfilter``."""
    if parms is None:
        return data
    if not isinstance(parms, dict):
        raise PdfRefusal(f"unsupported /DecodeParms {parms!r}")
    pred = int(parms.get("Predictor", 1) or 1)
    if pred == 1:
        return data
    if pred == 2:
        raise PdfRefusal("TIFF predictor 2 unsupported")
    if int(parms.get("BitsPerComponent", 8) or 8) != 8:
        raise PdfRefusal("predictor BitsPerComponent != 8 unsupported")
    columns = int(parms.get("Columns", 1) or 1)
    colors = int(parms.get("Colors", ncomp_default) or ncomp_default)
    return _png_unfilter(data, columns, colors, consume_scalar=consume_scalar)


# ---------------------------------------------------------------- tokenizer

_WHITESPACE = b"\x00\t\n\x0c\r "
_DELIMS = b"()<>[]{}/%"


class _Lexer:
    """Tokenizer over a COS object body (NOT over stream data)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _skip_ws(self) -> None:
        d, n = self.data, len(self.data)
        while self.pos < n:
            c = self.data[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # '%' comment runs to EOL
                while self.pos < n and d[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                return

    def peek_bytes(self, k: int) -> bytes:
        self._skip_ws()
        return self.data[self.pos : self.pos + k]

    def read_object(self):
        """Parse one object: dict/array/name/number/string/bool/null/ref."""
        self._skip_ws()
        d = self.data
        if self.pos >= len(d):
            raise PdfRefusal("unexpected end of PDF object data")
        c = d[self.pos]
        if d.startswith(b"<<", self.pos):
            return self._read_dict()
        if c == 0x5B:  # '['
            self.pos += 1
            out = []
            while True:
                self._skip_ws()
                if self.pos < len(d) and d[self.pos] == 0x5D:  # ']'
                    self.pos += 1
                    return out
                out.append(self.read_object())
        if c == 0x2F:  # '/'
            return self._read_name()
        if c == 0x28:  # '(' literal string
            return self._read_literal_string()
        if d.startswith(b"<", self.pos):  # hex string (not '<<')
            return self._read_hex_string()
        m = re.compile(rb"(\d+)\s+(\d+)\s+R\b").match(d, self.pos)
        if m:
            self.pos = m.end()
            return _Ref(int(m.group(1)))
        m = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)").match(d, self.pos)
        if m:
            self.pos = m.end()
            tok = m.group(0)
            return float(tok) if b"." in tok else int(tok)
        for lit, val in ((b"true", True), (b"false", False), (b"null", None)):
            if d.startswith(lit, self.pos):
                self.pos += len(lit)
                return val
        raise PdfRefusal(f"unparseable PDF token at byte {self.pos}")

    def _read_name(self) -> str:
        d = self.data
        self.pos += 1  # '/'
        start = self.pos
        while self.pos < len(d) and d[self.pos] not in _WHITESPACE + _DELIMS:
            self.pos += 1
        raw = d[start : self.pos]
        # #xx escapes in names
        return re.sub(
            rb"#([0-9a-fA-F]{2})", lambda m: bytes([int(m.group(1), 16)]), raw
        ).decode("latin1")

    def _read_dict(self) -> dict:
        self.pos += 2  # '<<'
        out = {}
        while True:
            self._skip_ws()
            if self.data.startswith(b">>", self.pos):
                self.pos += 2
                return out
            key = self.read_object()
            if not isinstance(key, str):
                raise PdfRefusal("non-name dictionary key")
            out[key] = self.read_object()

    def _read_literal_string(self) -> bytes:
        d = self.data
        self.pos += 1
        depth, out = 1, bytearray()
        while self.pos < len(d):
            c = d[self.pos]
            self.pos += 1
            if c == 0x5C and self.pos < len(d):  # backslash escape
                out.append(d[self.pos])
                self.pos += 1
            elif c == 0x28:
                depth += 1
                out.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    return bytes(out)
                out.append(c)
            else:
                out.append(c)
        raise PdfRefusal("unterminated PDF string")

    def _read_hex_string(self) -> bytes:
        d = self.data
        self.pos += 1
        end = d.index(b">", self.pos)
        hexpart = re.sub(rb"\s", b"", d[self.pos : end])
        self.pos = end + 1
        if len(hexpart) % 2:
            hexpart += b"0"
        return bytes.fromhex(hexpart.decode("latin1"))


@dataclass(frozen=True)
class _Ref:
    num: int


# ---------------------------------------------------------------- document

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class MiniPdf:
    """Image-only PDF document: object map + page list + rasterize()."""

    def __init__(self, data: bytes,
                 scalar_predictor_budget: int = MAX_PREDICTOR_SCALAR_BYTES,
                 device="cuda"):
        if not data.lstrip()[:5] == b"%PDF-":
            raise PdfRefusal("not a PDF (missing %PDF- header)")
        self.data = data
        # where a DCTDecode image's kernels run
        self.device = device
        # DOCUMENT-wide average/Paeth predictor CPU budget: every stream
        # this document decodes debits one shared counter, so N hostile
        # streams cannot multiply the per-stream ceiling N-fold
        # (injectable for fast tests)
        self._scalar_budget_left = int(scalar_predictor_budget)
        self.objects: dict[int, tuple[object, bytes | None]] = {}
        # byte offset each object number was defined at (ObjStm-packed
        # objects inherit their container's offset) — incremental-update
        # precedence is "largest offset wins" across both layers
        self._origin: dict[int, int] = {}
        self._scan_objects()
        self._unpack_objstms()
        self.pages = self._collect_pages()
        # page-scaled budget (see MAX_SCALAR_BUDGET_PAGES): granted only
        # AFTER the page tree parses — xref/ObjStm predictor streams are
        # tiny integer tables, well inside the base budget — and only
        # when the caller used the default base (an injected test budget
        # stays exact)
        if scalar_predictor_budget == MAX_PREDICTOR_SCALAR_BYTES:
            extra_pages = min(len(self.pages), MAX_SCALAR_BUDGET_PAGES) - 1
            self._scalar_budget_left += (
                extra_pages * MAX_PREDICTOR_SCALAR_BYTES
            )

    # -- object layer

    def _scan_objects(self) -> None:
        # Sequential scan that JUMPS OVER stream payloads: DCT/Flate bytes
        # are arbitrary binary and can contain "N G obj" by chance, so a
        # finditer over the whole file would let payload garbage overwrite
        # real objects under the later-definition-wins rule.
        d = self.data
        pos = 0
        while True:
            m = _OBJ_RE.search(d, pos)
            if m is None:
                break
            pos = m.end()
            num = int(m.group(1))
            lex = _Lexer(d, m.end())
            try:
                obj = lex.read_object()
            except PdfRefusal:
                continue
            # resume AFTER the parsed body, not inside it — literal strings
            # can contain "N G obj" and must not clobber real objects
            pos = lex.pos
            stream = None
            if isinstance(obj, dict) and lex.peek_bytes(6) == b"stream":
                lex.pos += 6
                if d.startswith(b"\r\n", lex.pos):
                    lex.pos += 2
                elif d.startswith(b"\n", lex.pos):
                    lex.pos += 1
                length = obj.get("Length")
                if isinstance(length, _Ref):
                    # indirect Length: usable only if that object was already
                    # parsed (never regex-hunt the raw file for it — payload
                    # bytes could fake a match)
                    prev = self.objects.get(length.num)
                    length = prev[0] if prev and isinstance(prev[0], int) else None
                if not isinstance(length, int):
                    length = None
                if length is None:
                    end = d.find(b"endstream", lex.pos)
                    if end < 0:
                        continue
                    stream = d[lex.pos : end]
                    # the spec allows exactly one EOL before "endstream" —
                    # strip at most that much, never real payload bytes
                    if stream.endswith(b"\r\n"):
                        stream = stream[:-2]
                    elif stream.endswith((b"\n", b"\r")):
                        stream = stream[:-1]
                else:
                    if lex.pos + length > len(d):
                        # truncated file: skip this object; anything that
                        # references it refuses with a dangling-ref error
                        continue
                    stream = d[lex.pos : lex.pos + length]
                    end = lex.pos + length
                pos = end + len(b"endstream")
            # later definitions (incremental updates) win: keep highest offset
            self.objects[num] = (obj, stream)
            self._origin[num] = m.start()
        if not self.objects:
            raise PdfRefusal("no parseable objects")

    def _unpack_objstms(self) -> None:
        """Unpack PDF 1.5 compressed object streams (/Type /ObjStm).

        The containers are ordinary raw ``N G obj`` stream objects the
        scan already found; their payload is Flate(+predictor) data laid
        out as N (objnum, offset) integer pairs followed at /First by the
        serialized objects. Packed objects carry no streams (spec rule),
        so (obj, None) entries suffice. Precedence merges with the raw
        layer by byte offset: a packed object loses to a raw redefinition
        that appears LATER in the file (incremental update) and wins over
        an earlier one."""
        for cnum, (cobj, craw) in list(self.objects.items()):
            if not (
                isinstance(cobj, dict)
                and cobj.get("Type") == "ObjStm"
                and craw is not None
            ):
                continue
            try:
                data = self._decode_stream_data(cobj, craw)
                n = int(self.resolve(cobj.get("N")))
                first = int(self.resolve(cobj.get("First")))
                if n <= 0 or n > 100_000 or first < 0 or first > len(data):
                    raise PdfRefusal("bad ObjStm header")
                head = _Lexer(data[:first])
                pairs = []
                for _ in range(n):
                    onum = head.read_object()
                    off = head.read_object()
                    if not isinstance(onum, int) or not isinstance(off, int):
                        raise PdfRefusal("non-integer ObjStm index entry")
                    pairs.append((onum, off))
            except Exception:
                # one broken container (bad flate, garbage header, short
                # payload) must not take down the document — anything that
                # needed its objects surfaces as a dangling-ref refusal
                # later
                continue
            origin = self._origin.get(cnum, 0)
            for onum, off in pairs:
                if off < 0 or first + off >= len(data):
                    continue  # offsets are relative to /First
                try:
                    packed = _Lexer(data, first + off).read_object()
                except Exception:
                    # same containment as the container level: the lexer
                    # can also raise ValueError (bad hex, missing '>'),
                    # and one malformed packed object — possibly unused —
                    # must not refuse the whole document
                    continue
                if self._origin.get(onum, -1) <= origin:
                    self.objects[onum] = (packed, None)
                    self._origin[onum] = origin

    def resolve(self, v):
        seen = 0
        while isinstance(v, _Ref):
            entry = self.objects.get(v.num)
            if entry is None:
                raise PdfRefusal(f"dangling object reference {v.num}")
            v = entry[0]
            seen += 1
            if seen > 32:
                raise PdfRefusal("reference cycle")
        return v

    def stream_for(self, ref) -> tuple[dict, bytes]:
        if not isinstance(ref, _Ref):
            raise PdfRefusal("expected an indirect stream reference")
        entry = self.objects.get(ref.num)
        if entry is None or entry[1] is None:
            raise PdfRefusal(f"object {ref.num} has no stream")
        return entry[0], entry[1]

    def decoded_stream(self, ref) -> bytes:
        """Stream bytes with Flate(+predictor) applied (content streams)."""
        obj, raw = self.stream_for(ref)
        return self._decode_stream_data(obj, raw)

    def _parms_for(self, parms, index: int):
        """Resolve one filter's /DecodeParms to a plain dict (or None):
        handles an indirect parms object, the array-parallel-to-Filter
        form, and indirect values inside the dict."""
        parms = self.resolve(parms)
        if isinstance(parms, list):
            parms = (
                self.resolve(parms[index]) if index < len(parms) else None
            )
        if parms is None:
            return None
        if not isinstance(parms, dict):
            raise PdfRefusal(f"unsupported /DecodeParms {parms!r}")
        return {k: self.resolve(v) for k, v in parms.items()}

    def _consume_scalar_budget(self, n: int) -> None:
        """Debit ``n`` scalar-predictor bytes from the document-wide
        budget (passed into ``_png_unfilter`` by every decode path)."""
        self._scalar_budget_left -= n
        if self._scalar_budget_left < 0:
            raise PdfRefusal(
                "document exceeds the cumulative average/Paeth predictor "
                "CPU ceiling"
            )

    def _decode_stream_data(self, obj: dict, raw: bytes) -> bytes:
        filters = self.resolve(obj.get("Filter"))
        if filters is None:
            return raw
        if isinstance(filters, str):
            filters = [filters]
        parms = obj.get("DecodeParms")
        out = raw
        for i, f in enumerate(filters):
            f = self.resolve(f)
            if f == "FlateDecode":
                out = _bounded_inflate(out)
                out = _apply_decode_parms(
                    out, self._parms_for(parms, i),
                    consume_scalar=self._consume_scalar_budget,
                )
            else:
                raise PdfRefusal(f"content-stream filter {f!r} unsupported")
        return out

    # -- page tree

    def _collect_pages(self) -> list[dict]:
        # /Root lives in the trailer, which sits after the body — and with
        # incremental updates the LAST trailer is authoritative. Iterate
        # matches newest-first and take the first that resolves to a real
        # catalog; stream payloads faking an earlier '/Root N 0 R' never
        # shadow it, and a garbage match can't raise on a non-dict object.
        root = None
        for m in reversed(list(re.finditer(rb"/Root\s+(\d+)\s+\d+\s+R", self.data))):
            entry = self.objects.get(int(m.group(1)))
            if entry and isinstance(entry[0], dict) and "Pages" in entry[0]:
                root = entry[0]
                break
        if root is None:
            # fall back: any /Type /Catalog object
            for obj, _ in self.objects.values():
                if isinstance(obj, dict) and obj.get("Type") == "Catalog":
                    root = obj
                    break
        if root is None:
            raise PdfRefusal("no document catalog found")
        node = self.resolve(root.get("Pages"))
        out: list[dict] = []
        self._walk_pages(node, {}, out, depth=0)
        if not out:
            raise PdfRefusal("page tree is empty")
        return out

    _INHERITED = ("MediaBox", "Resources", "Rotate")

    def _walk_pages(self, node, inherited, out, depth) -> None:
        if depth > 64:
            raise PdfRefusal("page tree too deep")
        if not isinstance(node, dict):
            raise PdfRefusal("malformed page tree node")
        inh = dict(inherited)
        for k in self._INHERITED:
            if k in node:
                inh[k] = node[k]
        if node.get("Type") == "Page" or ("Contents" in node and "Kids" not in node):
            page = dict(inh)
            page.update(node)
            out.append(page)
            return
        for kid in self.resolve(node.get("Kids", [])):
            self._walk_pages(self.resolve(kid), inh, out, depth + 1)

    # -- image XObject decode

    def _decode_image_xobject(self, ref, depth: int = 0) -> np.ndarray:
        """Image XObject -> HxWx{1,3,4} uint8 (alpha from /SMask)."""
        if depth > 4:  # SMask chains; a self-referencing mask must not recurse
            raise PdfRefusal("SMask nesting too deep")
        obj, raw = self.stream_for(ref)
        obj = {k: self.resolve(v) if k != "SMask" else v for k, v in obj.items()}
        if obj.get("Subtype") != "Image":
            raise PdfRefusal("Do target is not an image XObject "
                             "(form XObjects unsupported)")
        w, h = int(obj["Width"]), int(obj["Height"])
        bpc = int(obj.get("BitsPerComponent", 8))
        filters = obj.get("Filter")
        if isinstance(filters, str):
            filters = [filters]
        filters = [self.resolve(f) for f in (filters or [])]
        if obj.get("ImageMask"):
            raise PdfRefusal("stencil image masks unsupported")

        if w <= 0 or h <= 0 or w * h > MAX_RASTER_PIXELS:
            raise PdfRefusal(f"image dimensions {w}x{h} out of bounds")
        decode_array = obj.get("Decode")
        if filters == ["DCTDecode"]:
            if decode_array is not None:
                raise PdfRefusal("/Decode on DCT images unsupported")
            # validate the JPEG's OWN header dims before decode: the declared
            # Width/Height passed the ceiling, but a hostile stream could
            # carry a huge JPEG behind a tiny declaration and allocate
            # in-process during decode
            from flyimg_tpu_torch.codecs.sniff import sniff as _sniff

            info = _sniff(raw)
            if (info.width, info.height) != (w, h):
                raise PdfRefusal(
                    f"DCT stream is {info.width}x{info.height} but the "
                    f"XObject declares {w}x{h}"
                )
            px = _decode_jpeg(raw, self.device)
        elif filters in ([], ["FlateDecode"]):
            if bpc != 8:
                raise PdfRefusal(f"BitsPerComponent {bpc} unsupported")
            ncomp = _ncomponents(obj.get("ColorSpace"))
            need = w * h * ncomp
            if filters:
                # predictor rows add one filter byte per row to the
                # inflated size; the ceiling accounts for it
                data = _bounded_inflate(raw, need + h + 64)
                data = _apply_decode_parms(
                    data, self._parms_for(obj.get("DecodeParms"), 0),
                    ncomp_default=ncomp,
                    consume_scalar=self._consume_scalar_budget,
                )
            else:
                data = raw
            if len(data) < need:
                raise PdfRefusal("image stream shorter than declared size")
            px = np.frombuffer(data[:need], np.uint8).reshape(h, w, ncomp)
            if decode_array is not None:
                px = _apply_decode_array(
                    px, [float(self.resolve(v)) for v in
                         self.resolve(decode_array)], ncomp)
        else:
            raise PdfRefusal(f"image filter chain {filters!r} unsupported")

        if px.ndim == 2:
            px = px[:, :, None]
        if px.shape[2] == 1:
            px = np.repeat(px, 3, axis=2)
        elif px.shape[2] == 4:  # CMYK from DCT — rare via PIL; refuse honestly
            raise PdfRefusal("CMYK images unsupported")

        smask = obj.get("SMask")
        if isinstance(smask, _Ref):
            alpha = self._decode_image_xobject(smask, depth + 1)[:, :, :1]
            if alpha.shape[:2] != px.shape[:2]:
                alpha = _resize_u8(alpha, px.shape[1], px.shape[0])
            px = np.concatenate([px, alpha], axis=2)
        return px

    # -- content interpreter (q / Q / cm / Do only)

    # operators that only touch non-paint graphics state: safe to ignore
    _STATE_OPS = {
        "w", "J", "j", "M", "d", "ri", "i",
        "g", "G", "rg", "RG", "k", "K", "cs", "CS", "sc", "scn", "SC", "SCN",
        "m", "l", "c", "v", "y", "re", "h",  # path *construction* (no paint)
        "n",                                 # no-op paint
        "MP", "DP", "BMC", "BDC", "EMC",     # marked content
    }
    # ExtGState keys that change how paint composites; a dict setting any of
    # these to a non-default value cannot be honored -> refuse
    _EXTGSTATE_PAINT_KEYS = {
        "ca": 1, "CA": 1, "SMask": "None", "BM": ("Normal", "Compatible"),
    }
    # paint operators we cannot honor -> refuse the document
    _PAINT_OPS = {
        "S", "s", "f", "F", "f*", "B", "B*", "b", "b*", "sh",
        "BT", "Tj", "TJ", "'", '"', "BI",
        "d0", "d1",
    }

    def _check_extgstate(self, extgstates, name) -> None:
        gstate = self.resolve(extgstates.get(name))
        if not isinstance(gstate, dict):
            raise PdfRefusal(f"unknown ExtGState {name!r}")
        for key, default in self._EXTGSTATE_PAINT_KEYS.items():
            if key not in gstate:
                continue
            val = self.resolve(gstate[key])
            ok = val in default if isinstance(default, tuple) else val == default
            if not ok:
                raise PdfRefusal(
                    f"ExtGState sets {key}={val!r} (transparency/blending) — "
                    "outside the image-only subset"
                )

    def rasterize(self, page_index: int, dpi: float) -> np.ndarray:
        """Render 1-indexed page to an RGB uint8 array on white."""
        if page_index < 1 or page_index > len(self.pages):
            raise ExecFailedException(
                f"page {page_index} out of range (document has "
                f"{len(self.pages)} pages)"
            )
        page = self.pages[page_index - 1]
        box = [float(self.resolve(v)) for v in self.resolve(page.get(
            "MediaBox", [0, 0, 612, 792]))]
        if len(box) != 4:
            raise PdfRefusal("malformed /MediaBox")
        pw, ph = box[2] - box[0], box[3] - box[1]
        if pw <= 0 or ph <= 0:
            raise PdfRefusal("degenerate /MediaBox")
        rotate = int(self.resolve(page.get("Rotate", 0)) or 0) % 360
        if rotate not in (0, 90, 180, 270):
            raise PdfRefusal(f"/Rotate {rotate} unsupported")
        scale = dpi / 72.0
        W, H = max(1, round(pw * scale)), max(1, round(ph * scale))
        if W > MAX_RASTER_SIDE or H > MAX_RASTER_SIDE or W * H > MAX_RASTER_PIXELS:
            raise PdfRefusal(
                f"page raster {W}x{H} at {dpi} dpi exceeds the size ceiling"
            )
        canvas = np.full((H, W, 3), 255, np.uint8)

        contents = page.get("Contents")
        streams = contents if isinstance(self.resolve(contents), list) else [contents]
        body = b"\n".join(
            self.decoded_stream(c) for c in self.resolve(streams) if c is not None
        )
        resources = self.resolve(page.get("Resources", {})) or {}
        xobjects = self.resolve(resources.get("XObject", {})) or {}
        extgstates = self.resolve(resources.get("ExtGState", {})) or {}

        # CTM maps user space -> raster pixels (y flipped, origin top-left)
        base = np.array([[scale, 0, -box[0] * scale],
                         [0, -scale, box[3] * scale]], np.float64)
        ctm = base.copy()
        clipped = False  # a W/W* clip is part of graphics state
        stack: list[tuple[np.ndarray, bool]] = []

        lex = _Lexer(body)
        operands: list = []
        opre = re.compile(rb"[A-Za-z'\"][A-Za-z0-9*'\"]*")
        while True:
            lex._skip_ws()
            if lex.pos >= len(body):
                break
            c = body[lex.pos]
            if c in b"/<[(+-.0123456789" or body.startswith(b"true", lex.pos) \
                    or body.startswith(b"false", lex.pos) \
                    or body.startswith(b"null", lex.pos):
                operands.append(lex.read_object())
                continue
            m = opre.match(body, lex.pos)
            if not m:
                raise PdfRefusal(f"bad content stream byte at {lex.pos}")
            op = m.group(0).decode("latin1")
            lex.pos = m.end()
            if op == "q":
                stack.append((ctm.copy(), clipped))
            elif op == "Q":
                ctm, clipped = stack.pop() if stack else (base.copy(), False)
            elif op == "cm":
                a, b, c2, d2, e, f = (float(v) for v in operands[-6:])
                mnew = np.array([[a, c2, e], [b, d2, f], [0, 0, 1]], np.float64)
                ctm = ctm @ mnew
            elif op in ("W", "W*"):
                clipped = True
            elif op == "gs":
                self._check_extgstate(extgstates, operands[-1])
            elif op == "Do":
                if clipped:
                    # we have no clip rasterizer; painting unclipped would
                    # be silently wrong output, so refuse
                    raise PdfRefusal(
                        "image drawn under an active clipping path — "
                        "outside the image-only subset"
                    )
                name = operands[-1]
                target = xobjects.get(name)
                if target is None:
                    raise PdfRefusal(f"unknown XObject {name!r}")
                _blit(canvas, self._decode_image_xobject(target), ctm)
            elif op in self._STATE_OPS:
                pass
            elif op in self._PAINT_OPS:
                raise PdfRefusal(
                    f"content uses {op!r} (text/vector painting) — outside "
                    "the image-only subset; install ghostscript for full PDF"
                )
            else:
                raise PdfRefusal(f"unknown content operator {op!r}")
            operands = []

        if rotate:
            canvas = np.ascontiguousarray(np.rot90(canvas, k=rotate // 90 * -1 % 4))
        return canvas


def _apply_decode_array(px: np.ndarray, dec: list[float], ncomp: int) -> np.ndarray:
    """/Decode remaps sample range [0,255] -> [Dmin,Dmax] per component
    (scan pipelines commonly emit [1 0] inversion)."""
    if len(dec) != 2 * ncomp:
        raise PdfRefusal(f"/Decode array length {len(dec)} != {2 * ncomp}")
    lo = np.array(dec[0::2], np.float32)
    hi = np.array(dec[1::2], np.float32)
    out = (lo + px.astype(np.float32) / 255.0 * (hi - lo)) * 255.0
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def _ncomponents(colorspace) -> int:
    if colorspace in ("DeviceRGB", "CalRGB"):
        return 3
    if colorspace in ("DeviceGray", "CalGray", None):
        return 1
    raise PdfRefusal(f"color space {colorspace!r} unsupported")


def _decode_jpeg(data: bytes, device="cuda") -> np.ndarray:
    """A DCTDecode image -> [h, w, 3] u8 with the port's JPEG decoder (the
    JAX package's native decode: libjpeg-turbo's pixels), its kernels on
    ``device``."""
    from flyimg_tpu_torch.codecs import native_codec

    return native_codec.jpeg_decode(data, 8, device=device)


def _resize_u8(px: np.ndarray, w: int, h: int, box=None) -> np.ndarray:
    """Host-side bilinear resize for page compositing: Pillow's
    ``Image.resize((w, h), BILINEAR, box=box)`` of an L, RGB or RGBA
    [h, w, c] array (``models/thumbnail.py``; RGBA premultiplied)."""
    from flyimg_tpu_torch.models import thumbnail

    arr = px[:, :, 0] if px.shape[2] == 1 else px
    out = thumbnail.resize(arr, w, h, thumbnail.BILINEAR, box=box)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def _blit(canvas: np.ndarray, px: np.ndarray, ctm: np.ndarray) -> None:
    """Composite an image XObject (unit square in user space) through an
    axis-aligned CTM onto the canvas. Rotated/skewed CTMs are refused."""
    a, c, e = ctm[0]
    b, d, f = ctm[1]
    if abs(b) > 1e-6 or abs(c) > 1e-6:
        raise PdfRefusal("rotated/skewed image placement unsupported")
    # unit square corners (0,0)-(1,1) -> pixel rect
    x0, x1 = sorted((e, e + a))
    y0, y1 = sorted((f, f + d))
    xi0, yi0 = int(round(x0)), int(round(y0))
    xi1, yi1 = int(round(x1)), int(round(y1))
    w, h = xi1 - xi0, yi1 - yi0
    if w <= 0 or h <= 0:
        return
    # image row 0 sits at unit-square y=1 (the top, PDF image space). The
    # base CTM already flips user y into raster y-down, so an upright
    # placement composes to d < 0 here and needs NO flip; d > 0 means the
    # content stream itself mirrored the image vertically.
    if a < 0:
        px = np.ascontiguousarray(px[:, ::-1])
    if d > 0:
        px = np.ascontiguousarray(px[::-1])
    # clip the DESTINATION rect to the canvas before any resize: a hostile
    # cm can scale the unit square to gigapixels, and resizing to the full
    # rect first would allocate it (the clipped size is bounded by the
    # already-ceiling-checked canvas)
    cx0, cy0 = max(xi0, 0), max(yi0, 0)
    cx1, cy1 = min(xi1, canvas.shape[1]), min(yi1, canvas.shape[0])
    if cx0 >= cx1 or cy0 >= cy1:
        return
    src_h, src_w = px.shape[:2]
    box = (
        (cx0 - xi0) / w * src_w,
        (cy0 - yi0) / h * src_h,
        (cx1 - xi0) / w * src_w,
        (cy1 - yi0) / h * src_h,
    )
    sub = _resize_u8(px, cx1 - cx0, cy1 - cy0, box=box)
    dst = canvas[cy0:cy1, cx0:cx1]
    if sub.shape[2] == 4:
        alpha = sub[:, :, 3:].astype(np.float32) / 255.0
        blended = sub[:, :, :3].astype(np.float32) * alpha + dst.astype(
            np.float32
        ) * (1.0 - alpha)
        dst[:] = np.clip(blended + 0.5, 0, 255).astype(np.uint8)
    else:
        dst[:] = sub[:, :, :3]


def rasterize_mini(data: bytes, page: int = 1, density: float | None = None,
                   device="cuda") -> np.ndarray:
    """One 1-indexed page of a PDF's bytes -> [h, w, 3] u8 on white.

    Any exception that is not already one of ours is mapped to PdfRefusal:
    malformed documents must surface as a 415 through the app's status
    map (UnsupportedMediaException -> 415), never a 500 — zlib errors,
    short arrays, bad hex, recursion, etc. are all just "this document is
    outside what we rasterize"."""
    from flyimg_tpu_torch.codecs.pdf import DEFAULT_DENSITY
    from flyimg_tpu_torch.exceptions import AppException

    try:
        doc = MiniPdf(data, device=device)
        return doc.rasterize(max(int(page), 1), float(density or DEFAULT_DENSITY))
    except (AppException, OSError):
        raise
    except Exception as exc:
        raise PdfRefusal(f"unparseable PDF ({type(exc).__name__}: {exc})") from exc


def rasterize_page_mini(
    pdf_path: str, out_path: str, page: int = 1, density: float | None = None,
    device="cuda",
) -> str:
    """Drop-in sibling of pdf.rasterize_page for the image-only subset: the
    page (``rasterize_mini``) written as a PNG by the port's encoder."""
    from flyimg_tpu_torch.codecs import png

    with open(pdf_path, "rb") as fh:
        data = fh.read()
    arr = rasterize_mini(data, page, density, device)
    with open(out_path, "wb") as fh:
        fh.write(png.encode(arr))
    return out_path
