"""PDF rasterization: ghostscript when present, the mini rasterizer else.

The port of the JAX package's ``codecs/pdf.py``. The reference rasterizes a
PDF with ImageMagick's ghostscript delegate at ``-density`` and a
``[page-1]`` selector (reference src/Core/Processor/ImageProcessor.php:
70-72,80-84). Where ``gs`` is on the PATH it renders the page with the same
command line as the JAX package's; where it is not, ``pdf_mini`` renders
the image-only subset (its DCTDecode images through the JPEG kernels on
``device``) and refuses anything needing a font engine or a path
rasterizer. ``dnst_`` is checked for 1..9600 before either backend runs.
"""

from __future__ import annotations

import shutil
import subprocess

from flyimg_tpu_torch.exceptions import ExecFailedException, InvalidArgumentException

GHOSTSCRIPT = shutil.which("gs")
DEFAULT_DENSITY = 96  # IM's default PDF density is 72; flyimg exposes dnst_
MAX_DENSITY = 9600    # 100x the default; past this the raster ceiling always trips


def rasterize_page(
    pdf_path: str, out_path: str, page: int = 1, density: int | None = None,
    device="cuda",
) -> str:
    """Rasterize one 1-indexed page to PNG at ``density`` dpi."""
    dpi = int(density or DEFAULT_DENSITY)
    if not 0 < dpi <= MAX_DENSITY:
        # validated here so BOTH backends agree: gs would fail with a
        # cryptic rc on -r-96, the mini path would emit a 1x1 blank
        raise InvalidArgumentException(f"dnst_{dpi} out of range (1..{MAX_DENSITY})")
    page = max(int(page), 1)
    if GHOSTSCRIPT is None:
        from flyimg_tpu_torch.codecs.pdf_mini import rasterize_page_mini

        return rasterize_page_mini(pdf_path, out_path, page, dpi, device=device)
    cmd = [
        GHOSTSCRIPT, "-dSAFER", "-dBATCH", "-dNOPAUSE", "-sDEVICE=png16m",
        f"-r{dpi}", f"-dFirstPage={page}", f"-dLastPage={page}",
        f"-sOutputFile={out_path}", pdf_path,
    ]
    proc = subprocess.run(cmd, capture_output=True, timeout=120)
    if proc.returncode != 0:
        raise ExecFailedException(
            f"ghostscript failed (rc={proc.returncode}): {proc.stderr[-400:]!r}"
        )
    return out_path
