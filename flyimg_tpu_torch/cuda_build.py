"""Build the package's CUDA kernels with ``nvcc`` and bind them by ``ctypes``.

Each source under ``csrc/`` compiles, at first use, into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC [per-file flags] -o build/kernels/<name>-<digest>.so

The library name carries a digest of the source and the flags, so an
edited source rebuilds and a stale library is never loaded. Libraries go
under ``build/kernels/`` beside the package (``FLYIMG_TORCH_BUILD_DIR``
overrides it). ``build()`` starts one ``nvcc`` per source, all together.
Nothing here runs at import time: the CPU tests import every module on
hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

#: kernel name -> (source file, extra nvcc flags)
SOURCES: Dict[str, tuple] = {
    "resample_banded": ("resample_banded.cu", ()),
    # the saliency maps are floored integers: no multiply-add contraction
    "saliency": ("saliency.cu", ("--fmad=false",)),
    "scores": ("scores.cu", ()),
    # a dither threshold and rotate's floor/inside tests are knife-edges:
    # every product and sum rounds in the reference's order
    "pixel_pass": ("pixel_pass.cu", ("--fmad=false",)),
    "rotate": ("rotate.cu", ("--fmad=false",)),
    # the previous K4, which chip_smoke.py holds K4 to the bit against
    "rotate_prev": ("rotate_prev.cu", ("--fmad=false",)),
    # K15, the ring rotate's step: the same knife-edges as K4
    "ring_rotate": ("ring_rotate.cu", ("--fmad=false",)),
    "separable": ("separable.cu", ()),
    "pixelate": ("pixelate.cu", ()),
    # the skin probability rounds in the reference's order through explicit
    # __f*_rn intrinsics; expf is left as torch's CUDA exp compiles it
    "facemask": ("facemask.cu", ()),
    "blazeface": ("blazeface.cu", ()),
    # K11-K14 round every product and sum through __f*_rn intrinsics
    "blazeface_train": ("blazeface_train.cu", ()),
}

BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: kernel name -> nvcc's stderr (the -Xptxas -v register/smem report)
build_logs: Dict[str, str] = {}


def build_dir() -> str:
    return os.environ.get("FLYIMG_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "kernels"
    )


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    src, flags = SOURCES[name]
    digest = hashlib.sha1()
    with open(os.path.join(CSRC_DIR, src), "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join(BASE_FLAGS + tuple(flags)).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:12]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` per source, all started together. Returns seconds per
    kernel built (0.0 for a library already on disk); raises with
    ``nvcc``'s output when any build fails."""
    names = list(names) if names is not None else list(SOURCES)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    took: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            took[name] = 0.0
            continue
        src, flags = SOURCES[name]
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc_path(), *BASE_FLAGS, *flags, "-o", tmp,
               os.path.join(CSRC_DIR, src)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _libs[name] = lib
    return lib


_raw_stream = None


def current_stream(index: int) -> int:
    """The raw handle of the current CUDA stream of card ``index``: PyTorch's
    own getter where the build has it (no Stream object is made), else
    ``torch.cuda.current_stream``."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream
        )
    return _raw_stream(index)


def check(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
