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

The host route (``HOST_SOURCES``, ``build_host``, ``load_host``) builds the
package's host C++ under ``codecs/native/`` (the WebP codec: its VP8 and
VP8L sources into one library; the raster loops of GIF, TIFF and BMP into
another) the same way with ``g++``, into
``build/codecs/`` (or ``FLYIMG_TORCH_BUILD_DIR``): it needs no CUDA, so the
CPU tests build and run it too.

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

#: host library name -> (files under the package: the .cpp sources compiled
#: together and the headers they include, all in the library's digest;
#: extra g++ flags)
HOST_SOURCES: Dict[str, tuple] = {
    "webp": (tuple(os.path.join("codecs", "native", f) for f in (
        "webp_lossy.cpp", "webp_lossless.cpp", "vp8_tables.h", "webp_lossless.h")), ()),
    # LZW (GIF and TIFF), the GIF quantizer, PackBits and BMP RLE
    "raster": (tuple(os.path.join("codecs", "native", f) for f in (
        "gif.cpp", "raster.cpp")), ()),
}

HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

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


def host_build_dir() -> str:
    return os.environ.get("FLYIMG_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "codecs"
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


def _digest_path(directory: str, name: str, srcs, flags) -> str:
    digest = hashlib.sha1()
    for src in srcs:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(flags).encode())
    return os.path.join(directory, f"{name}-{digest.hexdigest()[:12]}.so")


def _lib_path(name: str) -> str:
    src, flags = SOURCES[name]
    return _digest_path(build_dir(), name, [os.path.join(CSRC_DIR, src)],
                        BASE_FLAGS + tuple(flags))


def _host_lib_path(name: str) -> str:
    files, flags = HOST_SOURCES[name]
    return _digest_path(host_build_dir(), name, [os.path.join(_PKG_DIR, f) for f in files],
                        HOST_FLAGS + tuple(flags))


def _compile(jobs, what: str) -> Dict[str, float]:
    """Run ``jobs`` (name -> (compiler argv without -o, output path)) all
    together, each into a temporary file renamed into place when it
    succeeds. Returns seconds per job (0.0 for an output already on disk);
    raises with the compiler's output when any fails."""
    procs = {}
    took: Dict[str, float] = {}
    t0 = time.perf_counter()
    for name, (cmd, out) in jobs.items():
        if os.path.exists(out):
            took[name] = 0.0
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [*cmd, "-o", tmp], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))
    return took


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` per source, all started together. Returns seconds per
    kernel built (0.0 for a library already on disk); raises with
    ``nvcc``'s output when any build fails."""
    names = list(names) if names is not None else list(SOURCES)
    jobs = {}
    for name in names:
        src, flags = SOURCES[name]
        jobs[name] = ([nvcc_path(), *BASE_FLAGS, *flags,
                       os.path.join(CSRC_DIR, src)], _lib_path(name))
    return _compile(jobs, "kernel")


def build_host(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """``build`` for the host libraries of ``HOST_SOURCES``, with g++."""
    names = list(names) if names is not None else list(HOST_SOURCES)
    jobs = {}
    for name in names:
        files, flags = HOST_SOURCES[name]
        srcs = [os.path.join(_PKG_DIR, f) for f in files if f.endswith(".cpp")]
        jobs[name] = (["g++", *HOST_FLAGS, *flags, *srcs], _host_lib_path(name))
    return _compile(jobs, "host library")


def _load(key: str, path_fn, build_fn, name: str) -> ctypes.CDLL:
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = path_fn(name)
            if not os.path.exists(path):
                build_fn([name])
            lib = ctypes.CDLL(path)
            _libs[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel, building it first if needed."""
    return _load(name, _lib_path, build, name)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name``, building it first if needed."""
    return _load("host:" + name, _host_lib_path, build_host, name)


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
