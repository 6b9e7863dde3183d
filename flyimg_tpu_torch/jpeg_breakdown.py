"""K16's team width and phases, and K16 and K17 against another checkout's,
on the card.

    python3 -m flyimg_tpu_torch.jpeg_breakdown [--lanes 2,4,8,16,32] [--parent DIR]
        [--iters 5] [--sass FILE]

1. Builds copies of ``csrc/jpeg_trellis.cu`` at each team width
   (``-DK16_LANES=N``: the lanes that work one 8x8 block) and of
   ``csrc/jpeg_fdct.cu`` under ``build/jpeg_breakdown/``, reports ptxas's
   registers, stack frame and spills of ``trellis_kernel`` and
   ``fdct_kernel``, and holds each copy against its plain version,
   coefficient for coefficient, on both frames: the 300x250 answer of
   ``tests/data/jpeg_enc/source.png`` and a 1920x1080 frame
   (``chip_smoke.py``'s ``synthetic_image``, seed 1900), q90 4:4:4.
2. Device ms of each width on both frames (a ``torch.profiler`` window of
   ``--iters`` calls), in turns: the widths in order, then reversed; K17's
   device ms.
3. A copy at the source's width built with ``-DK16_PHASE_CLOCKS``: each
   block's lane 0 stamps ``clock64()`` at the phase boundaries (constants
   and RGB staged, the plane, the DCT, the per-position values, the
   chain, the last position and the back pointers, the backtrack) into its
   output; the mean and the largest cycles of each phase over the blocks,
   and the chain's mean cycles a step with a candidate in the warp and a
   position without, at both frames.
4. ``--parent DIR``: the package of another checkout (an earlier commit,
   unpacked there) timed through its own wrappers on the same frames, in
   turns with this one's (parent, this, this, parent), each in a process
   of its own: K16's and K17's device ms and their wrappers' ms by CUDA
   events (median of 10).
5. ``--sass FILE``: K16's SASS at the source's width, each instruction
   with its source line (ptxas's spill warnings go to the output).

Prints one JSON line with the card's name and power limit. Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_ms(fn, iters: int = 10) -> float:
    """Median milliseconds of ``fn()`` by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frames() -> dict:
    """The two frames: label -> [h, w, 3] u8."""
    from flyimg_tpu_torch.codecs import png

    with open(os.path.join(_ROOT, "tests", "data", "jpeg_enc", "source.png"), "rb") as fh:
        src, _ = png.decode(fh.read())
    sys.path.insert(0, _ROOT)
    from chip_smoke import synthetic_image

    return {"300x250": np.ascontiguousarray(src), "1920x1080": synthetic_image(1920, 1080, 1900)}


def wrapper_times(images: dict, iters: int) -> dict:
    """K16's and K17's device ms and wrapper ms through the package on the
    path (q90, 4:4:4)."""
    from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables
    from flyimg_tpu_torch.face_breakdown import _device_ms

    dev = torch.device("cuda", 0)
    tables = jpeg_tables.qtables(90)
    out = {}
    for label, img in images.items():
        rgb = torch.from_numpy(img).to(dev)
        planes = jpeg_plain.grid_planes(rgb, (1, 1))

        def k16():
            return jpeg_enc.trellis_coefficients(rgb, 90, (1, 1))

        def k17():
            return jpeg_enc.fdct_coefficients(planes, tables, (0, 1, 1))

        out[label] = {"K16_device_ms": round(_device_ms(k16, iters, "trellis_kernel"), 5),
                      "K16_ms": round(cuda_ms(k16), 5),
                      "K17_device_ms": round(_device_ms(k17, iters, "fdct_kernel"), 5),
                      "K17_ms": round(cuda_ms(k17), 5)}
    return out


def build(out_dir: str, lanes) -> dict:
    """Compile the K16 widths and K17 into ``out_dir``: name -> (library
    path, ptxas report of its kernel)."""
    from flyimg_tpu_torch import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    jobs = {f"K16 L={n}": ("jpeg_trellis", (f"-DK16_LANES={n}",)) for n in lanes}
    jobs["K16 phase clocks"] = ("jpeg_trellis", ("-DK16_PHASE_CLOCKS",))
    jobs["K17"] = ("jpeg_fdct", ())
    procs = {}
    for i, (name, (src, extra)) in enumerate(jobs.items()):
        source, flags = cuda_build.SOURCES[src]
        lib = os.path.join(out_dir, f"{src}_{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.BASE_FLAGS, *flags, *extra,
             os.path.join(cuda_build.CSRC_DIR, source), "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        kernel = "trellis_kernel" if name.startswith("K16") else "fdct_kernel"
        report = {k: v for k, v in cuda_build.ptxas_report(log).items() if kernel in k}
        built[name] = (lib, next(iter(report.values()), {}))
    return built


def write_sass(path: str) -> None:
    """K16's SASS at the source's width, each instruction with its source
    line (``-lineinfo``, ``nvdisasm --print-line-info``)."""
    from flyimg_tpu_torch import cuda_build

    out_dir = os.path.join(_ROOT, "build", "jpeg_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    source, flags = cuda_build.SOURCES["jpeg_trellis"]
    cubin = os.path.join(out_dir, "jpeg_trellis.cubin")
    nvcc = cuda_build.nvcc_path()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-lineinfo", "-Xptxas", "-v,-warn-spills,-warn-lmem-usage", *flags,
                    os.path.join(cuda_build.CSRC_DIR, source), "-o", cubin], check=True)
    nvdisasm = os.path.join(os.path.dirname(nvcc), "nvdisasm")
    dis = subprocess.run([nvdisasm, "--print-line-info", "-c", cubin], capture_output=True,
                         text=True, check=True)
    with open(path, "w") as fh:
        fh.write(dis.stdout)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="2,4,8,16,32")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--sass", default=None,
                    help="write K16's SASS (default width, with source lines) to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("jpeg_breakdown: no CUDA card", file=sys.stderr)
        return 1

    from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables
    from flyimg_tpu_torch.face_breakdown import _device_ms

    if args.sass:
        write_sass(args.sass)
    lanes = [int(n) for n in args.lanes.split(",")]
    built = build(os.path.join(_ROOT, "build", "jpeg_breakdown"), lanes)
    result = {"card": card_line(), "ptxas": {k: v[1] for k, v in built.items()}}
    images = frames()
    dev = torch.device("cuda", 0)
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        if name == "K17":
            lib.flyimg_jpeg_fdct.argtypes = [p, p, ctypes.POINTER(jpeg_enc._FdctParams), p, i, p]
            lib.flyimg_jpeg_fdct.restype = i
        else:
            jpeg_enc.bind_trellis(lib)
        libs[name] = lib
    jpeg_enc._fdct_lib = lambda: libs["K17"]
    clocks = libs.pop("K16 phase clocks")
    tables = jpeg_tables.qtables(90)
    rgbs = {label: torch.from_numpy(img).to(dev) for label, img in images.items()}
    planes = {label: jpeg_plain.grid_planes(rgb, (1, 1)) for label, rgb in rgbs.items()}
    # coefficient for coefficient against the plain versions
    for label, rgb in rgbs.items():
        want = jpeg_plain.trellis_plain(rgb, 90, (1, 1))
        for name, lib in libs.items():
            if name == "K17":
                got = jpeg_enc.fdct_coefficients(planes[label], tables, (0, 1, 1))
                ref = torch.cat([jpeg_plain.fdct_islow_plain(pl, tables[t])
                                 for pl, t in zip(planes[label], (0, 1, 1))])
            else:
                jpeg_enc._trellis_lib = lambda lib=lib: lib
                got, ref = jpeg_enc.trellis_coefficients(rgb, 90, (1, 1)), want
            torch.cuda.synchronize()
            bad = int((got != ref).any(1).sum())
            if bad:
                raise SystemExit(f"jpeg_breakdown: {name} differs from its plain version in "
                                 f"{bad} blocks of the {label} frame")
    result["held"] = "every build equal to its plain version on both frames"
    # the widths in turns
    timings = {name: {label: [] for label in rgbs} for name in libs if name != "K17"}
    order = [name for name in libs if name != "K17"]
    for turn in (order, order[::-1]):
        for name in turn:
            jpeg_enc._trellis_lib = lambda lib=libs[name]: lib
            for label, rgb in rgbs.items():
                timings[name][label].append(round(_device_ms(
                    lambda: jpeg_enc.trellis_coefficients(rgb, 90, (1, 1)), args.iters,
                    "trellis_kernel"), 5))
    result["K16_device_ms"] = timings
    jpeg_enc._trellis_lib = lambda: clocks
    phases = ("constants and staging", "plane", "DCT", "per-position values", "chain",
              "last position and back pointers", "backtrack")
    result["K16_phase_cycles"] = {}
    for label, rgb in rgbs.items():
        words = jpeg_enc.trellis_coefficients(rgb, 90, (1, 1)).view(torch.int64).double()
        steps = words[:, 1:8] - words[:, :7]
        cycles = {name: {"mean": round(float(steps[:, i].mean()), 1),
                         "max": int(steps[:, i].max())} for i, name in enumerate(phases)}
        cand = words[:, 9].clamp_min(1)
        cycles["chain steps with a candidate"] = {
            "mean steps": round(float(words[:, 9].mean()), 2),
            "mean cycles a step": round(float((words[:, 8] / cand).mean()), 1)}
        cycles["chain positions without"] = {
            "mean cycles a position": round(float((words[:, 10] / (63 - words[:, 9])).mean()), 1)}
        result["K16_phase_cycles"][label] = cycles
    result["K17_device_ms"] = {label: round(_device_ms(
        lambda: jpeg_enc.fdct_coefficients(planes[label], tables, (0, 1, 1)), args.iters,
        "fdct_kernel"), 5) for label in rgbs}
    if args.parent:
        with tempfile.TemporaryDirectory(dir=os.path.join(_ROOT, "build")) as tmp:
            npz = os.path.join(tmp, "frames.npz")
            np.savez(npz, **images)
            runs = []
            # this file's functions, run in the tree's root (its package first
            # on the path)
            child = (f"import json, runpy, numpy as np; m = runpy.run_path({__file__!r}); "
                     f"d = np.load({npz!r}); "
                     f"print(json.dumps(m['wrapper_times']({{k: d[k] for k in d.files}}, "
                     f"{args.iters})))")
            for tree in (args.parent, _ROOT, _ROOT, args.parent):
                proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                                      text=True, cwd=os.path.abspath(tree), timeout=900)
                if proc.returncode != 0:
                    raise SystemExit(f"jpeg_breakdown: {tree}: {proc.stderr[-2000:]}")
                runs.append({"tree": "parent" if tree == args.parent else "this",
                             **json.loads(proc.stdout.strip().splitlines()[-1])})
            result["turns"] = runs
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
