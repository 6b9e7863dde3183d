"""K16's team width and phases, K16 and K17 against another checkout's, and
the decoder's K18 and K19 against another checkout's, on the card.

    python3 -m flyimg_tpu_torch.jpeg_breakdown [--lanes 2,4,8,16,32] [--parent DIR]
        [--iters 5] [--sass FILE] [--part all|encode|decode|tiles|k19|tables|wave,...]
        [--k19-sources LABEL=FILE,...] [--tile-lengths 16,32,64]

``--part`` takes a comma-separated list: ``encode`` runs 1-5, ``decode``
6, ``tiles``, ``k19``, ``tables`` and ``wave`` 7-10; ``all`` is ``encode``
and ``decode``.

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
6. The decoder's K18 (IDCT) and K19 (upsampling and colour) on the
   decodes phase 3 of ``chip_smoke.py`` times: the 300x250 answer and a
   seeded 4032x3024 4:2:0 q90 baseline photo at 1/4, 1/2 and 1/1, made
   once by the port's encoder. Each kernel held to its plain version
   (max difference 0), then, with ``--parent``, both kernels' device ms
   (``torch.profiler``) and kernel ms (single calls between CUDA events,
   the wrapper included, median of 10) through each tree's own wrappers,
   in turns (parent, this, this, parent), each in a process of its own;
   without ``--parent`` this tree's alone.
7. ``tiles``: K18's device ms with tile tables of each of
   ``--tile-lengths`` (``jpeg_dec.idct_tiles``' ``most``), in turns (the
   lengths in order, then reversed) in one process, at each of
   ``--tile-sizes`` at 1/4 and 1/1 (300x250: the answer at 1/1; the
   others seeded 4:2:0 q90 photos); each table's planes first held to the
   plain version.
8. ``k19``: K19 built from each ``--k19-sources`` file (a variant of
   ``csrc/jpeg_color.cu`` over the same tile and member tables, its C
   entry as this one's or with an ``int nmem`` member count after the
   member table) and timed in turns (in order, then reversed) in one
   process at 6's decodes, device ms; each held to the plain version
   first.
9. ``tables``: the host milliseconds of ``build_tables`` and of
   ``pack_tables`` (pinned) for a decode group of 1, 16 and 32 members
   (3 to 96 segments) of the 4032x3024 photo at 1/4 and of the 300x250
   answer (median of 20).
10. ``wave``: ``chip_smoke.py`` phase 15's wave (its 16 requests on the
   baseline and progressive 4032x3024 photos, served concurrently by a
   fresh server with the banded resample) at its 25 ms codec deadline and
   at the default, ``--iters`` waves each after one untimed wave: wall
   seconds; with ``--parent`` each tree's server in turns (parent, this,
   this, parent), each in a process of its own.

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
import time

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


#: the decodes part 6 times: label -> (file, DCT scale of 8)
DECODE_CASES = {"300x250 1/1": ("answer", 8), "4032x3024 1/4": ("photo", 2),
                "4032x3024 1/2": ("photo", 4), "4032x3024 1/1": ("photo", 8)}


def decode_files(out_dir: str) -> dict:
    """The JPEGs of parts 6 and 8-10, made by this tree's encoder on the
    card (``chip_smoke.py``'s ``answer_jpeg`` and ``flagship_jpegs``,
    baseline, progressive), written to ``out_dir``: name -> path."""
    sys.path.insert(0, _ROOT)
    from chip_smoke import answer_jpeg, flagship_jpegs

    dev = torch.device("cuda", 0)
    photos = flagship_jpegs(dev)
    paths = {}
    for name, data in (("answer", answer_jpeg(dev)), ("photo", photos["baseline"]),
                       ("progressive", photos["progressive"])):
        paths[name] = os.path.join(out_dir, f"{name}.jpg")
        with open(paths[name], "wb") as fh:
            fh.write(data)
    return paths


def decode_calls(batch, dev):
    """(K18 call, K19 call) through the package on the path, whichever
    form of the decoder's wrappers it has: tile tables with host counts,
    or (an earlier checkout's) the segment and member tables on the
    card."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    if hasattr(jpeg_dec, "upload"):
        coefs, quant, k18_tiles, mems, k19_tiles = jpeg_dec.upload(batch, dev)
        tab = batch.tables

        def k18():
            return jpeg_dec.idct_planes(coefs, quant, k18_tiles, tab.plane_bytes)

        planes = k18()

        def k19():
            return jpeg_dec.color_planes(planes, mems, tab.out_bytes, k19_tiles)
    else:
        coefs, quant = batch.coefs.to(dev), batch.quant.to(dev)
        segs, mems = batch.segments.to(dev), batch.members.to(dev)

        def k18():
            return jpeg_dec.idct_planes(coefs, quant, segs, batch.plane_bytes)

        planes = k18()

        def k19():
            return jpeg_dec.color_planes(planes, mems, batch.out_bytes)
    return k18, k19


def decode_times(paths: dict, iters: int) -> dict:
    """K18's and K19's device ms and kernel ms at each of DECODE_CASES
    through the package on the path."""
    from flyimg_tpu_torch.codecs import jpeg_dec
    from flyimg_tpu_torch.face_breakdown import _device_ms

    dev = torch.device("cuda", 0)
    out = {}
    for label, (name, scale) in DECODE_CASES.items():
        with open(paths[name], "rb") as fh:
            data = fh.read()
        batch = jpeg_dec.entropy_decode([(data, scale, None)], pinned=True)
        k18, k19 = decode_calls(batch, dev)
        out[label] = {"K18_device_ms": round(_device_ms(k18, iters, "idct_kernel"), 5),
                      "K18_ms": round(cuda_ms(k18), 5),
                      "K19_device_ms": round(_device_ms(k19, iters, "color_kernel"), 5),
                      "K19_ms": round(cuda_ms(k19), 5)}
    return out


def decode_held(paths: dict) -> str:
    """K18 and K19 of this tree held to their plain versions at each of
    DECODE_CASES (max difference 0)."""
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain

    dev = torch.device("cuda", 0)
    for label, (name, scale) in DECODE_CASES.items():
        with open(paths[name], "rb") as fh:
            batch = jpeg_dec.entropy_decode([(fh.read(), scale, None)], pinned=True)
        planes, rgb = jpeg_dec.run_kernels(batch, dev)
        tab = batch.tables
        want = plain.k18(batch.coefs.to(dev), batch.quant.to(dev), tab.segments,
                         tab.plane_bytes)
        e18 = int((planes[:tab.plane_bytes].int() - want.int()).abs().max())
        want = plain.k19(planes, tab.members, tab.out_bytes)
        e19 = int((rgb[:tab.out_bytes].int() - want.int()).abs().max())
        if e18 or e19:
            raise SystemExit(f"jpeg_breakdown: {label}: K18 {e18}, K19 {e19} levels off their "
                             "plain versions")
    return "K18 and K19 equal to their plain versions at every case"


def tile_times(sizes: list, lengths: list, iters: int) -> dict:
    """Part 7: K18's device ms at each of ``sizes`` (w, h) at 1/4 and 1/1
    with tiles of each of ``lengths`` blocks at most, in turns; 300x250 is
    the answer's JPEG, every other size a seeded 4:2:0 q90 baseline photo
    from this tree's encoder."""
    from flyimg_tpu_torch import codecs
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain
    from flyimg_tpu_torch.face_breakdown import _device_ms
    sys.path.insert(0, _ROOT)
    from chip_smoke import answer_jpeg, synthetic_image

    dev = torch.device("cuda", 0)
    out = {}
    for (w, h), scale in ((size, scale) for size in sizes for scale in (2, 8)):
        if (w, h) == (300, 250):
            if scale != 8:
                continue
            data = answer_jpeg(dev)
        else:
            data = codecs.encode(synthetic_image(w, h, seed=w + h), "jpg", quality=90,
                                 mozjpeg=False, sampling_factor="2x2", device=dev)
        label = f"{w}x{h} 1/{8 // scale}"
        batch = jpeg_dec.entropy_decode([(data, scale, None)], pinned=True)
        tab = batch.tables
        coefs, quant = batch.coefs.to(dev), batch.quant.to(dev)
        want = plain.k18(coefs, quant, tab.segments, tab.plane_bytes)
        tiles = {}
        for n in lengths:
            rows = jpeg_dec.idct_tiles(tab.segments.numpy(), n)
            tiles[n] = torch.from_numpy(rows.view(np.int32).reshape(len(rows), -1)).to(dev)
            got = jpeg_dec.idct_planes(coefs, quant, tiles[n], tab.plane_bytes)
            if not torch.equal(got[:tab.plane_bytes], want):
                raise SystemExit(f"jpeg_breakdown: {label}: K18 with {n}-block tiles differs "
                                 "from its plain version")
        times = {n: [] for n in lengths}
        for turn in (lengths, lengths[::-1]):
            for n in turn:
                times[n].append(round(_device_ms(
                    lambda: jpeg_dec.idct_planes(coefs, quant, tiles[n], tab.plane_bytes),
                    iters, "idct_kernel"), 5))
        out[label] = {"blocks": tab.blocks, "default": jpeg_dec.idct_tile_blocks(tab.blocks),
                      "device_ms": {str(n): v for n, v in times.items()}}
    return out


def k19_variant_times(paths: dict, sources: dict, iters: int) -> dict:
    """Part 8: K19 from each of ``sources`` (label -> .cu file) in turns at
    DECODE_CASES: ptxas's report and device ms."""
    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_dec_plain as plain
    from flyimg_tpu_torch.face_breakdown import _device_ms

    out_dir = os.path.join(_ROOT, "build", "jpeg_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    flags = cuda_build.SOURCES["jpeg_color"][1]
    procs = {}
    for k, (label, src) in enumerate(sources.items()):
        lib = os.path.join(out_dir, f"k19_variant_{k}.so")
        procs[label] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.BASE_FLAGS, *flags, os.path.abspath(src),
             "-o", lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs, result = {}, {"ptxas": {}, "device_ms": {}}
    for label, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"jpeg_breakdown: {label}: nvcc exit {proc.returncode}\n{log}")
        result["ptxas"][label] = next(iter(
            v for k, v in cuda_build.ptxas_report(log).items() if "color_kernel" in k), {})
        lib = ctypes.CDLL(path)
        with open(sources[label]) as fh:
            nmem = "int nmem" in fh.read()
        lib.flyimg_jpeg_color.argtypes = [p, p, i, p, i, p, p] if nmem else [p, p, p, i, p, p]
        lib.flyimg_jpeg_color.restype = i
        libs[label] = (lib, nmem)
    dev = torch.device("cuda", 0)
    for case, (name, scale) in DECODE_CASES.items():
        with open(paths[name], "rb") as fh:
            batch = jpeg_dec.entropy_decode([(fh.read(), scale, None)], pinned=True)
        tab = batch.tables
        coefs, quant, k18_tiles, mems, k19_tiles = jpeg_dec.upload(batch, dev)
        planes = jpeg_dec.idct_planes(coefs, quant, k18_tiles, tab.plane_bytes)
        want = plain.k19(planes, tab.members, tab.out_bytes)
        out = torch.empty(tab.out_bytes, dtype=torch.uint8, device=dev)

        def launch(label):
            lib, nmem = libs[label]
            extra = (int(mems.shape[0]),) if nmem else ()
            rc = lib.flyimg_jpeg_color(planes.data_ptr(), mems.data_ptr(), *extra,
                                       k19_tiles.data_ptr(), int(k19_tiles.shape[0]),
                                       out.data_ptr(), None)
            cuda_build.check(rc, f"K19 {label}")
            return out

        for label in libs:
            out.fill_(77)
            if not torch.equal(launch(label), want):
                raise SystemExit(f"jpeg_breakdown: {case}: K19 {label} differs from its plain "
                                 "version")
        times = {label: [] for label in libs}
        order = list(libs)
        for turn in (order, order[::-1]):
            for label in turn:
                times[label].append(round(_device_ms(lambda: launch(label), iters,
                                                     "color_kernel"), 5))
        result["device_ms"][case] = times
    return result


def table_times(paths: dict, iters: int = 20) -> dict:
    """Part 9: host ms of ``build_tables`` and ``pack_tables`` (pinned) for
    decode groups of 1, 16 and 32 members (median of ``iters``)."""
    from flyimg_tpu_torch.codecs import jpeg_dec

    out = {}
    for label, (name, scale) in (("4032x3024 1/4", ("photo", 2)),
                                 ("300x250 1/1", ("answer", 8))):
        with open(paths[name], "rb") as fh:
            frame = jpeg_dec.read_header(fh.read())
        plan = jpeg_dec.plan_member(frame, scale)
        blocks = jpeg_dec.coef_count(frame) // 64
        for n in (1, 16, 32):
            quant = np.zeros((4 * n, 64), np.int32)
            build, pack = [], []
            for _ in range(iters):
                t0 = time.perf_counter()
                tables = jpeg_dec.build_tables([plan] * n, [k * blocks for k in range(n)])
                t1 = time.perf_counter()
                jpeg_dec.pack_tables(quant, tables, True)
                build.append((t1 - t0) * 1e3)
                pack.append((time.perf_counter() - t1) * 1e3)
            out[f"{label} x{n}"] = {
                "build_tables_ms": round(statistics.median(build), 4),
                "pack_tables_ms": round(statistics.median(pack), 4),
                "segments": int(tables.segments.shape[0]),
                "idct_tiles": len(tables.idct_tiles), "color_tiles": len(tables.color_tiles)}
    return out


def wave_times(spec: dict, iters: int) -> dict:
    """Part 10: the wall seconds of ``spec["requests"]`` ((options, file)
    pairs) served concurrently by a fresh server of the package on the path
    at each of ``spec["deadlines"]`` (codec deadline ms, None the default),
    ``iters`` waves each after one untimed wave."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread

    dev = torch.device("cuda", 0)
    cuda_build.build()
    cuda_build.build_host()
    requests = [tuple(r) for r in spec["requests"]]
    with tempfile.TemporaryDirectory(dir=spec["tmp"]) as tmp:

        def wave(tag, deadline):
            settings = {"upload_dir": os.path.join(tmp, tag, "uploads"),
                        "tmp_dir": os.path.join(tmp, tag, "tmp"), "resample_kernel": "banded"}
            if deadline is not None:
                settings["decode_deadline_ms"] = deadline
            server = make_server(AppParameters(settings), device=dev)
            thread = serve_in_thread(server)
            base = f"http://127.0.0.1:{server.server_address[1]}"

            def get(req):
                with urllib.request.urlopen(f"{base}/upload/{req[0]}/{req[1]}",
                                            timeout=300) as resp:
                    resp.read()
                    return resp.status

            try:
                t0 = time.perf_counter()
                with ThreadPoolExecutor(len(requests)) as pool:
                    statuses = list(pool.map(get, requests))
                wall = time.perf_counter() - t0
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            if statuses != [200] * len(requests):
                raise SystemExit(f"jpeg_breakdown: wave answered {statuses}")
            return round(wall, 4)

        wave("warm", None)
        return {(f"deadline {d} ms" if d is not None else "default deadline"):
                [wave(f"{d}-{k}", d) for k in range(iters)]
                for d in spec["deadlines"]}


def in_turns(parent: str, fn: str, arg: str, iters: int) -> list:
    """``fn(arg, iters)`` of this file run in the parent's tree and this
    one's, in turns (parent, this, this, parent), each in a process of its
    own (the tree's root first on the path)."""
    runs = []
    child = (f"import json, runpy; m = runpy.run_path({__file__!r}); "
             f"print(json.dumps(m[{fn!r}]({arg}, {iters})))")
    for tree in (parent, _ROOT, _ROOT, parent):
        proc = subprocess.run([sys.executable, "-c", child], capture_output=True, text=True,
                              cwd=os.path.abspath(tree), timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"jpeg_breakdown: {tree}: {proc.stderr[-2000:]}")
        runs.append({"tree": "parent" if tree == parent else "this",
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
    return runs


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
    ap.add_argument("--part", default="all",
                    help="comma-separated: all, encode, decode, tiles, k19, tables, wave")
    ap.add_argument("--k19-sources", default="",
                    help="part k19: LABEL=FILE,... K19 sources to time in turns")
    ap.add_argument("--tile-lengths", default="16,32,64")
    ap.add_argument("--tile-sizes",
                    default="300x250,640x480,1024x768,1440x1080,1920x1080,2048x1536,4032x3024")
    args = ap.parse_args()
    parts = set(args.part.split(","))
    if "all" in parts:
        parts |= {"encode", "decode"}
    unknown = parts - {"all", "encode", "decode", "tiles", "k19", "tables", "wave"}
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("jpeg_breakdown: no CUDA card", file=sys.stderr)
        return 1
    result = {"card": card_line()}
    if "encode" in parts:
        result.update(encode_part(args))
    if parts & {"decode", "tiles", "k19", "tables", "wave"}:
        build_root = os.path.join(_ROOT, "build")
        os.makedirs(build_root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_root) as tmp:
            paths = decode_files(tmp)
            if "decode" in parts:
                result["decode_held"] = decode_held(paths)
                if args.parent:
                    result["decode_turns"] = in_turns(args.parent, "decode_times",
                                                      repr(paths), args.iters)
                else:
                    result["decode"] = decode_times(paths, args.iters)
            if "tiles" in parts:
                lengths = [int(n) for n in args.tile_lengths.split(",")]
                sizes = [tuple(int(v) for v in wh.split("x")) for wh in args.tile_sizes.split(",")]
                result["tile_lengths"] = tile_times(sizes, lengths, args.iters)
            if "k19" in parts:
                sources = dict(kv.split("=", 1) for kv in args.k19_sources.split(",") if kv)
                result["k19_variants"] = k19_variant_times(paths, sources, args.iters)
            if "tables" in parts:
                result["tables"] = table_times(paths)
            if "wave" in parts:
                from chip_smoke import DECODE_WAVE, DECODE_WAVE_DEADLINE_MS

                spec = {"requests": [(o, paths[k]) for k in ("photo", "progressive")
                                     for o in DECODE_WAVE],
                        "deadlines": [DECODE_WAVE_DEADLINE_MS, None], "tmp": build_root}
                if args.parent:
                    result["wave_turns"] = in_turns(args.parent, "wave_times", repr(spec),
                                                    args.iters)
                else:
                    result["wave"] = wave_times(spec, args.iters)
    print(json.dumps(result))
    return 0


def encode_part(args) -> dict:
    """Parts 1-5."""
    from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables
    from flyimg_tpu_torch.face_breakdown import _device_ms

    if args.sass:
        write_sass(args.sass)
    lanes = [int(n) for n in args.lanes.split(",")]
    built = build(os.path.join(_ROOT, "build", "jpeg_breakdown"), lanes)
    result = {"ptxas": {k: v[1] for k, v in built.items()}}
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
            arg = f"(lambda d: {{k: d[k] for k in d.files}})(__import__('numpy').load({npz!r}))"
            result["turns"] = in_turns(args.parent, "wrapper_times", arg, args.iters)
    return result


if __name__ == "__main__":
    sys.exit(main())
