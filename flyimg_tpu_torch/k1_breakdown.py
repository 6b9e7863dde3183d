"""Where kernel K1's time goes on the card, by cutting its parts out.

    python3 -m flyimg_tpu_torch.k1_breakdown [--bursts 5]

Builds copies of ``csrc/resample_banded.cu`` under ``build/k1_breakdown/``
with one part of the tile kernel cut out (the vertical pass's row loop, the
horizontal pass, the u8 store, every tile, or the tile kernel launch), and
times each at the flagship shape (256 x 512x512x3 u8 -> 300x250, K = 16,
the host plan) in bursts of 20 launches between CUDA events (median of
``--bursts``), twice in turns. A cut copy computes garbage; only its time
means anything. The difference between the whole kernel and a copy is what
the cut part costs, as far as the parts do not overlap. Prints one JSON
line with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.entry import OUT_HW, entry, flagship_band
from flyimg_tpu_torch.ops.resample import (
    _METHOD_CODES,
    _geometry,
    k1_plan,
    set_kernel_mode,
)

_V = "for (int r = max(r0, ra); r < e; ++r) {"
_H = "for (int o = tid; o < tn * nxn; o += K1_THREADS) {"
_S = "for (int i = tid; i < tn * nwr; i += K1_THREADS) {"
_TILES = "const int rt_end = min(n_rt, rt0 + tiles_per_block);"
_LAUNCH = "kern<<<grid, K1_THREADS, smem, s>>>("

#: copy name -> (text cut, what replaces it)
CUTS = {
    "whole": (),
    "no vertical": ((_V, "for (int r = max(r0, ra); r < min(e, -1); ++r) {"),),
    "no horizontal": ((_H, "for (int o = tid; o < 0; o += K1_THREADS) {"),),
    "no passes": ((_V, "for (int r = max(r0, ra); r < min(e, -1); ++r) {"),
                  (_H, "for (int o = tid; o < 0; o += K1_THREADS) {")),
    "no passes, no store": (
        (_V, "for (int r = max(r0, ra); r < min(e, -1); ++r) {"),
        (_H, "for (int o = tid; o < 0; o += K1_THREADS) {"),
        (_S, "for (int i = tid; i < 0; i += K1_THREADS) {")),
    "block set-up only": ((_TILES, "const int rt_end = rt0;"),),
    "weight kernels only": ((_LAUNCH, "if (0) " + _LAUNCH),),
}


def build(out_dir: str) -> dict:
    with open(os.path.join(cuda_build.CSRC_DIR, "resample_banded.cu")) as fh:
        src = fh.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, cuts) in enumerate(CUTS.items()):
        text = src
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"k1_breakdown: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"k1_{i}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = path[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.BASE_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k1_breakdown: nvcc failed for {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
        fn = libs[name].flyimg_resample_banded
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flyimg_tpu_torch.k1_breakdown")
    parser.add_argument("--bursts", type=int, default=5)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    libs = build(os.path.join(root, "build", "k1_breakdown"))

    set_kernel_mode("banded")
    _fn, (images, in_true, span_y, span_x, out_true) = entry(device=dev, batch=256)
    ky, kx = flagship_band()
    set_kernel_mode("dense")
    b, in_h, in_w, _ = images.shape
    out_h, out_w = OUT_HW
    plan = k1_plan((in_h, in_w), OUT_HW, (ky, kx), b)
    geom = _geometry(span_y, span_x, out_true, in_true)
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.uint8, device=dev)
    wy = torch.empty((b, out_h, ky), dtype=torch.float32, device=dev)
    jy = torch.empty((b, out_h), dtype=torch.int32, device=dev)
    wx = torch.empty((b, out_w, kx), dtype=torch.float32, device=dev)
    jx = torch.empty((b, out_w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        rc = lib.flyimg_resample_banded(
            images.data_ptr(), out.data_ptr(), None, geom.data_ptr(), None, wy.data_ptr(),
            jy.data_ptr(), wx.data_ptr(), jx.data_ptr(), b, in_h, in_w, out_h,
            out_w, ky, kx, _METHOD_CODES["lanczos3"], plan.tile_h, plan.tile_w,
            plan.chunk_w, plan.row_chunk, int(plan.stage_wx), int(plan.stage_wy),
            plan.kx_static, plan.tiles_per_block, plan.smem_bytes, stream)
        cuda_build.check(rc, "k1_breakdown")

    def burst_ms(lib, n=20):
        launch(lib)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.bursts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                launch(lib)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        return statistics.median(times)

    ms = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            ms[name].append(burst_ms(lib))
    print(json.dumps({"card": card, "plan": plan.__dict__, "ms": ms}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
