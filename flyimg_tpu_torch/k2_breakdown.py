"""Where kernel K2's time goes on the card, by cutting its parts out.

    python3 -m flyimg_tpu_torch.k2_breakdown [--bursts 5] [--tile-heights 2,4,8]

Builds copies of ``csrc/saliency.cu`` under ``build/k2_breakdown/`` with one
part cut out by a ``-DK2_CUT_*`` flag (the skin path, the skin levels of
the pre-test's candidates, the saturation lookup, the store, the whole
per-pixel computation, the luma pass, every tile) and times each in bursts
of 20 launches between CUDA events (median of ``--bursts``), twice in
turns, on two inputs of the flagship shape
[256, 250, 300, 3]: the entry's resampled batch and a skin-toned coherent
batch (where nearly every pixel needs its skin level). A cut copy
computes garbage; only its time means anything. The difference between the
whole kernel and a copy is what the cut part costs, as far as the parts do
not overlap. ``--tile-heights`` also times the whole kernel with each
given tile height in place of the host plan's. Also counts the whole
kernel's SASS instructions by opcode (``cuobjdump -sass``). Prints one JSON
line with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.entry import OUT_HW, entry
from flyimg_tpu_torch.models.smartcrop import (
    _k2_tables,
    _batched_weighted,
    k2_plan,
    k2_thresholds,
)
from flyimg_tpu_torch.ops.resample import set_kernel_mode

#: copy name -> the -D flags that cut its part out
CUTS = {
    "whole": (),
    "no skin": ("-DK2_CUT_SKIN",),
    "skin pre-test only": ("-DK2_CUT_SKIN_EVAL",),
    "no saturation": ("-DK2_CUT_SAT",),
    "no skin, no saturation": ("-DK2_CUT_SKIN", "-DK2_CUT_SAT"),
    "no store": ("-DK2_CUT_STORE",),
    "no per-pixel compute": ("-DK2_CUT_COMPUTE",),
    "staging and zero stores": ("-DK2_CUT_COMPUTE", "-DK2_CUT_LUMA"),
    "tables only": ("-DK2_CUT_TILES",),
}


def skin_toned_batch(b: int, h: int, w: int, device, seed: int) -> torch.Tensor:
    """[b, h, w, 3] u8, coherent and skin-toned: smooth waves around
    (200, 146, 112), so nearly every pixel takes K2's exact skin path."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    ph = torch.rand((b, 3, 1, 1), generator=gen).to(device) * 6.0
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    base = torch.tensor([200.0, 146.0, 112.0], device=device)[None, :, None, None]
    wave = 18.0 * torch.sin(0.031 * yy + 0.017 * xx + ph)
    img = (base + wave).clamp(0, 255).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous()


def build(out_dir: str) -> dict:
    src = os.path.join(cuda_build.CSRC_DIR, "saliency.cu")
    _, flags = cuda_build.SOURCES["saliency"]
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, cuts) in enumerate(CUTS.items()):
        lib = os.path.join(out_dir, f"k2_{i}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.BASE_FLAGS, *flags, *cuts,
             "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"k2_breakdown: nvcc failed for {name!r}:\n{log}")
        libs[name] = (ctypes.CDLL(lib), lib)
        fn = libs[name][0].flyimg_saliency_field
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def sass_counts(lib_path: str) -> dict:
    """Opcode counts of the kernel's SASS, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)", text)
    )
    return {"total": sum(ops.values()), "by_opcode": dict(ops.most_common(25))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flyimg_tpu_torch.k2_breakdown")
    parser.add_argument("--bursts", type=int, default=5)
    parser.add_argument("--tile-heights", default="")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    libs = build(os.path.join(root, "build", "k2_breakdown"))

    set_kernel_mode("banded")
    fn, fargs = entry(device=dev, batch=256)
    resampled, _ = fn(*fargs)
    set_kernel_mode("dense")
    b, h, w, _ = resampled.shape
    skin = skin_toned_batch(b, h, w, dev, seed=3)
    inputs = {"flagship": resampled.contiguous(), "skin-toned": skin}
    valid = torch.tensor(OUT_HW, dtype=torch.float32, device=dev).repeat(b, 1)
    plan = k2_plan(b, h, w)
    thresholds = k2_thresholds()
    tables = _k2_tables(dev)
    out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, images, plan=plan):
        rc = lib.flyimg_saliency_field(
            images.data_ptr(), tables.data_ptr(), valid.data_ptr(), out.data_ptr(),
            b, h, w, plan.tile_h, plan.chunk_w, plan.stage_pitch, plan.luma_pitch,
            plan.smem_bytes, plan.blocks, *thresholds, stream)
        cuda_build.check(rc, "k2_breakdown")

    whole_ok = {}
    for label, images in inputs.items():
        launch(libs["whole"][0], images)
        whole_ok[label] = bool(torch.equal(out, _batched_weighted(images, valid)))

    def burst_ms(lib, images, plan=plan, n=20):
        launch(lib, images, plan)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.bursts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                launch(lib, images, plan)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        return statistics.median(times)

    ms = {label: {name: [] for name in libs} for label in inputs}
    for _ in range(2):
        for label, images in inputs.items():
            for name, (lib, _path) in libs.items():
                ms[label][name].append(burst_ms(lib, images))
    sweep = {}
    for th in (int(v) for v in args.tile_heights.split(",") if v):
        alt = k2_plan(b, h, w, tile_h=th)
        sweep[th] = {label: [burst_ms(libs["whole"][0], images, alt) for _ in range(2)]
                     for label, images in inputs.items()}
    print(json.dumps({"card": card, "plan": plan.__dict__, "whole_exact": whole_ok,
                      "sass": sass_counts(libs["whole"][1]), "ms": ms,
                      "tile_height_ms": sweep}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
