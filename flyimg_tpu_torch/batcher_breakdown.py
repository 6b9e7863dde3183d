"""Where a batcher launch's time goes on the card, and what the in-flight
window does with it.

    python3 -m flyimg_tpu_torch.batcher_breakdown [--waves 6]

Transform-only flagship waves (64 seeded 1024x768 frames submitted at once,
``w_300,h_250,c_1,smc_1``, banded) through ``runtime/batcher.py`` at
``pipeline_depth`` 1 and 2 in turns, with launches of 8 and of 32. One JSON
line a wave, with the card's name and power limit: the wave's wall time,
the launches in flight at its peak, and the medians over its launches of
the host assembly (``_prepare``: staging the members in pinned memory),
the host enqueue (``_launch``: copy up, program, copy back) and the card's
time for the launch (CUDA events on the controller's stream around the
enqueue). Then 16 concurrent flagship requests through the server at depth
1 and 2 (seeded PNG sources): wall time, launches in flight at the peak,
launch sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import time

import numpy as np
import torch

from flyimg_tpu_torch.face_breakdown import card_line
from flyimg_tpu_torch.runtime.batcher import BatchController

FLAGSHIP = "w_300,h_250,c_1,smc_1"


def frames(n: int = 64, w: int = 1024, h: int = 768):
    """``n`` seeded smooth frames with noise and a sharp block (8 made,
    the rest shifted copies)."""
    bases = []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for seed in range(8):
        rng = np.random.default_rng(600 + seed)
        img = np.stack([120 + 70 * np.sin(yy / rng.uniform(40, 90) + xx / rng.uniform(50, 120) + c)
                        for c in range(3)], -1)
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        img[y0:y0 + h // 5, x0:x0 + w // 5] = rng.uniform(0, 255, 3)
        bases.append(np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8))
    return [np.roll(bases[i % 8], 97 * (i // 8), axis=(0, 1)) for i in range(n)]


class TimedController(BatchController):
    """A BatchController that records each transform launch's host assembly,
    host enqueue and device time (ms)."""

    def __init__(self, **kw) -> None:
        self.times = {"assemble": [], "enqueue": [], "device": []}
        super().__init__(**kw)

    def _prepare(self, group, members):
        t0 = time.perf_counter()
        out = super()._prepare(group, members)
        self.times["assemble"].append((time.perf_counter() - t0) * 1e3)
        return out

    def _launch(self, fn, images, geo, measure_peak, seq):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record(self._stream)
        t0 = time.perf_counter()
        launch = super()._launch(fn, images, geo, measure_peak, seq)
        self.times["enqueue"].append((time.perf_counter() - t0) * 1e3)
        end.record(self._stream)
        launch.events = (start, end)
        return launch

    def _read_back(self, launch):
        host = BatchController._read_back(launch)
        start, end = launch.events
        self.times["device"].append(start.elapsed_time(end))
        return host


def wave(dev, members, depth: int, batch: int) -> dict:
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    h, w = members[0].shape[:2]
    plan = build_plan(OptionsBag(FLAGSHIP), w, h)
    ctl = TimedController(device=dev, max_batch=batch, deadline_ms=60_000.0,
                          lone_flush=False, pipeline_depth=depth)
    try:
        t0 = time.perf_counter()
        for fut in [ctl.submit(m, plan) for m in members]:
            fut.result(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        ctl.close()
    return {"depth": depth, "batch": batch, "wall_ms": round(wall * 1e3, 3),
            "inflight_peak": ctl.inflight_peak,
            **{f"{k}_ms": round(statistics.median(v), 4) for k, v in ctl.times.items()}}


def server_wave(dev, members, depth: int, workdir: str) -> dict:
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread

    server = make_server(AppParameters({
        "upload_dir": os.path.join(workdir, f"u{depth}_{time.monotonic_ns()}"),
        "tmp_dir": os.path.join(workdir, "t"), "resample_kernel": "banded",
        "batch_pipeline_depth": depth,
    }), device=dev)
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}/upload/{FLAGSHIP}/"
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(members)) as pool:
            list(pool.map(lambda p: urllib.request.urlopen(base + p, timeout=300).read(),
                          members))
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {"server_depth": depth, "requests": len(members), "wall_ms": round(wall * 1e3, 3),
            "inflight_peak": server.batcher.inflight_peak,
            "launches": [n for k, n, _b in server.batcher.launch_log if k == "transform"]}


def main(argv=None) -> int:
    from flyimg_tpu_torch import cuda_build
    from flyimg_tpu_torch.codecs import png
    from flyimg_tpu_torch.device import resolve_device
    from flyimg_tpu_torch.ops.resample import set_kernel_mode

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--waves", type=int, default=6)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("batcher_breakdown needs a CUDA card")
    dev = torch.device("cuda", 0)
    resolve_device(dev)
    cuda_build.build()
    set_kernel_mode("banded")
    card = card_line()
    members = frames()
    for batch in (8, 32):
        wave(dev, members, 2, batch)         # the kernels' first launches
        for k in range(args.waves):
            for depth in ((1, 2) if k % 2 == 0 else (2, 1)):
                print(json.dumps({**wave(dev, members, depth, batch), "card": card}))
    workdir = os.path.join(os.path.dirname(cuda_build.build_dir()), "batcher_breakdown")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        paths = []
        for i, frame in enumerate(members[:16]):
            paths.append(os.path.join(workdir, f"s{i}.png"))
            with open(paths[-1], "wb") as fh:
                fh.write(png.encode(frame))
        for depth in (1, 2, 2, 1):
            print(json.dumps({**server_wave(dev, paths, depth, workdir), "card": card}))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
