"""Offline bulk runner: a directory of images through the batch runtime.

The port of ``flyimg_tpu/bulk.py``. The serving path answers one HTTP
request at a time; the firehose workloads (a thousand photos resized, 4K
sources to 256 px thumbnails) are offline sweeps. This runner feeds every
image of a directory through the handler's own transform pipeline
(``ImageHandler.transform_bytes``): the decode, one device
``BatchController`` grouping frames into batched launches, one codec
controller batching the JPEG decodes and encodes, the post-passes
(smart-crop, faces, the alpha flatten, the st_0 metadata graft) and the
encode, and writes each output under its source's file name. Bulk and
serving share that one path, so the same options string gives the same
bytes in both.

Usage:
    python -m flyimg_tpu_torch.bulk --src photos/ --out thumbs/ \\
        --options w_256,h_256,c_1 [--format jpg] [--workers 8] \\
        [--quality Q] [--device cuda]

Prints one JSON line: {images, failed, images_per_sec, batches,
mean_occupancy, padding_waste, queue_wait_share}, and exits 1 when any file
failed. The controllers run on ``--device`` (``cuda`` by default, which
raises without a card; ``cpu`` runs the kernels' plain versions). Library
surface: ``bulk_process()``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Dict, Optional, Union

import torch

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp", ".gif")


def bulk_process(
    src_dir: str,
    out_dir: str,
    options_str: str,
    *,
    out_format: str = "jpg",
    workers: int = 8,
    batcher=None,
    quality: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, float]:
    """Transform every image under ``src_dir`` (not recursive) with the URL
    options ``options_str``; outputs land in ``out_dir`` as
    ``<stem>.<out_format>``. Returns the summary dict the CLI prints.

    ``workers`` threads read and transform files; every frame goes to ONE
    device controller and every JPEG decode and encode to one codec
    controller (serving's split), both on ``device``, so concurrent files
    with one post-decode geometry share launches.

    ``out_format`` governs the container (there is no Accept header to
    negotiate against); an ``o_`` key in ``options_str`` is ignored.
    ``quality`` sets the encode quality unless the options carry ``q_``.
    A file whose transform timed out is tried once more, alone, after the
    pass, unless every file timed out (the device is down: retrying would
    only wait again)."""
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.device import resolve_device
    from flyimg_tpu_torch.ops.resample import set_kernel_mode
    from flyimg_tpu_torch.runtime.batcher import BatchController, containment_params
    from flyimg_tpu_torch.service.handler import ImageHandler
    from flyimg_tpu_torch.service.output_image import EXT_TO_MIME, OutputSpec
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.storage import make_storage

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(n for n in os.listdir(src_dir) if n.lower().endswith(IMAGE_EXTENSIONS))
    params = AppParameters()
    own_batcher = batcher is None
    # the resample kernel the configuration names, as serving selects it
    set_kernel_mode(str(params.by_key("resample_kernel", "dense")))
    # serving's batching and containment parameters (service/app.py)
    containment = containment_params(params)
    if own_batcher:
        batcher = BatchController(
            max_batch=int(params.by_key("batch_max_size", 64)),
            deadline_ms=float(params.by_key("batch_deadline_ms", 4.0)),
            device=dev, **containment,
        )
    # the codec work on its own controller, so JPEG groups do not queue
    # behind transform launches
    codec_batcher = BatchController(
        max_batch=int(params.by_key("decode_batch_max", 32)),
        deadline_ms=float(params.by_key("decode_deadline_ms", 1.0)),
        device=dev, **containment,
    )
    handler = ImageHandler(
        params, device=dev, batcher=batcher, codec_batcher=codec_batcher,
        # transform_bytes never reads or writes the store; rooted at the
        # output directory, which exists already, it makes nothing
        storage=make_storage(AppParameters({**params.as_dict(), "upload_dir": out_dir})),
    )

    # serving's OptionsBag configuration (service/handler.py): an operator's
    # options_keys, default_options and separator mean the same here
    options_keys = params.by_key("options_keys")
    default_options = params.by_key("default_options")
    separator = params.by_key("options_separator", ",")

    ext = "jpg" if out_format in ("jpg", "jpeg") else out_format
    explicit_quality = any(seg.startswith("q_") for seg in options_str.split(separator))
    failed = 0
    t0 = time.perf_counter()

    def run_one(name: str) -> None:
        with open(os.path.join(src_dir, name), "rb") as fh:
            data = fh.read()
        # a fresh bag a file: plan building and the transform read options
        # on several threads, and some accessors write
        options = OptionsBag(options_str, options_keys=options_keys,
                             default_options=default_options, separator=separator)
        if quality is not None and not explicit_quality:
            options.set_option("quality", int(quality))
        stem = os.path.splitext(name)[0]
        spec = OutputSpec(name=f"{stem}.{ext}", extension=ext, mime=EXT_TO_MIME[ext])
        content = handler.transform_bytes(data, options, spec)
        dst = os.path.join(out_dir, f"{stem}.{ext}")
        tmp = dst + ".part"
        with open(tmp, "wb") as fh:
            fh.write(content)
        os.replace(tmp, dst)

    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = {pool.submit(run_one, n): n for n in names}
            retry: list = []
            for fut, name in futures.items():
                try:
                    fut.result()
                except (TimeoutError, FuturesTimeout):
                    # a device wait that expired: one more try, alone, after
                    # the pass (FuturesTimeout is what Future.result(timeout=)
                    # raises)
                    retry.append(name)
                except Exception as exc:
                    failed += 1
                    print(f"# {name}: {type(exc).__name__}: {exc}", file=sys.stderr)
            if retry and len(retry) == len(names):
                failed += len(retry)
                print(f"# all {len(retry)} jobs timed out; device down — "
                      "skipping retry pass", file=sys.stderr)
                retry = []
            for name in retry:
                try:
                    run_one(name)
                except Exception as exc:
                    failed += 1
                    print(f"# {name} (retry): {type(exc).__name__}: {exc}",
                          file=sys.stderr)
        elapsed = time.perf_counter() - t0
        stats = batcher.stats()
    finally:
        codec_batcher.close()
        if own_batcher:
            batcher.close()

    done = len(names) - failed
    return {
        "images": done,
        "failed": failed,
        "images_per_sec": round(done / elapsed, 1) if elapsed > 0 else 0.0,
        "batches": stats["batches"],
        "mean_occupancy": round(stats["mean_occupancy"], 2),
        # the rolling window /debug/perf serves, over this sweep's launches
        "padding_waste": round(stats["padding_waste"], 2),
        "queue_wait_share": round(stats["queue_wait_share"], 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flyimg-tpu-torch-bulk", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", required=True, help="source image directory")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--options", required=True,
                    help="URL options, e.g. w_256,h_256,c_1")
    ap.add_argument("--format", default="jpg", choices=("jpg", "png", "webp", "gif"))
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--quality", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ns = ap.parse_args(argv)
    summary = bulk_process(
        ns.src, ns.out, ns.options, out_format=ns.format, workers=ns.workers,
        quality=ns.quality, device=ns.device,
    )
    print(json.dumps(summary))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
