"""The PyTorch package's offline bulk runner (``flyimg_tpu_torch/bulk.py``)
against the JAX package's (``flyimg_tpu/bulk.py``), on the CPU.

The counterparts of ``tests/test_bulk.py``'s five tests run the port's
``bulk_process`` and ``main`` with ``device="cpu"`` (the kernels' plain
versions), and the same directory goes through both packages' runners.

Bounds, each stated where it is checked:
- the two runners' outputs (``--format png``): the same file names, equal
  ``images`` and ``failed``, decoded pixels within 1 u8 level (the port's
  program against the JAX package's XLA program: sums in other orders);
- the port's bulk bytes against its own ``ImageHandler.transform_bytes``
  for the same options: equal bytes (one code path).
"""

import io
import json
import os
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.bulk import bulk_process as jbulk_process
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.bulk import bulk_process, main
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.service.output_image import OutputSpec
from flyimg_tpu_torch.spec.options import OptionsBag

torch.set_num_threads(2)

#: the two packages' PNG outputs, u8 levels
PIXEL_TOL = 1


def _make_dir(tmp_path, n=6):
    """``tests/test_bulk.py``'s directory: seeded noise PNGs of three
    heights."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(
            rng.integers(0, 255, (200 + 10 * (i % 3), 300, 3), dtype=np.uint8)
        ).save(src / f"img{i}.png")
    return src


def test_bulk_process_directory(tmp_path):
    src = _make_dir(tmp_path)
    out = tmp_path / "out"
    summary = bulk_process(str(src), str(out), "w_100,h_80,c_1", out_format="jpg",
                           workers=4, device="cpu")
    assert summary["images"] == 6 and summary["failed"] == 0
    outs = sorted(os.listdir(out))
    assert outs == [f"img{i}.jpg" for i in range(6)]
    for name in outs:
        assert Image.open(out / name).size == (100, 80)
    # same-geometry files shared batched launches
    assert summary["batches"] <= summary["images"]


def test_bulk_cli_and_bad_file(tmp_path, capsys):
    src = _make_dir(tmp_path, n=3)
    (src / "broken.jpg").write_bytes(b"not an image")
    out = tmp_path / "o2"
    rc = main(["--src", str(src), "--out", str(out), "--options", "w_50",
               "--format", "png", "--workers", "2", "--device", "cpu"])
    assert rc == 1  # the broken file is reported as failed
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["images"] == 3 and summary["failed"] == 1
    assert sorted(os.listdir(out)) == [f"img{i}.png" for i in range(3)]


def test_bulk_matches_serving_transform_for_post_pass_options(tmp_path):
    """Bulk runs ``ImageHandler.transform_bytes``, serving's pipeline, so a
    post-pass option (smart-crop) gives the bytes serving gives."""
    src = _make_dir(tmp_path, n=1)
    out = tmp_path / "out"
    opts = "w_120,h_90,c_1,smc_1"
    summary = bulk_process(str(src), str(out), opts, out_format="jpg", workers=1,
                           device="cpu")
    assert summary["failed"] == 0
    handler = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "store")}),
                           device="cpu")
    spec = OutputSpec(name="x.jpg", extension="jpg", mime="image/jpeg")
    serve_bytes = handler.transform_bytes((src / "img0.png").read_bytes(),
                                          OptionsBag(opts), spec)
    assert (out / "img0.jpg").read_bytes() == serve_bytes


def test_bulk_retries_transient_timeouts_once(tmp_path, monkeypatch):
    """A device wait that expired gets ONE sequential retry; a lasting one
    still counts as failed (``concurrent.futures.TimeoutError``, what
    ``Future.result(timeout=)`` raises)."""
    src = _make_dir(tmp_path, n=3)
    out = tmp_path / "out"
    real = ImageHandler.transform_bytes
    calls: dict = {}

    def flaky(self, data, options, spec):
        n = calls[spec.name] = calls.get(spec.name, 0) + 1
        if (spec.name == "img0.png" and n == 1) or spec.name == "img2.png":
            raise FuturesTimeout("injected device wait expiry")
        return real(self, data, options, spec)

    monkeypatch.setattr(ImageHandler, "transform_bytes", flaky)
    summary = bulk_process(str(src), str(out), "w_50", out_format="png", workers=2,
                           device="cpu")
    assert summary["failed"] == 1  # img2: timed out on retry too
    assert summary["images"] == 2
    assert sorted(os.listdir(out)) == ["img0.png", "img1.png"]
    assert calls["img0.png"] == 2  # flaked once, recovered on retry
    assert calls["img2.png"] == 2  # exactly one retry, no loops


def test_bulk_skips_retry_pass_when_every_job_times_out(tmp_path, monkeypatch):
    """Every file timed out: the device is down, so no retry pass runs."""
    src = _make_dir(tmp_path, n=3)
    out = tmp_path / "out"
    calls: dict = {}

    def dead(self, data, options, spec):
        calls[spec.name] = calls.get(spec.name, 0) + 1
        raise FuturesTimeout("device down")

    monkeypatch.setattr(ImageHandler, "transform_bytes", dead)
    summary = bulk_process(str(src), str(out), "w_50", out_format="png", workers=2,
                           device="cpu")
    assert summary["failed"] == 3 and summary["images"] == 0
    assert all(n == 1 for n in calls.values())  # no retry pass ran


@pytest.mark.parametrize("opts", ["w_100,h_80,c_1", "w_120,h_90,c_1,smc_1", "w_64,q_70"])
def test_bulk_matches_jax_bulk(tmp_path, opts):
    """One directory (with a broken file) through both packages' runners
    with ``--format png``: the same names, ``images`` and ``failed``, and
    pixels within PIXEL_TOL."""
    src = _make_dir(tmp_path, n=4)
    (src / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnot really")
    ours = bulk_process(str(src), str(tmp_path / "ours"), opts, out_format="png",
                        workers=2, device="cpu")
    theirs = jbulk_process(str(src), str(tmp_path / "theirs"), opts, out_format="png",
                           workers=2)
    assert ours["images"] == theirs["images"] == 4
    assert ours["failed"] == theirs["failed"] == 1
    assert set(ours) == set(theirs)
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    assert names == [f"img{i}.png" for i in range(4)]
    for name in names:
        a = np.asarray(Image.open(io.BytesIO((tmp_path / "ours" / name).read_bytes())))
        b = np.asarray(Image.open(io.BytesIO((tmp_path / "theirs" / name).read_bytes())))
        assert a.shape == b.shape, name
        assert np.abs(a.astype(int) - b.astype(int)).max() <= PIXEL_TOL, name


def test_bulk_needs_cuda_unless_cpu_is_asked(tmp_path):
    """The default device is the card: without one the runner raises before
    it makes anything, and ``--device cpu`` is the way to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    src = _make_dir(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bulk_process(str(src), str(tmp_path / "out"), "w_50")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--src", str(src), "--out", str(tmp_path / "out"), "--options", "w_50"])
    assert not (tmp_path / "out").exists()
