"""The port's video ingestion (``flyimg_tpu_torch/codecs/video.py``,
``service/input_source.py``) held against the JAX package's on the CPU.

A video source is swapped for its frame at ``tm_``: OpenCV where it
imports, ffmpeg where it is on the PATH, 415 where neither is.
The JAX ``ImageHandler`` (its native JPEG decode built as
``tests/jax_fastcodec.py`` builds it) and the port's
``ImageHandler(device="cpu")`` answer the same requests: the cached frame
under the same name with the same bytes (OpenCV writes both), the answer's
type and size and its pixels within PERF.md section 2's bound, and the same
exception class where the JAX handler fails. Videos are written by
``cv2.VideoWriter`` from seeded numpy frames.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from jax_fastcodec import fastcodec, use_in_jax  # noqa: F401 (fixture)
from flyimg_tpu.codecs import video as jax_video
from flyimg_tpu_torch.codecs import video as port_video

cv2 = pytest.importorskip("cv2")


def _write_video(path, seconds=3, fps=10, size=(96, 64), seed=41):
    """Frames whose content changes every tenth of a second: a seeded
    colour field shifted by the frame's index."""
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert writer.isOpened()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (size[1], size[0], 3)).astype(np.int64)
    yy, xx = np.mgrid[0:size[1], 0:size[0]]
    for i in range(seconds * fps):
        frame = (base + 8 * i + ((xx * 2 + yy) // 3)[..., None]) % 256
        writer.write(frame.astype(np.uint8))
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return _write_video(tmp_path_factory.mktemp("video") / "clip.mp4")


@pytest.mark.parametrize("spec", ["0", "1", "2.25", "00:00:01", "00:00:01.5", "01:02:03",
                                  " 7 ", "1:2", "-4", "nan", "inf", "1::2", "", "abc",
                                  "1:2:3:4", "00:00:-1"])
def test_time_spec_answers_as_the_jax_package(spec):
    from flyimg_tpu_torch.exceptions import ExecFailedException

    try:
        want = jax_video._time_spec_ms(spec)
    except Exception as exc:  # noqa: BLE001 - compared below
        assert type(exc).__name__ == "ExecFailedException"
        with pytest.raises(ExecFailedException, match="bad time spec"):
            port_video._time_spec_ms(spec)
        return
    assert port_video._time_spec_ms(spec) == want


def _handlers(tmp_path):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage
    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.service.handler import ImageHandler

    params = AppParameters({"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t")})
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"),
                              "tmp_dir": str(tmp_path / "jt")})
    return ImageHandler(params, device="cpu"), JImageHandler(make_storage(jparams), jparams)


def _outcome(fn, *args):
    try:
        return fn(*args), None
    except Exception as exc:  # noqa: BLE001 - compared by the caller
        return None, exc


def _pixels(content: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB")).astype(np.int64)


@pytest.mark.parametrize("opts", ["o_png", "tm_0,o_png", "tm_1.5,o_png", "tm_00:00:02,o_png",
                                  "tm_2,w_300,h_250,c_1", "tm_1,w_40,o_png", "tm_9,o_png",
                                  "tm_abc,o_png"])
def test_handler_video_answers_match_the_jax_handler(clip, tmp_path, monkeypatch,
                                                     fastcodec, opts):  # noqa: F811
    """``/upload/{opts}/{video}``: the frame cached as
    ``<original>-<time>.jpg`` with the same bytes, the same answer type
    and size, o_png's pixels within the bound, and a time past the end or
    malformed the same exception class (ExecFailedException)."""
    use_in_jax(monkeypatch, fastcodec)
    handler, jhandler = _handlers(tmp_path)
    want, jerr = _outcome(jhandler.process_image, opts, clip)
    got, perr = _outcome(handler.process_image, opts, clip)
    if jerr is not None:
        assert perr is not None and type(perr).__name__ == type(jerr).__name__, (jerr, perr)
        return
    assert perr is None, perr
    assert Image.open(io.BytesIO(got.content)).format == \
        Image.open(io.BytesIO(want.content)).format
    a, b = _pixels(got.content), _pixels(want.content)
    assert a.shape == b.shape
    if "o_png" in opts:
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    frames = sorted(f for f in os.listdir(tmp_path / "t") if f.endswith(".jpg"))
    jframes = sorted(f for f in os.listdir(tmp_path / "jt") if f.endswith(".jpg"))
    assert frames == jframes and len(frames) == 1
    assert (tmp_path / "t" / frames[0]).read_bytes() == (tmp_path / "jt" / jframes[0]).read_bytes()


def test_video_without_opencv_or_ffmpeg_answers_415(clip, tmp_path, monkeypatch):
    """Where neither backend exists both handlers answer
    UnsupportedMediaException: 415."""
    monkeypatch.setattr(jax_video, "_HAS_CV2", False)
    monkeypatch.setattr(jax_video, "FFMPEG", None)
    monkeypatch.setattr(port_video, "cv2_available", lambda: False)
    monkeypatch.setattr(port_video, "FFMPEG", None)
    handler, jhandler = _handlers(tmp_path)
    _, jerr = _outcome(jhandler.process_image, "tm_1,o_png", clip)
    _, perr = _outcome(handler.process_image, "tm_1,o_png", clip)
    assert type(jerr).__name__ == type(perr).__name__ == "UnsupportedMediaException"
    assert str(perr) == str(jerr)
    assert not port_video.video_available()


def test_ffmpeg_command_line_is_the_jax_package_s(tmp_path, monkeypatch):
    """Without OpenCV both packages run ffmpeg with the same arguments; an
    empty output (a time past the end) and a failing ffmpeg raise the same
    class."""
    log = tmp_path / "ffmpeg.log"
    frame = tmp_path / "frame.jpg"
    frame.write_bytes(b"\xff\xd8\xff\xd9")
    stub = tmp_path / "ffmpeg"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'case "$*" in *" -ss 99 "*) exit 0;; *" -ss 98 "*) exit 4;; esac\n'
        'for a in "$@"; do out="$a"; done\n'
        f'cp "{frame}" "$out"\n')
    stub.chmod(0o755)
    monkeypatch.setattr(jax_video, "_HAS_CV2", False)
    monkeypatch.setattr(jax_video, "FFMPEG", str(stub))
    monkeypatch.setattr(port_video, "cv2_available", lambda: False)
    monkeypatch.setattr(port_video, "FFMPEG", str(stub))
    for mod in (jax_video, port_video):
        assert mod.extract_frame("in.mp4", "00:00:02", str(tmp_path / "o.jpg"))
    lines = log.read_text().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]
    assert lines[0].split() == ["-y", "-i", "in.mp4", "-ss", "00:00:02", "-f", "image2",
                                "-frames:v", "1", str(tmp_path / "o.jpg")]
    for spec in ("99", "98"):
        names = []
        for mod in (jax_video, port_video):
            out = tmp_path / f"{mod.__name__}-{spec}.jpg"
            with pytest.raises(Exception) as info:
                mod.extract_frame("in.mp4", spec, str(out))
            names.append(type(info.value).__name__)
        assert names == ["ExecFailedException"] * 2


def test_cv2_is_not_imported_with_the_module():
    """A machine may lack OpenCV: the module imports without it and looks
    for it only when a frame is asked for."""
    import subprocess
    import sys

    code = ("import sys; import flyimg_tpu_torch.codecs.video as v; "
            "print('cv2' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == "False", out.stderr
