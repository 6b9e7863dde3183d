"""Video frame extraction.

The port of the JAX package's ``codecs/video.py``. A video source is
swapped for the frame at the ``tm_`` timestamp before the pipeline runs
(reference src/Core/Entity/Image/InputImage.php:61-68,
src/Core/Processor/VideoProcessor.php:35-57), frames cached per (source,
time). Two backends, the first found wins:

- OpenCV (``cv2.VideoCapture``, in-process demux and decode), seeking by
  millisecond and writing the frame as a JPEG with ``cv2.imwrite``;
- the ffmpeg binary, with the reference's command shape.

``cv2`` is imported only when a frame is extracted: a machine without it
imports this module all the same, and with neither backend it answers
``UnsupportedMediaException`` (415). A timestamp past the end
of the video raises ``ExecFailedException``, as the reference's
empty-output check does (VideoProcessor.php:54-57). The frame's JPEG is
then decoded by the port's JPEG decoder like any other source.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess

from flyimg_tpu_torch.exceptions import ExecFailedException, UnsupportedMediaException

FFMPEG = shutil.which("ffmpeg")


def cv2_available() -> bool:
    """OpenCV imports here (tried at the first call, not at import)."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def video_available() -> bool:
    return cv2_available() or FFMPEG is not None


def ffmpeg_available() -> bool:
    return FFMPEG is not None


def _time_spec_ms(time_spec: str) -> float:
    """'5', '5.25', or 'HH:MM:SS[.frac]' -> milliseconds (reference accepts
    both forms, docs/url-options.md tm_)."""
    text = str(time_spec).strip()
    try:
        if ":" in text:
            parts = text.split(":")
            if len(parts) > 3 or any(p == "" for p in parts):
                raise ValueError(text)
            seconds = 0.0
            for part in parts:
                seconds = seconds * 60.0 + float(part)
        else:
            seconds = float(text)
    except ValueError:
        raise ExecFailedException(f"bad time spec: {time_spec!r}") from None
    if not math.isfinite(seconds) or seconds < 0:
        raise ExecFailedException(f"bad time spec: {time_spec!r}")
    return seconds * 1000.0


def _extract_frame_cv2(video_path: str, time_spec: str, out_path: str) -> str:
    import cv2

    ms = _time_spec_ms(time_spec)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise ExecFailedException(f"cannot open video: {video_path}")
    try:
        cap.set(cv2.CAP_PROP_POS_MSEC, ms)
        ok, frame = cap.read()
        if not ok or frame is None:
            # timestamp past end of video (reference VideoProcessor.php:54-57)
            raise ExecFailedException(
                f"no frame extracted at {time_spec} (past end of video?)"
            )
        if not cv2.imwrite(out_path, frame):
            raise ExecFailedException(f"cannot write frame to {out_path}")
    finally:
        cap.release()
    return out_path


def _extract_frame_ffmpeg(video_path: str, time_spec: str, out_path: str) -> str:
    cmd = [
        FFMPEG, "-y", "-i", video_path, "-ss", str(time_spec),
        "-f", "image2", "-frames:v", "1", out_path,
    ]
    proc = subprocess.run(cmd, capture_output=True, timeout=120)
    if proc.returncode != 0:
        raise ExecFailedException(
            f"ffmpeg failed (rc={proc.returncode}): {proc.stderr[-400:]!r}"
        )
    if not os.path.exists(out_path) or os.path.getsize(out_path) == 0:
        raise ExecFailedException(
            f"no frame extracted at {time_spec} (past end of video?)"
        )
    return out_path


def extract_frame(video_path: str, time_spec: str, out_path: str) -> str:
    """Extract one frame at ``time_spec`` ('00:00:01' or seconds) to
    ``out_path`` (jpg)."""
    _time_spec_ms(time_spec)  # validate up front: both backends reject the
    # same malformed specs (bare ffmpeg would clamp e.g. -ss -4 to 0)
    if cv2_available():
        return _extract_frame_cv2(video_path, time_spec, out_path)
    if FFMPEG is not None:
        return _extract_frame_ffmpeg(video_path, time_spec, out_path)
    raise UnsupportedMediaException(
        "video sources need OpenCV or ffmpeg, neither available in this runtime"
    )
