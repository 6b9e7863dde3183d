"""Face backend registry: one detect/blur/crop contract, several engines.

The port of ``flyimg_tpu/models/faces.py``, chosen by the ``face_backend``
/ ``face_checkpoint`` app parameters with the same resolution order:

- ``haar`` — the reference's detector family, evaluated on the host from
  the cascade XML files (models/haar.py); no device work;
- ``blazeface`` — the BlazeFace convnet (models/blazeface.py, kernels K9
  and K10), batched through the runtime at a 0.8 score threshold;
  ``face_checkpoint`` names an ``.npz`` written by
  ``tools/export_blazeface_npz.py`` (the packaged weights by default);
- ``facefind`` — the skin-blob proposer (models/facefind.py, kernel K8);
  opt-in only: it proposes skin-toned regions, not faces;
- ``none`` — zero faces: the face options no-op, as the reference does
  when its detector is missing.

``auto`` takes Haar where cascade files exist, else the packaged BlazeFace
weights, else ``none``; the skin proposer is never reached implicitly.
Blur (K7) and crop are shared by every backend (facefind.blur_faces /
crop_face). A backend runs its device work on the ``device`` it is made
for (default CUDA; a CPU run is asked for by name).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models import blazeface, facefind, haar

Box = Tuple[int, int, int, int]

PACKAGED_BLAZEFACE = blazeface.PACKAGED_WEIGHTS


class _Backend:
    """Blur and crop, shared by every detector."""

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)

    def blur_faces(self, rgb: np.ndarray, boxes: List[Box]) -> np.ndarray:
        return facefind.blur_faces(rgb, boxes, self.device)

    crop_face = staticmethod(facefind.crop_face)


class HaarBackend(_Backend):
    """Haar cascade detection on the host (the reference's detector)."""

    def __init__(self, cascade_path: Optional[str] = None, *,
                 min_neighbors: int = 2,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        self.cascade_path = cascade_path or haar.find_cascade()
        if self.cascade_path is None:
            raise RuntimeError("no haar cascade XML available")
        self.min_neighbors = min_neighbors

    def detect_faces(self, rgb: np.ndarray) -> List[Box]:
        return haar.detect_faces(
            rgb, cascade_path=self.cascade_path,
            min_neighbors=self.min_neighbors,
        )


class BlazeFaceBackend(_Backend):
    """BlazeFace detection; the fixed 128x128 input puts every request in
    one bucket, so concurrent face requests share one batched forward.
    0.8 is the JAX package's operating point (its docstring gives the
    evaluation behind it)."""

    def __init__(self, checkpoint: str, *, score_threshold: float = 0.8,
                 device: Union[str, torch.device] = "cuda") -> None:
        super().__init__(device)
        self.model = blazeface.load_weights(checkpoint, self.device)
        self.score_threshold = score_threshold

    def detect_faces(self, rgb: np.ndarray) -> List[Box]:
        return blazeface.detect_faces(
            self.model, rgb, score_threshold=self.score_threshold
        )

    def prepare_face_work(self, rgb: np.ndarray,
                          threshold: float = 0.0) -> facefind.FaceWork:
        del threshold
        return facefind.FaceWork(
            image=np.ascontiguousarray(rgb),
            threshold=self.score_threshold,
            bucket=(blazeface.INPUT_SIZE, blazeface.INPUT_SIZE),
        )

    def detect_faces_batched(self, items) -> List[List[Box]]:
        return blazeface.detect_faces_batch(
            self.model, [item.image for item in items],
            score_threshold=self.score_threshold,
        )


class FacefindBackend(_Backend):
    """The skin-blob proposer; opt-in only (``face_backend: facefind``):
    fb_1 under it can pixelate arms and crowds."""

    def detect_faces(self, rgb: np.ndarray,
                     threshold: float = facefind.DEFAULT_THRESHOLD) -> List[Box]:
        return facefind.detect_faces(rgb, threshold, self.device)

    prepare_face_work = staticmethod(facefind.prepare_face_work)

    def detect_faces_batched(self, items) -> List[List[Box]]:
        return facefind.detect_faces_batched(items, self.device)


class NullBackend(_Backend):
    """Zero faces: the face options no-op, the reference's behaviour when
    its detector is missing (FaceDetectProcessor.php:24,53)."""

    @staticmethod
    def detect_faces(rgb: np.ndarray) -> List[Box]:
        del rgb
        return []


def make_face_backend(name: str = "auto", checkpoint: Optional[str] = None,
                      device: Union[str, torch.device] = "cuda"):
    """Resolve the serving face backend (see the module docstring)."""
    name = (name or "auto").lower()
    if name == "blazeface":
        ckpt = checkpoint or PACKAGED_BLAZEFACE
        if not os.path.exists(ckpt):
            raise RuntimeError(
                f"blazeface weights not found at {ckpt}; set face_checkpoint "
                f"to an .npz written by {blazeface.EXPORTER}"
            )
        return BlazeFaceBackend(ckpt, device=device)
    if name == "haar":
        return HaarBackend(checkpoint, device=device)
    if name == "facefind":
        return FacefindBackend(device)
    if name in ("none", "null"):
        return NullBackend(device)
    if name == "auto":
        if haar.available():
            return HaarBackend(device=device)
        if os.path.exists(PACKAGED_BLAZEFACE):
            return BlazeFaceBackend(PACKAGED_BLAZEFACE, device=device)
        return NullBackend(device)
    raise ValueError(f"unknown face_backend {name!r}")
