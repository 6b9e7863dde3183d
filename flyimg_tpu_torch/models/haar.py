"""Viola-Jones Haar-cascade face detection, vectorized with numpy.

The PyTorch package's copy of ``flyimg_tpu/models/haar.py`` (which imports
no JAX, but the port imports nothing of that package): host work only, no
device. Pillow's BILINEAR resizes of the pyramid are the numpy port in
models/thumbnail.py, byte-equal to Pillow's.

The reference's facedetect helper runs OpenCV Haar cascades
(reference src/Core/Processor/FaceDetectProcessor.php:27-29 shells out to
`facedetect`, whose default model is haarcascade_frontalface_alt). This
environment's cv2 (OpenCV 5) removed the CascadeClassifier API, so this
module evaluates the SAME cascade XML files directly: integral-image
window sums over a bilinear image pyramid, each boosted stage applied to
every surviving window at once (numpy fancy-indexed gathers instead of
the per-window C loop), with early termination pruning the window set
between stages — the data-parallel formulation of the classic algorithm.

Detection quality therefore comes from the very same trained model the
reference uses; only the evaluation engine is ours.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple, TypeVar

import numpy as np

from flyimg_tpu_torch.models.thumbnail import bilinear_resize

Box = Tuple[int, int, int, int]

_T = TypeVar("_T")


def _req(value: Optional[_T], what: str) -> _T:
    """Narrow an Optional from the ElementTree API: cascade XML files are
    trusted repo/package data, so a missing node is a malformed-file
    error, not a code path."""
    if value is None:
        raise ValueError(f"malformed cascade XML: missing {what}")
    return value

CASCADE_DIRS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/share/opencv/haarcascades",
)
DEFAULT_CASCADE = "haarcascade_frontalface_alt.xml"


def find_cascade(name: str = DEFAULT_CASCADE) -> Optional[str]:
    if os.path.isabs(name) and os.path.exists(name):
        return name
    for base in CASCADE_DIRS:
        path = os.path.join(base, name)
        if os.path.exists(path):
            return path
    return None


@dataclass(frozen=True)
class Stage:
    threshold: float
    feat_idx: np.ndarray     # [n_stumps] int32
    node_thresh: np.ndarray  # [n_stumps] float32
    leaf_left: np.ndarray    # [n_stumps] float32 (feature < t * std)
    leaf_right: np.ndarray   # [n_stumps] float32
    # stage-vectorized feature geometry: [n_stumps, 3] rect params (one
    # whole stage evaluates as ~a dozen fancy-indexed gathers over every
    # surviving window at once). None only on the first-parse pass in
    # load_cascade; every stage the detector sees carries arrays.
    rx: Optional[np.ndarray] = None
    ry: Optional[np.ndarray] = None
    rw: Optional[np.ndarray] = None
    rh: Optional[np.ndarray] = None
    wgt: Optional[np.ndarray] = None


@dataclass(frozen=True)
class Cascade:
    win_w: int
    win_h: int
    stages: Tuple[Stage, ...]
    # per feature, up to 3 rects as (x, y, w, h, weight); unused rows w=0
    rects: np.ndarray        # [n_feats, 3, 5] float32


@lru_cache(maxsize=8)
def load_cascade(path: str) -> Cascade:
    root = ET.parse(path).getroot()
    casc = root.find("cascade")
    if casc is None or casc.findtext("featureType", "").strip() != "HAAR":
        raise ValueError(f"{path}: not a HAAR stump cascade")
    win_w = int(_req(casc.findtext("width"), "width"))
    win_h = int(_req(casc.findtext("height"), "height"))

    stages: List[Stage] = []
    for st in _req(casc.find("stages"), "stages"):
        thr = float(_req(st.findtext("stageThreshold"), "stageThreshold"))
        fidx, nthr, ll, lr = [], [], [], []
        for weak in _req(st.find("weakClassifiers"), "weakClassifiers"):
            nodes = _req(
                weak.findtext("internalNodes"), "internalNodes"
            ).split()
            leaves = _req(weak.findtext("leafValues"), "leafValues").split()
            if len(nodes) != 4:
                raise ValueError(f"{path}: tree cascades unsupported (stumps only)")
            fidx.append(int(nodes[2]))
            nthr.append(float(nodes[3]))
            ll.append(float(leaves[0]))
            lr.append(float(leaves[1]))
        stages.append(
            Stage(
                thr,
                np.asarray(fidx, np.int32),
                np.asarray(nthr, np.float32),
                np.asarray(ll, np.float32),
                np.asarray(lr, np.float32),
            )
        )

    feats = _req(casc.find("features"), "features")
    rects = np.zeros((len(feats), 3, 5), np.float32)
    for i, feat in enumerate(feats):
        if feat.find("tilted") is not None and feat.findtext("tilted", "0").strip() == "1":
            raise ValueError(f"{path}: tilted features unsupported")
        for j, rect in enumerate(_req(feat.find("rects"), "rects")):
            vals = _req(rect.text, "rect text").split()
            rects[i, j] = [float(v.rstrip(".")) for v in vals]

    staged = []
    for stage in stages:
        geo = rects[stage.feat_idx]  # [K, 3, 5]
        staged.append(
            Stage(
                stage.threshold,
                stage.feat_idx,
                stage.node_thresh,
                stage.leaf_left,
                stage.leaf_right,
                rx=geo[:, :, 0].astype(np.int64),
                ry=geo[:, :, 1].astype(np.int64),
                rw=geo[:, :, 2].astype(np.int64),
                rh=geo[:, :, 3].astype(np.int64),
                wgt=geo[:, :, 4].astype(np.float64),
            )
        )
    return Cascade(win_w, win_h, tuple(staged), rects)


def _integral(img: np.ndarray) -> np.ndarray:
    ii = np.zeros((img.shape[0] + 1, img.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(img, axis=0), axis=1, out=ii[1:, 1:])
    return ii


def _rect_sums(ii: np.ndarray, ys: np.ndarray, xs: np.ndarray,
               rx: int, ry: int, rw: int, rh: int) -> np.ndarray:
    y0 = ys + ry
    x0 = xs + rx
    return (
        ii[y0, x0] + ii[y0 + rh, x0 + rw] - ii[y0, x0 + rw] - ii[y0 + rh, x0]
    )


def _detect_single_scale(
    casc: Cascade, ii: np.ndarray, ii2: np.ndarray, stride: int
) -> Tuple[np.ndarray, np.ndarray]:
    h = ii.shape[0] - 1 - casc.win_h
    w = ii.shape[1] - 1 - casc.win_w
    if h < 0 or w < 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    grid_y, grid_x = np.meshgrid(
        np.arange(0, h + 1, stride), np.arange(0, w + 1, stride), indexing="ij"
    )
    ys = grid_y.ravel()
    xs = grid_x.ravel()

    # variance normalization over the 1px-inset norm rect (OpenCV's choice)
    nx, ny = 1, 1
    nw, nh = casc.win_w - 2, casc.win_h - 2
    area = float(nw * nh)
    s1 = _rect_sums(ii, ys, xs, nx, ny, nw, nh) / area
    s2 = _rect_sums(ii2, ys, xs, nx, ny, nw, nh) / area
    var = s2 - s1 * s1
    std = np.where(var > 0.0, np.sqrt(np.maximum(var, 0.0)), 1.0)

    alive = np.arange(ys.size, dtype=np.int32)
    for stage in casc.stages:
        if alive.size == 0:
            break
        s_rx, s_ry, s_rw, s_rh, s_wgt = (
            stage.rx, stage.ry, stage.rw, stage.rh, stage.wgt,
        )
        assert (
            s_rx is not None and s_ry is not None and s_rw is not None
            and s_rh is not None and s_wgt is not None
        ), "stage missing vectorized geometry (built by load_cascade)"
        ay = ys[alive][:, None]  # [n, 1] vs per-rect [K] grids -> [n, K]
        ax = xs[alive][:, None]
        fval = np.zeros((alive.size, stage.node_thresh.size), np.float64)
        for r in range(3):
            wgt = s_wgt[:, r]
            if not wgt.any():
                continue
            y0 = ay + s_ry[None, :, r]
            x0 = ax + s_rx[None, :, r]
            y1 = y0 + s_rh[None, :, r]
            x1 = x0 + s_rw[None, :, r]
            fval += wgt[None, :] * (
                ii[y0, x0] + ii[y1, x1] - ii[y0, x1] - ii[y1, x0]
            )
        fval /= area
        total = np.where(
            fval < stage.node_thresh[None, :] * std[alive][:, None],
            stage.leaf_left[None, :],
            stage.leaf_right[None, :],
        ).sum(axis=1)
        alive = alive[total >= stage.threshold]
    return ys[alive], xs[alive]


def group_rectangles(
    rects: Sequence[Box], min_neighbors: int = 3, eps: float = 0.2
) -> List[Box]:
    """OpenCV-style rectangle clustering: union-find over the SimilarRects
    predicate, clusters averaged, small clusters dropped."""
    n = len(rects)
    if n == 0:
        return []
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    arr = np.asarray(rects, np.float64)
    # SimilarRects predicate evaluated as one [n, n] broadcast (candidate
    # counts reach thousands on busy images; a Python pair loop is seconds)
    delta = eps * 0.5 * (
        np.minimum(arr[:, None, 2], arr[None, :, 2])
        + np.minimum(arr[:, None, 3], arr[None, :, 3])
    )
    tl_close = (
        np.abs(arr[:, None, :2] - arr[None, :, :2]) <= delta[..., None]
    ).all(axis=2)
    br = arr[:, :2] + arr[:, 2:]
    br_close = (
        np.abs(br[:, None] - br[None, :]) <= delta[..., None]
    ).all(axis=2)
    ii, jj = np.nonzero(np.triu(tl_close & br_close, k=1))
    for i, j in zip(ii.tolist(), jj.tolist()):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj

    clusters = {}
    for i in range(n):
        clusters.setdefault(find(i), []).append(i)
    out: List[Box] = []
    for members in clusters.values():
        if len(members) < min_neighbors:
            continue
        avg = arr[members].mean(axis=0)
        out.append((
            int(round(avg[0])), int(round(avg[1])),
            int(round(avg[2])), int(round(avg[3])),
        ))
    return out


def detect_faces_gray(
    gray: np.ndarray,
    *,
    cascade_path: Optional[str] = None,
    scale_factor: float = 1.1,
    min_neighbors: int = 3,
    stride: int = 2,
    min_size: int = 24,
    max_dim: int = 640,
) -> List[Box]:
    """[h, w] uint8 luma -> face boxes (x, y, w, h), reading order.

    ``stride``/``max_dim`` trade recall granularity for speed the same way
    OpenCV's ystep and min-size knobs do: detection runs on a <= max_dim
    working copy and boxes scale back to source coordinates."""
    path = cascade_path or find_cascade()
    if path is None:
        raise RuntimeError("no haar cascade file available")
    casc = load_cascade(path)

    src_h, src_w = gray.shape
    prescale = 1.0
    if max(src_h, src_w) > max_dim:
        prescale = max(src_h, src_w) / max_dim
        gray = bilinear_resize(
            gray, int(round(src_w / prescale)), int(round(src_h / prescale))
        )
        src_h, src_w = gray.shape
    candidates: List[Box] = []
    scale = max(min_size / casc.win_w, 1.0)
    while casc.win_w * scale <= src_w and casc.win_h * scale <= src_h:
        sw = int(round(src_w / scale))
        sh = int(round(src_h / scale))
        small = bilinear_resize(gray, sw, sh).astype(np.float64)
        ii = _integral(small)
        ii2 = _integral(small * small)
        ys, xs = _detect_single_scale(casc, ii, ii2, stride)
        for y, x in zip(ys, xs):
            candidates.append(
                (
                    int(round(x * scale)),
                    int(round(y * scale)),
                    int(round(casc.win_w * scale)),
                    int(round(casc.win_h * scale)),
                )
            )
        scale *= scale_factor

    boxes = group_rectangles(candidates, min_neighbors=min_neighbors)
    if prescale != 1.0:
        boxes = [
            (
                int(round(x * prescale)), int(round(y * prescale)),
                int(round(bw * prescale)), int(round(bh * prescale)),
            )
            for x, y, bw, bh in boxes
        ]
    boxes.sort(key=lambda b: (b[1], b[0]))
    return boxes


def available() -> bool:
    return find_cascade() is not None


def detect_faces(rgb: np.ndarray, **kwargs) -> List[Box]:
    """[h, w, 3] uint8 -> face boxes; the facedetect-compatible entry."""
    gray = np.asarray(
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ).astype(np.uint8)
    return detect_faces_gray(gray, **kwargs)
