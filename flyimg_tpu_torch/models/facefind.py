"""Face detection by skin blobs, and the face ops (blur, crop); kernel K8.

The port of ``flyimg_tpu/models/facefind.py``. The detector is a classical
skin-region proposer: a skin-probability map, a threshold, open + close
morphology (5x5 max/min windows), then connected components and box
extraction on the host (``scipy.ndimage``, as in the JAX package). Face
blur pixelates every box (ops/pixelate.py, kernel K7); face crop slices the
Nth box.

On the card the masks of a whole shape bucket are ONE launch of kernel K8
(``csrc/facemask.cu``; its tiles from ``k8_plan``) through
``_batched_face_masks``.
``_skin_probability``, ``_morph_clean`` and ``face_masks_plain`` are the
plain PyTorch versions; ``_batched_face_masks`` runs the plain version for
a CPU tensor only.

The probability follows the JAX package's jitted arithmetic, measured on
the CPU: ``r / total`` is a true division, but XLA turns ``/ 0.07`` and
``/ 0.05`` into multiplies by ``f32(1 / 0.07)`` and ``f32(1 / 0.05)`` and
contracts the squared distance into ``fma(a, a, c * c)``; with those, all
of 2e6 random colours give XLA's distance to the bit. Its ``exp`` is XLA's
own and differs from torch's by up to 6e-8, so a pixel whose probability
lies that close to the threshold may flip.
"""

from __future__ import annotations

import ctypes
from collections import defaultdict
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models.blazeface import _sm_count
from flyimg_tpu_torch.ops.color import fma_f32
from flyimg_tpu_torch.ops.compose import _bucket_dim, bucket_batch
from flyimg_tpu_torch.ops.pixelate import pixelate_regions_u8

Box = Tuple[int, int, int, int]  # x, y, w, h

MIN_FACE_FRACTION = 0.001  # reject blobs below 0.1% of image area
MAX_FACES = 32
DEFAULT_THRESHOLD = 0.35
MORPH_RADIUS = 2           # 5x5 windows

#: the reciprocals XLA multiplies by in place of the divisions
INV07 = float(np.float32(1.0) / np.float32(0.07))
INV05 = float(np.float32(1.0) / np.float32(0.05))


#: K8's launch plan: the halo a tile stages (4 passes x radius 2), the
#: widest row one tile spans (in 32-pixel words), the words of a tile past
#: it, the core rows a tile may take (smallest first) and the shared memory
#: a block may take (csrc/facemask.cu: the mask words and the row passes'
#: words, (tile_rows + 16) x words each)
K8_HALO = 8
K8_ROW_WORDS = 64
K8_TILE_WORDS = 32
K8_TILE_ROWS = (8, 16, 32, 64)
K8_SMEM = 48 * 1024


class K8Plan(NamedTuple):
    tile_rows: int     # rows of a tile's core
    words: int         # 32-pixel words a staged row holds
    tile_cols: int     # columns of a tile's core
    halo_x: int        # staged columns left of the core (0: whole rows)
    tiles_y: int
    tiles_x: int
    blocks: int


def k8_plan(batch: int, h: int, w: int, sms: int = 132) -> K8Plan:
    """K8's tiles for a [batch, h, w] bucket: a row of up to
    ``K8_ROW_WORDS`` words is one tile wide with no halo in x (the image's
    edges are the valid region's); a wider row is cut into cores of
    ``32 K8_TILE_WORDS - 16`` columns with an 8-pixel halo each side. The
    core rows are the fewest of ``K8_TILE_ROWS`` whose blocks fit one to
    each of the card's ``sms`` SMs (the most when none do; the whole height
    when it is less), each tile staged with 8 halo rows above and below: a
    block is bound by the instructions its SM issues for it, so below one
    block an SM the time is one block's, which grows with its rows, and
    past it taller tiles recompute fewer halo rows."""
    row_words = -(-w // 32)
    if row_words <= K8_ROW_WORDS:
        words, tile_cols, halo_x = row_words, w, 0
    else:
        words, halo_x = K8_TILE_WORDS, K8_HALO
        tile_cols = 32 * words - 2 * K8_HALO
    tiles_x = -(-w // tile_cols)
    most_rows = K8_SMEM // (2 * 4 * words) - 2 * K8_HALO
    for rows in K8_TILE_ROWS:
        tile_rows = min(rows, most_rows, h)
        tiles_y = -(-h // tile_rows)
        if batch * tiles_y * tiles_x <= sms:
            break
    return K8Plan(tile_rows, words, tile_cols, halo_x, tiles_y, tiles_x,
                  batch * tiles_y * tiles_x)


def _f32(v: float, device) -> torch.Tensor:
    """An f32 scalar as a 0-dim tensor, so the arithmetic stays f32."""
    return torch.tensor(np.float32(v), device=device)


def _skin_probability(rgb: torch.Tensor) -> torch.Tensor:
    """[..., h, w, 3] u8 -> [..., h, w] f32 skin likelihood in [0, 1]:
    normalized-rgb chromaticity Gaussian x simple RGB gates."""
    dev = rgb.device
    rgbf = rgb.to(torch.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    total = r + g + b + _f32(1e-6, dev)
    rn, gn = r / total, g / total
    a = (rn - _f32(0.44, dev)) * _f32(INV07, dev)
    c = (gn - _f32(0.31, dev)) * _f32(INV05, dev)
    d2 = fma_f32(a, a, c * c)
    chroma = torch.exp(_f32(-0.5, dev) * d2)
    gates = (
        (r > 60.0) & (r > b) & (r > g * _f32(0.9, dev))
        & ((r - g).abs() > 10.0)
    ).to(torch.float32)
    return chroma * gates


def _pool(m: torch.Tensor, valid: torch.Tensor, dilate: bool) -> torch.Tensor:
    """5x5 max (dilate) or min (erode) of [B, h, w] f32 ``m`` over windows
    clipped to ``valid``; values outside ``valid`` are ignored."""
    k = 2 * MORPH_RADIUS + 1
    sign = 1.0 if dilate else -1.0
    x = torch.where(valid, sign * m, torch.full_like(m, -torch.inf))
    return sign * F.max_pool2d(x[:, None], k, 1, MORPH_RADIUS)[:, 0]


def _morph_clean(mask: torch.Tensor) -> torch.Tensor:
    """[h, w] bool -> bool: open (erode, dilate) then close (dilate, erode)
    with 5x5 windows, SAME borders."""
    valid = torch.ones((1,) + tuple(mask.shape), dtype=torch.bool,
                       device=mask.device)
    return clean_masks(mask[None], valid)[0]


def _valid(in_true: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, h, w] bool: row < valid h and column < valid w, in f32."""
    dev = in_true.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    return (ys < in_true[:, 0, None, None]) & (xs < in_true[:, 1, None, None])


def clean_masks(mask: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, h, w] bool thresholded masks -> cleaned masks: erode, dilate,
    dilate, erode with windows clipped to ``valid``, then ``& valid``."""
    m = (mask & valid).to(torch.float32)
    for dilate in (False, True, True, False):
        m = _pool(m, valid, dilate)
    return (m > 0.5) & valid


def face_masks_plain(images: torch.Tensor, in_true: torch.Tensor,
                     thresholds: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K8: [B, bh, bw, 3] u8, valid (h, w)
    [B, 2] f32, thresholds [B] f32 -> [B, bh, bw] bool cleaned masks, the
    morphology windows clipped to each member's valid region."""
    prob = _skin_probability(images)
    valid = _valid(in_true, images.shape[1], images.shape[2])
    return clean_masks(prob > thresholds[:, None, None], valid)


def _batched_face_masks(images: torch.Tensor, in_true: torch.Tensor,
                        thresholds: torch.Tensor,
                        prob_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cleaned masks of one bucket: kernel K8 on CUDA tensors,
    ``face_masks_plain`` on CPU tensors. ``prob_out`` (f32 [B, bh, bw] on
    the card, K8 only) receives the probability map."""
    if (images.dtype != torch.uint8 or images.dim() != 4
            or images.shape[3] != 3):
        raise ValueError(
            f"face masks take u8 [B, h, w, 3], got {images.dtype} "
            f"{tuple(images.shape)}"
        )
    b, h, w, _ = images.shape
    if tuple(in_true.shape) != (b, 2) or tuple(thresholds.shape) != (b,):
        raise ValueError(
            f"in_true must be [{b}, 2] and thresholds [{b}], got "
            f"{tuple(in_true.shape)} and {tuple(thresholds.shape)}"
        )
    if min(b, h, w) < 1:
        raise ValueError(f"face masks of an empty batch {tuple(images.shape)}")
    if images.device.type == "cpu":
        if prob_out is not None:
            raise ValueError("prob_out is K8's (a CUDA tensor)")
        return face_masks_plain(images, in_true, thresholds)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    images = images.contiguous()
    in_true = in_true.to(torch.float32).contiguous()
    thresholds = thresholds.to(torch.float32).contiguous()
    if prob_out is not None and (
        prob_out.dtype != torch.float32 or tuple(prob_out.shape) != (b, h, w)
        or not prob_out.is_contiguous() or prob_out.device != images.device
    ):
        raise ValueError("prob_out must be contiguous f32 [B, h, w] on the card")
    out = torch.empty((b, h, w), dtype=torch.uint8, device=images.device)
    plan = k8_plan(b, h, w, _sm_count(images.device.index))
    rc = _lib().flyimg_face_masks(
        images.data_ptr(), in_true.data_ptr(), thresholds.data_ptr(), out.data_ptr(),
        None if prob_out is None else prob_out.data_ptr(), b, h, w,
        *plan[:6], INV07, INV05, cuda_build.current_stream(images.device.index),
    )
    cuda_build.check(rc, "face_masks")
    _batched_face_masks.launches += 1
    return out.view(torch.bool)


#: K8 launches since the last reset (one a call)
_batched_face_masks.launches = 0


def _lib():
    lib = cuda_build.load("facemask")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.flyimg_face_masks
        fn.argtypes = [p] * 5 + [i] * 9 + [f, f, p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


def _boxes_from_mask(mask: np.ndarray) -> List[Box]:
    """Connected components -> face boxes, sorted top-to-bottom then
    left-to-right (facedetect's reading order, so ``fcp`` indices behave
    comparably)."""
    from scipy import ndimage

    labels, count = ndimage.label(mask)
    if count == 0:
        return []
    h, w = mask.shape
    min_area = max(int(h * w * MIN_FACE_FRACTION), 16)
    boxes: List[Box] = []
    for sl in ndimage.find_objects(labels):
        if sl is None:
            continue
        bh = sl[0].stop - sl[0].start
        bw = sl[1].stop - sl[1].start
        if bh * bw < min_area:
            continue
        # faces are roughly square-ish; reject extreme aspect blobs
        aspect = bw / max(bh, 1)
        if aspect < 0.25 or aspect > 4.0:
            continue
        boxes.append((sl[1].start, sl[0].start, bw, bh))
    boxes.sort(key=lambda b: (b[1], b[0]))
    return boxes[:MAX_FACES]


@dataclass(frozen=True)
class FaceWork:
    image: np.ndarray                # [h, w, 3] uint8
    threshold: float
    bucket: Tuple[int, int]          # padded (h, w) shape bucket


def prepare_face_work(rgb: np.ndarray,
                      threshold: float = DEFAULT_THRESHOLD) -> FaceWork:
    h, w = rgb.shape[:2]
    return FaceWork(
        image=np.ascontiguousarray(rgb),
        threshold=threshold,
        bucket=(_bucket_dim(h, 32), _bucket_dim(w, 32)),
    )


def detect_faces_batched(items: List[FaceWork],
                         device: Union[str, torch.device] = "cuda"
                         ) -> List[List[Box]]:
    """Face boxes for many images: one K8 call per shape bucket (occupancy
    on the power-of-two ladder, pad slots copies of the last member), host
    component extraction per member."""
    dev = resolve_device(device)
    results: List[List[Box]] = [[] for _ in items]
    by_bucket = defaultdict(list)
    for i, item in enumerate(items):
        by_bucket[item.bucket].append(i)
    for (bh, bw), idxs in by_bucket.items():
        n = len(idxs)
        nb = bucket_batch(n)
        images = np.zeros((nb, bh, bw, 3), np.uint8)
        in_true = np.zeros((nb, 2), np.float32)
        thresholds = np.zeros((nb,), np.float32)
        for j, i in enumerate(idxs):
            h, w = items[i].image.shape[:2]
            images[j, :h, :w] = items[i].image
            in_true[j] = (h, w)
            thresholds[j] = items[i].threshold
        images[n:] = images[n - 1]
        in_true[n:] = in_true[n - 1]
        thresholds[n:] = thresholds[n - 1]
        masks = _batched_face_masks(
            torch.from_numpy(images).to(dev), torch.from_numpy(in_true).to(dev),
            torch.from_numpy(thresholds).to(dev),
        )[:n].cpu().numpy()
        for j, i in enumerate(idxs):
            h, w = items[i].image.shape[:2]
            results[i] = _boxes_from_mask(masks[j, :h, :w])
    return results


def detect_faces(rgb: np.ndarray, threshold: float = DEFAULT_THRESHOLD,
                 device: Union[str, torch.device] = "cuda") -> List[Box]:
    """Face-like skin regions of one image: a batch of one at the image's
    exact size (windows clipped to the whole frame are the unbatched
    path's SAME borders)."""
    h, w = rgb.shape[:2]
    item = FaceWork(np.ascontiguousarray(rgb), threshold, (h, w))
    return detect_faces_batched([item], device)[0]


def blur_faces(rgb: np.ndarray, boxes: List[Box],
               device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Pixelate every face region (the reference's blurFaces,
    FaceDetectProcessor.php:51-76): one K7 launch on the card."""
    if not boxes:
        return rgb
    dev = resolve_device(device)
    padded = np.zeros((MAX_FACES, 4), np.float32)
    for i, box in enumerate(boxes[:MAX_FACES]):
        padded[i] = box
    out = pixelate_regions_u8(
        torch.from_numpy(np.ascontiguousarray(rgb)).to(dev),
        torch.from_numpy(padded).to(dev),
    )
    return out.cpu().numpy()


def crop_face(rgb: np.ndarray, boxes: List[Box], position: int = 0) -> np.ndarray:
    """Crop the Nth face (the reference's cropFaces,
    FaceDetectProcessor.php:22-42); the image unchanged when there is no
    face."""
    if not boxes:
        return rgb
    position = min(max(position, 0), len(boxes) - 1)
    x, y, w, h = boxes[position]
    return rgb[y : y + h, x : x + w]
