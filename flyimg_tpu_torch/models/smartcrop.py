"""Smart crop on PyTorch: the reference's scorer as a saliency field plus one
strided correlation per candidate scale.

The port of ``flyimg_tpu/models/smartcrop.py`` (itself a vectorised port of
the reference's smartcrop.py). The importance of a pixel depends only on
its position relative to the crop window, so for a fixed crop size it is a
fixed [ch, cw] kernel, and every stride-8 candidate position is scored by
one strided cross-correlation of the weighted feature field with it, plus
an outside-the-crop term from box sums:

    score(x, y) = conv(field, importance)[x, y]
                  + OUTSIDE_IMPORTANCE * (total - boxsum(x, y))

Two device functions carry it, each a CUDA kernel on a CUDA tensor and a
plain PyTorch version on a CPU tensor:

- ``_batched_weighted`` (kernel K2, ``csrc/saliency.cu``): the feature maps
  (floored luma Laplacian, skin, saturation, quantised like the reference's
  uint8 round trip) merged into the weighted field, zero outside each
  member's valid region;
- ``_batched_scores`` (kernel K3, ``csrc/scores.cu``): the strided VALID
  correlation of each field with its member's kernel stack, in f32, plus
  the field totals.

Host bookkeeping — the prescale (a numpy port of Pillow's LANCZOS,
models/thumbnail.py), candidate geometry, argmax and the reference's quirky
crop output — follows the JAX package line for line.
"""

from __future__ import annotations

import ctypes
import math
from collections import defaultdict
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models.thumbnail import lanczos_resize

# reference smartcrop.py:41-77 constructor defaults
DETAIL_WEIGHT = 0.2
EDGE_RADIUS = 0.4
EDGE_WEIGHT = -10.0
OUTSIDE_IMPORTANCE = -0.5
RULE_OF_THIRDS = True
SATURATION_BIAS = 0.2
SATURATION_BRIGHTNESS_MAX = 0.9
SATURATION_BRIGHTNESS_MIN = 0.05
SATURATION_THRESHOLD = 0.4
SATURATION_WEIGHT = 0.3
SKIN_BIAS = 0.01
SKIN_BRIGHTNESS_MAX = 1.0
SKIN_BRIGHTNESS_MIN = 0.2
SKIN_COLOR = (0.78, 0.57, 0.44)
SKIN_THRESHOLD = 0.8
SKIN_WEIGHT = 1.8


def _thirds(x: np.ndarray) -> np.ndarray:
    """reference smartcrop.py:30-34."""
    x = ((x + 2.0 / 3.0) % 2.0 * 0.5 - 0.5) * 16.0
    return np.maximum(1.0 - x * x, 0.0)


@lru_cache(maxsize=64)
def importance_kernel(crop_w: float, crop_h: float) -> np.ndarray:
    """The importance field for in-crop pixels (reference
    smartcrop.py:276-298, evaluated at integer pixel offsets). ``crop_w/h``
    are the reference's FLOAT crop dims (crop_size * scale): a pixel is
    in-crop while offset < crop_w, so the kernel spans ceil(crop_w) columns,
    and relative positions divide by the float dims."""
    kw = int(math.ceil(crop_w))
    kh = int(math.ceil(crop_h))
    xs = (np.arange(kw, dtype=np.float64)) / crop_w
    ys = (np.arange(kh, dtype=np.float64)) / crop_h
    px = np.abs(0.5 - xs)[None, :] * 2.0
    py = np.abs(0.5 - ys)[:, None] * 2.0
    dx = np.maximum(px - 1.0 + EDGE_RADIUS, 0.0)
    dy = np.maximum(py - 1.0 + EDGE_RADIUS, 0.0)
    d = (dx * dx + dy * dy) * EDGE_WEIGHT
    s = 1.41 - np.sqrt(px * px + py * py)
    if RULE_OF_THIRDS:
        s = s + (np.maximum(0.0, s + d + 0.5) * 1.2) * (_thirds(px) + _thirds(py))
    return (s + d).astype(np.float32)


# ---------------------------------------------------------------------------
# feature maps and the weighted field (plain versions of kernel K2)
# ---------------------------------------------------------------------------


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as an IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal,
    which can land one ulp off — a whole level once floored — so the
    divisor goes in as a tensor on ``t``'s device."""
    return t / torch.tensor(c, dtype=t.dtype, device=t.device)


def _analyse_features_valid(rgb: torch.Tensor, true_hw: torch.Tensor) -> torch.Tensor:
    """[B, h, w, 3] u8 + [B, 2] valid (h, w) -> [B, h, w, 3] f32 feature
    maps in [0, 255]: channel 0 skin, 1 edge (detail), 2 saturation. Pixels
    inside the valid region get exactly the reference maps — the unfiltered
    1px border lands on the VALID edge — and the padded remainder is
    garbage the caller masks off (computed as the reference computes it)."""
    rgbf = rgb.to(torch.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    # PIL convert('L', (0.2126, 0.7152, 0.0722, 0)) truncates to uint8
    cie = torch.floor(0.2126 * r + 0.7152 * g + 0.0722 * b)

    # edge: 3x3 Laplacian, offset 1, clamped; the valid border unfiltered
    lap = (
        4.0 * cie
        - torch.roll(cie, 1, -2) - torch.roll(cie, -1, -2)
        - torch.roll(cie, 1, -1) - torch.roll(cie, -1, -1)
    )
    h, w = cie.shape[-2:]
    th = true_hw[:, 0, None, None]
    tw = true_hw[:, 1, None, None]
    yy = torch.arange(h, device=rgb.device)[:, None].to(torch.float32)
    xx = torch.arange(w, device=rgb.device)[None, :].to(torch.float32)
    border = (yy == 0) | (yy == th - 1) | (xx == 0) | (xx == tw - 1)
    edge = torch.where(border, cie, torch.clamp(lap + 1.0, 0.0, 255.0))
    edge = torch.floor(edge)

    # skin
    mag = torch.sqrt(r * r + g * g + b * b)
    dark = mag < 1e-6
    safe_mag = torch.where(dark, torch.ones_like(mag), mag)
    zero = torch.zeros_like(mag)
    rd = torch.where(dark, zero - SKIN_COLOR[0], r / safe_mag - SKIN_COLOR[0])
    gd = torch.where(dark, zero - SKIN_COLOR[1], g / safe_mag - SKIN_COLOR[1])
    bd = torch.where(dark, zero - SKIN_COLOR[2], b / safe_mag - SKIN_COLOR[2])
    skin = 1.0 - torch.sqrt(rd * rd + gd * gd + bd * bd)
    skin_mask = (
        (skin > SKIN_THRESHOLD)
        & (cie >= SKIN_BRIGHTNESS_MIN * 255.0)
        & (cie <= SKIN_BRIGHTNESS_MAX * 255.0)
    )
    skin_data = (skin - SKIN_THRESHOLD) * (255.0 / (1.0 - SKIN_THRESHOLD))
    skin_out = torch.floor(
        torch.clamp(torch.where(skin_mask, skin_data, zero), 0.0, 255.0)
    )

    # saturation
    maximum = torch.maximum(torch.maximum(r, g), b)
    minimum = torch.minimum(torch.minimum(r, g), b)
    eq = maximum == minimum
    ssum = _div(maximum + minimum, 255.0)
    d_ = _div(maximum - minimum, 255.0)
    d_ = torch.where(eq, zero, d_)
    ssum = torch.where(eq, torch.ones_like(ssum), ssum)
    ssum = torch.where(ssum > 1.0, 2.0 - d_, ssum)
    sat = d_ / ssum
    sat_mask = (
        (sat > SATURATION_THRESHOLD)
        & (cie >= SATURATION_BRIGHTNESS_MIN * 255.0)
        & (cie <= SATURATION_BRIGHTNESS_MAX * 255.0)
    )
    sat_data = (sat - SATURATION_THRESHOLD) * (
        255.0 / (1.0 - SATURATION_THRESHOLD)
    )
    sat_out = torch.floor(
        torch.clamp(torch.where(sat_mask, sat_data, zero), 0.0, 255.0)
    )
    return torch.stack([skin_out, edge, sat_out], dim=-1)


def analyse_features(rgb: torch.Tensor) -> torch.Tensor:
    """[h, w, 3] u8 -> [h, w, 3] f32 feature maps, the valid region being
    the whole array."""
    h, w = rgb.shape[:2]
    true_hw = torch.tensor([[h, w]], dtype=torch.float32, device=rgb.device)
    return _analyse_features_valid(rgb[None], true_hw)[0]


def weighted_field(features: torch.Tensor) -> torch.Tensor:
    """Merge the three feature maps with the reference's scoring channel
    weights into the scalar field candidate scoring correlates over."""
    skin = _div(features[..., 0], 255.0)
    detail = _div(features[..., 1], 255.0)
    sat = _div(features[..., 2], 255.0)
    return (
        detail * DETAIL_WEIGHT
        + skin * (detail + SKIN_BIAS) * SKIN_WEIGHT
        + sat * (detail + SATURATION_BIAS) * SATURATION_WEIGHT
    )


def batched_weighted_plain(images: torch.Tensor, in_true: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel K2."""
    wf = weighted_field(_analyse_features_valid(images, in_true))
    h, w = images.shape[1:3]
    yy = torch.arange(h, device=images.device).to(torch.float32)
    xx = torch.arange(w, device=images.device).to(torch.float32)
    valid = (yy[None, :, None] < in_true[:, 0, None, None]) & (
        xx[None, None, :] < in_true[:, 1, None, None]
    )
    return torch.where(valid, wf, torch.zeros_like(wf))


#: K2's launch constants (csrc/saliency.cu): threads a block, the widest
#: column chunk a block stages, the shared memory a block may take (two
#: blocks an SM), and the card's SMs for the persistent grid
K2_THREADS = 512
K2_MAX_CHUNK_W = 512
K2_SMEM_CAP = 112 * 1024
K2_SMS = 132
K2_BLOCKS_PER_SM = 2
K2_SM_SMEM = 228 * 1024

#: K2's exact shortcuts. The maps are compared with whole-level lumas, so
#: each luma window is an integer range: skin needs luma >= 51, saturation
#: 13 <= luma <= 229 (``k2_thresholds`` derives them from the constants
#: above the way the plain version compares them). The skin pre-test's
#: integer weights (csrc/saliency.cu DOT_R, DOT_G, DOT_B):
K2_SKIN_DOT_WEIGHTS = (78, 57, 44)   # round(100 * SKIN_COLOR)
#: margin on the skin pre-test's cosine, far above f32 rounding (~1e-7)
K2_SKIN_PRETEST_MARGIN = 0.002
#: K2's fast skin level is taken where it lies farther than this from a
#: whole level (csrc/saliency.cu SKIN_LEVEL_MARGIN)
K2_SKIN_LEVEL_MARGIN = 1.0 / 256.0

#: the table's bytes: the saturation level of every (max, min) with
#: min <= max, at max * (max + 1) / 2 + min
K2_TABLE_BYTES = 256 * 257 // 2


def k2_quotients() -> np.ndarray:
    """[511] f32: ``k / 255`` for k in 0..510, IEEE-rounded, as the plain
    version divides integer-valued f32 sums and differences by 255."""
    return np.arange(511, dtype=np.float32) / np.float32(255.0)


def k2_saturation_levels() -> np.ndarray:
    """[256, 256] u8: the floored saturation level of a pixel whose channel
    maximum is ``[mx]`` and minimum ``[mn]`` (for mn <= mx; 0 above the
    diagonal), before the luma window: the plain version's f32 operations
    in its order."""
    q = k2_quotients()
    mx = np.arange(256)[:, None]
    mn = np.arange(256)[None, :]
    ssum = q[mx + mn]
    d = q[np.abs(mx - mn)]
    eq = mx == mn
    d = np.where(eq, np.float32(0.0), d)
    ssum = np.where(eq, np.float32(1.0), ssum)
    ssum = np.where(ssum > np.float32(1.0), np.float32(2.0) - d, ssum)
    sat = d / ssum
    mask = sat > np.float32(SATURATION_THRESHOLD)
    data = (sat - np.float32(SATURATION_THRESHOLD)) * np.float32(
        255.0 / (1.0 - SATURATION_THRESHOLD)
    )
    level = np.floor(np.clip(np.where(mask, data, np.float32(0.0)), 0, 255))
    return np.where(mn <= mx, level, 0).astype(np.uint8)


def k2_table_bytes() -> bytes:
    """The ``K2_TABLE_BYTES`` a K2 block stages into shared memory."""
    levels = k2_saturation_levels()
    return np.concatenate([levels[m, : m + 1] for m in range(256)]).tobytes()


@lru_cache(maxsize=1)
def k2_thresholds() -> Tuple[int, int, int, int]:
    """(skin luma min, saturation luma min, saturation luma max, skin
    pre-test constant). A luma is a whole number in 0..255 held as f32, so
    each f32 comparison of the plain version is an integer bound. The
    pre-test keeps a pixel for the exact skin path when
    ``dot * dot > K * S`` in u32, with ``dot = 78 r + 57 g + 44 b`` and
    ``S = r^2 + g^2 + b^2``: skin > 0.8 means a cosine with the skin colour
    above (1 + |s|^2 - 0.2^2) / 2, and K is 1e4 times that cosine, less
    ``K2_SKIN_PRETEST_MARGIN``, squared."""
    skin_lo = np.float32(SKIN_BRIGHTNESS_MIN * 255.0)
    sat_lo = np.float32(SATURATION_BRIGHTNESS_MIN * 255.0)
    sat_hi = np.float32(SATURATION_BRIGHTNESS_MAX * 255.0)
    s2 = sum(float(np.float32(c)) ** 2 for c in SKIN_COLOR)
    cos = (1.0 + s2 - (1.0 - SKIN_THRESHOLD) ** 2) / 2.0
    k = int(math.floor(1e4 * (cos - K2_SKIN_PRETEST_MARGIN) ** 2))
    return (int(np.ceil(skin_lo)), int(np.ceil(sat_lo)), int(np.floor(sat_hi)), k)


@dataclass(frozen=True)
class K2Plan:
    """One K2 launch: ``blocks`` persistent blocks walk the tiles, each
    ``tile_h`` output rows by ``chunk_w`` columns of one member; a tile's
    source rows (one-pixel halo) are staged at ``stage_pitch`` bytes a row
    (two buffers), its lumas at ``luma_pitch`` words a row (four pixels a
    word, one halo word each side)."""

    tile_h: int
    chunk_w: int
    n_row_tiles: int
    n_col_chunks: int
    stage_pitch: int
    luma_pitch: int
    smem_bytes: int
    blocks: int


def _k2_chunk(w: int) -> Tuple[int, int]:
    n_ct = -(-w // K2_MAX_CHUNK_W)
    cw = -(-(-(-w // n_ct)) // 4) * 4
    return n_ct, cw


def k2_smem_bytes(tile_h: int, chunk_w: int) -> Tuple[int, int, int]:
    """(stage pitch, luma pitch, shared bytes) of a tile: the staged row
    holds the chunk and its halo at the source's 16-byte phase, plus the
    slack a 12-byte read at a word boundary takes; two buffers of staged
    rows (the next tile's copies fly while one is computed) and a row of
    luma words each."""
    sp = -(-(15 + 3 * (chunk_w + 2)) // 16) * 16 + 16
    lp = chunk_w // 4 + 2
    return sp, lp, K2_TABLE_BYTES + (tile_h + 2) * (2 * sp + 4 * lp)


def _k2_blocks_per_sm(smem: int) -> int:
    return max(1, min(K2_BLOCKS_PER_SM, K2_SM_SMEM // (smem + 1024)))


@lru_cache(maxsize=256)
def k2_plan(batch: int, h: int, w: int, tile_h: Optional[int] = None) -> K2Plan:
    """Pick K2's tiles for a [batch, h, w] field. Columns split into the
    fewest chunks of at most ``K2_MAX_CHUNK_W`` (a multiple of 4); the tile
    height is the one with the least estimated time whose shared memory
    stays within ``K2_SMEM_CAP``: a tile's thread sweeps (output groups of
    four pixels, the cheaper luma words of the halo-wide tile, and one
    sweep of staging and barriers) times the tiles, over the card's block
    slots, and at least one tile's sweeps. ``tile_h`` sets the tile height
    instead (the breakdown tool's sweep)."""
    batch, h, w = int(batch), int(h), int(w)
    if min(batch, h, w) < 1:
        raise ValueError(f"K2 plan of empty shape {(batch, h, w)}")
    n_ct, cw = _k2_chunk(w)
    sp, lp, _ = k2_smem_bytes(0, cw)
    th_max = max(1, min(32, h, (K2_SMEM_CAP - K2_TABLE_BYTES) // (2 * sp + 4 * lp) - 2))
    ng = cw // 4
    best = None
    for th in range(1, th_max + 1):
        n_tiles = batch * -(-h // th) * n_ct
        per_tile = (-(-th * ng // K2_THREADS)
                    + 0.3 * -(-(th + 2) * lp // K2_THREADS) + 1)
        # the card's issue rate bounds a large launch; a small one takes at
        # least one tile's time
        cost = max(n_tiles * per_tile / (K2_SMS * K2_BLOCKS_PER_SM), per_tile)
        if best is None or cost < best[0]:
            best = (cost, th)
    th = best[1] if tile_h is None else max(1, min(int(tile_h), h))
    sp, lp, smem = k2_smem_bytes(th, cw)
    n_rt = -(-h // th)
    per_sm = _k2_blocks_per_sm(smem)
    return K2Plan(tile_h=th, chunk_w=cw, n_row_tiles=n_rt, n_col_chunks=n_ct,
                  stage_pitch=sp, luma_pitch=lp, smem_bytes=smem,
                  blocks=min(batch * n_rt * n_ct, K2_SMS * per_sm))


@lru_cache(maxsize=256)
def _k2_launch_ints(b: int, h: int, w: int) -> Tuple[int, ...]:
    """The 13 int arguments of ``flyimg_saliency_field`` for a shape."""
    plan = k2_plan(b, h, w)
    return (b, h, w, plan.tile_h, plan.chunk_w, plan.stage_pitch,
            plan.luma_pitch, plan.smem_bytes, plan.blocks) + k2_thresholds()


_K2_TABLES: Dict[torch.device, torch.Tensor] = {}


def _k2_tables(device: torch.device) -> torch.Tensor:
    tables = _K2_TABLES.get(device)
    if tables is None:
        tables = torch.frombuffer(bytearray(k2_table_bytes()), dtype=torch.uint8).to(device)
        _K2_TABLES[device] = tables
    return tables


def _batched_weighted(images: torch.Tensor, in_true: torch.Tensor) -> torch.Tensor:
    """[B, bh, bw, 3] u8 + [B, 2] f32 valid dims -> [B, bh, bw] f32
    weighted scoring fields, zero outside each member's valid region (so
    box sums and totals over the padded array are exact). The valid dims
    are whole numbers no larger than the bucket. Kernel K2 on a CUDA
    tensor, ``batched_weighted_plain`` on a CPU tensor."""
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(
            f"_batched_weighted takes u8 [B, H, W, 3], got {images.dtype} "
            f"{tuple(images.shape)}"
        )
    b, h, w, _ = images.shape
    if (
        in_true.shape != (b, 2) or in_true.dtype != torch.float32
        or in_true.device != images.device
    ):
        raise ValueError(
            f"in_true must be f32 [{b}, 2] on {images.device}, got "
            f"{in_true.dtype} {tuple(in_true.shape)} on {in_true.device}"
        )
    if images.device.type == "cpu":
        return batched_weighted_plain(images, in_true)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    images = images.contiguous()
    in_true = in_true.contiguous()
    out = torch.empty((b, h, w), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    lib = _lib("saliency")
    rc = lib.flyimg_saliency_field(
        images.data_ptr(), _k2_tables(images.device).data_ptr(),
        in_true.data_ptr(), out.data_ptr(), *_k2_launch_ints(b, h, w),
        torch.cuda.current_stream(images.device).cuda_stream,
    )
    cuda_build.check(rc, "_batched_weighted")
    _batched_weighted.launches += 1
    return out


#: K2 launches since the last reset (a plain integer)
_batched_weighted.launches = 0


# ---------------------------------------------------------------------------
# candidate scoring (plain version of kernel K3)
# ---------------------------------------------------------------------------


def batched_scores_plain(weighted: torch.Tensor, kernels: torch.Tensor, stride: int):
    """The plain PyTorch version of kernel K3: the correlation one window
    row at a time (each row an f32 contraction over the window columns),
    summed over rows in order."""
    b, fh, fw = weighted.shape
    khm, kwm, c = kernels.shape[1], kernels.shape[2], kernels.shape[4]
    ny = (fh - khm) // stride + 1
    nx = (fw - kwm) // stride + 1
    ker = kernels[:, :, :, 0, :].expand(b, khm, kwm, c)
    grids = torch.zeros((b, ny, nx, c), dtype=torch.float32, device=weighted.device)
    for ky in range(khm):
        rows = weighted[:, ky: ky + (ny - 1) * stride + 1: stride, :]
        win = rows.unfold(2, kwm, stride)[:, :, :nx]        # [B, ny, nx, kwm]
        grids = grids + torch.einsum("byxk,bkc->byxc", win, ker[:, ky])
    totals = weighted.sum(dim=(1, 2))
    return grids, totals


#: K3's launch constants (csrc/scores.cu): threads a block, the compiled
#: run lengths R (outputs a thread holds), and the threads a launch aims for
#: so the card's 132 SMs each get about half their 2048
K3_THREADS = 256
K3_RUN_LENGTHS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 19)
K3_TARGET_THREADS = 132 * 1024


@dataclass(frozen=True)
class K3Plan:
    """One K3 launch: each thread holds ``run`` consecutive outputs of one
    (member, output row, channel) and sums one phase of one chunk of
    ``ky_chunk`` window rows; ``groups_per_block`` output runs share a block,
    whose ``n_ky_chunks * stride`` parts of each run are added in order."""

    run: int
    ky_chunk: int
    n_ky_chunks: int
    groups_per_block: int
    threads: int
    blocks: int


def k3_plan(batch: int, ny: int, nx: int, khm: int, kwm: int, c: int,
            stride: int) -> K3Plan:
    """Pick K3's launch from the correlation's shapes: the compiled run
    length with the fewest instructions (R FMAs and about three other
    instructions a tap step, steps and runs rounded up), then as many
    window-row chunks as it takes to reach ``K3_TARGET_THREADS``."""
    if min(batch, ny, nx, khm, kwm, c, stride) < 1:
        raise ValueError(f"K3 plan of empty shapes {(batch, ny, nx, khm, kwm, c, stride)}")
    if stride > K3_THREADS:
        raise ValueError(f"K3 takes a stride of at most {K3_THREADS}, got {stride}")
    n_steps = -(-kwm // stride)

    def work(r):
        return -(-nx // r) * (r + 3) * (-(-n_steps // r) * r)

    run = min(K3_RUN_LENGTHS, key=lambda r: (work(r), -r))
    groups = batch * ny * (-(-nx // run)) * c
    n_kyc = -(-K3_TARGET_THREADS // (groups * stride))
    n_kyc = max(1, min(n_kyc, khm, K3_THREADS // stride))
    ky_chunk = -(-khm // n_kyc)
    n_kyc = -(-khm // ky_chunk)
    parts = n_kyc * stride
    gpb = K3_THREADS // parts
    return K3Plan(run=run, ky_chunk=ky_chunk, n_ky_chunks=n_kyc,
                  groups_per_block=gpb, threads=gpb * parts,
                  blocks=-(-groups // gpb))


def _batched_scores(weighted: torch.Tensor, kernels: torch.Tensor, stride: int):
    """[B, fh, fw] f32 fields x [B or 1, khm, kwm, 1, C] f32 kernel stacks
    -> ([B, ny, nx, C] candidate grids, [B] field totals): the strided
    VALID cross-correlation at f32. A kernel stack with leading dim 1 is
    shared by every member. Channel c < S is the scale-c importance kernel,
    channel S+c its box-sum ones mask; both zero-padded to the (khm, kwm)
    bucket, which contributes exactly nothing over a zero-padded field.
    Kernel K3 on a CUDA tensor, ``batched_scores_plain`` on a CPU tensor."""
    if weighted.dtype != torch.float32 or weighted.dim() != 3:
        raise ValueError(
            f"_batched_scores takes f32 [B, fh, fw] fields, got "
            f"{weighted.dtype} {tuple(weighted.shape)}"
        )
    b, fh, fw = weighted.shape
    if (
        kernels.dtype != torch.float32 or kernels.dim() != 5
        or kernels.shape[0] not in (1, b) or kernels.shape[3] != 1
        or kernels.device != weighted.device
    ):
        raise ValueError(
            f"kernels must be f32 [{b} or 1, khm, kwm, 1, C] on "
            f"{weighted.device}, got {kernels.dtype} "
            f"{tuple(kernels.shape)} on {kernels.device}"
        )
    khm, kwm, c = kernels.shape[1], kernels.shape[2], kernels.shape[4]
    if khm > fh or kwm > fw:
        raise ValueError(f"kernel {(khm, kwm)} larger than field {(fh, fw)}")
    stride = int(stride)
    if weighted.device.type == "cpu":
        return batched_scores_plain(weighted, kernels, stride)
    if weighted.device.type != "cuda":
        raise ValueError(f"unsupported device {weighted.device}")
    weighted = weighted.contiguous()
    kernels = kernels.contiguous()
    ny = (fh - khm) // stride + 1
    nx = (fw - kwm) // stride + 1
    grids = torch.empty((b, ny, nx, c), dtype=torch.float32, device=weighted.device)
    totals = torch.empty((b,), dtype=torch.float32, device=weighted.device)
    plan = k3_plan(b, ny, nx, khm, kwm, c, stride)
    lib = _lib("scores")
    rc = lib.flyimg_candidate_scores(
        weighted.data_ptr(), kernels.data_ptr(), grids.data_ptr(),
        totals.data_ptr(), b, fh, fw, khm, kwm, c,
        1 if kernels.shape[0] == 1 else 0, stride, ny, nx,
        plan.run, plan.ky_chunk, plan.groups_per_block,
        torch.cuda.current_stream(weighted.device).cuda_stream,
    )
    cuda_build.check(rc, "_batched_scores")
    _batched_scores.launches += 1
    return grids, totals


#: K3 launches since the last reset (a plain integer)
_batched_scores.launches = 0

_ARGTYPES = {
    "saliency": ("flyimg_saliency_field", "pppp" + "i" * 13 + "p"),
    "scores": ("flyimg_candidate_scores", "pppp" + "i" * 13 + "p"),
}


def _lib(name: str):
    lib = cuda_build.load(name)
    if not getattr(lib, "_flyimg_bound", False):
        fn_name, sig = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = [
            ctypes.c_void_p if ch == "p" else ctypes.c_int for ch in sig
        ]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


# ---------------------------------------------------------------------------
# host bookkeeping (reference smartcrop.py:137-191 crop() + :353-377 main())
# ---------------------------------------------------------------------------


def _host_thumbnail(rgb: np.ndarray, w: int, h: int) -> np.ndarray:
    """Pillow's LANCZOS resize, byte for byte, without Pillow."""
    return lanczos_resize(rgb, max(w, 1), max(h, 1))


def apply_crop(rgb: np.ndarray, crop: Dict[str, int]) -> np.ndarray:
    """Apply a found crop the way the reference pipeline does
    (SmartCropProcessor.php:21-36): the reference prints "WxH+X+Y" with
    W = x + width, H = y + height (smartcrop.py:372-377 — the bottom-right
    corner, not the size) and IM's -crop clamps the oversized region to the
    image bounds; reproduce both quirks exactly."""
    img_h, img_w = rgb.shape[:2]
    geom_w = crop["width"] + crop["x"]
    geom_h = crop["height"] + crop["y"]
    x0 = min(crop["x"], img_w)
    y0 = min(crop["y"], img_h)
    x1 = min(x0 + geom_w, img_w)
    y1 = min(y0 + geom_h, img_h)
    return rgb[y0:y1, x0:x1]


def entropy_crop_image(rgb: np.ndarray) -> np.ndarray:
    """The brownout stand-in for the smart-crop scoring (runtime/
    brownout.py): the same square answer, a side-``min(h, w)`` window,
    chosen on the host with no device work. The window slides along the
    long axis on the scorer's stride-8 grid and lands where the summed
    luma gradient |d luma| is highest, near-ties going to the most central
    offset. numpy, the JAX package's arithmetic."""
    h, w = rgb.shape[:2]
    side = min(h, w)
    if h == w:
        return rgb
    luma = rgb.astype(np.float32).mean(axis=2)
    axis = 0 if h > w else 1
    # each line's energy along the long axis, then window sums by a cumsum
    grad = np.abs(np.diff(luma, axis=axis)).sum(axis=1 - axis)
    grad = np.concatenate([grad, [0.0]])
    csum = np.concatenate([[0.0], np.cumsum(grad)])
    span = (h if axis == 0 else w) - side
    offsets = np.arange(0, span + 1, 8)
    if offsets[-1] != span:
        offsets = np.concatenate([offsets, [span]])
    window = csum[offsets + side] - csum[offsets]
    # a flat image would pick the first offset: the centre wins near-ties
    best = window.max()
    near = offsets[window >= best * 0.999999]
    off = int(near[np.argmin(np.abs(near - span / 2.0))])
    if axis == 0:
        return np.ascontiguousarray(rgb[off:off + side])
    return np.ascontiguousarray(rgb[:, off:off + side])


@dataclass(frozen=True)
class WorkItem:
    """Everything the batched scorer needs about one image: the prescaled
    work pixels plus the crop-geometry bookkeeping of find_best_crop()."""

    work: np.ndarray                 # [wh, ww, 3] uint8 prescaled image
    prescale_size: float
    crop_w: float                    # base crop dims in work coords
    crop_h: float
    scales: Tuple[float, ...]        # candidate scale multipliers
    step: int
    img_w: int
    img_h: int
    bucket: Tuple[int, int]          # padded (h, w) bucket


def prepare_work(
    rgb: np.ndarray,
    target_w: int = 100,
    target_h: int = 100,
    *,
    min_scale: float = 0.9,
    max_scale: float = 1.0,
    scale_step: float = 0.1,
    step: int = 8,
) -> WorkItem:
    """The host-side prescale bookkeeping of find_best_crop(), split out so
    the device part can batch across requests."""
    from flyimg_tpu_torch.ops.compose import _bucket_dim

    img_h, img_w = rgb.shape[:2]
    scale = min(img_w / target_w, img_h / target_h)
    crop_w = int(math.floor(target_w * scale))
    crop_h = int(math.floor(target_h * scale))
    mscale = min(max_scale, max(1.0 / scale, min_scale))

    prescale_size = 1.0 / scale / mscale
    work = rgb
    if prescale_size < 1.0:
        work = _host_thumbnail(
            rgb, int(img_w * prescale_size), int(img_h * prescale_size)
        )
        crop_w = int(math.floor(crop_w * prescale_size))
        crop_h = int(math.floor(crop_h * prescale_size))
    else:
        prescale_size = 1.0

    scales = tuple(
        pct / 100.0
        for pct in range(
            int(max_scale * 100),
            int((mscale - scale_step) * 100),
            -int(scale_step * 100),
        )
    )
    wh, ww = work.shape[:2]
    bucket = (_bucket_dim(wh, 32), _bucket_dim(ww, 32))
    return WorkItem(
        work=np.ascontiguousarray(work),
        prescale_size=prescale_size,
        crop_w=float(crop_w),
        crop_h=float(crop_h),
        scales=scales,
        step=step,
        img_w=img_w,
        img_h=img_h,
        bucket=bucket,
    )


def _crop_from_best(best, item: WorkItem) -> Dict[str, int]:
    """(score, x, y, cw, ch) in work coords -> source-coords crop dict;
    None (degenerate image smaller than any candidate) -> whole image."""
    if best is None:
        return {"x": 0, "y": 0, "width": item.img_w, "height": item.img_h}
    _, x, y, cw, ch = best
    ps = item.prescale_size
    return {
        "x": int(math.floor(x / ps)),
        "y": int(math.floor(y / ps)),
        "width": int(math.floor(cw / ps)),
        "height": int(math.floor(ch / ps)),
    }


def _member_scale_geometry(item: WorkItem, s: float):
    """(cw, ch, max_x, max_y) for one candidate scale, or None when the
    scale is skipped (find_best_crop's `continue` guards)."""
    cw = item.crop_w * s
    ch = item.crop_h * s
    if cw < 1.0 or ch < 1.0:
        return None
    wh, ww = item.work.shape[:2]
    max_x = int((ww - cw) // item.step) * item.step
    max_y = int((wh - ch) // item.step) * item.step
    if max_x < 0 or max_y < 0:
        return None
    return cw, ch, max_x, max_y


def find_best_crops_batched(
    items: Sequence[WorkItem], device: Union[str, torch.device] = "cuda"
) -> List[Dict[str, int]]:
    """Crops for many images, one batched pair of device launches (K2,
    K3) per shape bucket. Padding is zeros that cancel out of every
    correlation and sum, and the per-member float crop dims ride in the
    kernels, so the result equals per-image scoring."""
    dev = resolve_device(device)
    results: List[Dict[str, int]] = [None] * len(items)  # type: ignore
    by_bucket = defaultdict(list)
    for i, item in enumerate(items):
        by_bucket[(item.bucket, item.step)].append(i)
    for (bucket, step), idxs in by_bucket.items():
        crops = _run_bucket([items[i] for i in idxs], bucket, step, dev)
        for i, crop in zip(idxs, crops):
            results[i] = crop
    return results


def score_bucket(
    items: Sequence[WorkItem], bucket: Tuple[int, int], step: int,
    device: torch.device,
):
    """The device half of one bucket: (grids, totals, geoms, n_scales) with
    grids/totals as host arrays."""
    from flyimg_tpu_torch.ops.compose import _bucket_dim, bucket_batch

    n = len(items)
    # batch axis rides the power-of-two ladder (pad slots repeat the last
    # member) so a handful of shapes serve every occupancy
    nb = bucket_batch(n)
    bh, bw = bucket
    images = np.zeros((nb, bh, bw, 3), np.uint8)
    in_true = np.zeros((nb, 2), np.float32)
    for i, item in enumerate(items):
        wh, ww = item.work.shape[:2]
        images[i, :wh, :ww] = item.work
        in_true[i] = (wh, ww)
    for i in range(n, nb):
        images[i] = images[n - 1]
        in_true[i] = in_true[n - 1]
    weighted = _batched_weighted(
        torch.from_numpy(images).to(device), torch.from_numpy(in_true).to(device)
    )

    n_scales = max(len(item.scales) for item in items)
    kh_max = kw_max = 1
    y_max = x_max = 0
    geoms = []
    for item in items:
        per_scale = []
        for s in item.scales:
            geom = _member_scale_geometry(item, s)
            per_scale.append(geom)
            if geom is None:
                continue
            cw, ch, mx, my = geom
            kh_max = max(kh_max, int(math.ceil(ch)))
            kw_max = max(kw_max, int(math.ceil(cw)))
            y_max = max(y_max, my)
            x_max = max(x_max, mx)
        geoms.append(per_scale)
    khm = _bucket_dim(kh_max, 16)
    kwm = _bucket_dim(kw_max, 16)
    # the VALID grid must reach every candidate position: grow the
    # (zero-padded, score-neutral) field so (fh - khm)//step covers y_max
    fh = max(bh, _bucket_dim(y_max + khm, 32))
    fw = max(bw, _bucket_dim(x_max + kwm, 32))
    if (fh, fw) != (bh, bw):
        weighted = torch.nn.functional.pad(weighted, (0, fw - bw, 0, fh - bh))

    kernels = np.zeros((nb, khm, kwm, 1, 2 * n_scales), np.float32)
    for i, item in enumerate(items):
        for si, geom in enumerate(geoms[i]):
            if geom is None:
                continue
            cw, ch, _, _ = geom
            ker = importance_kernel(cw, ch)
            kh, kw = ker.shape
            kernels[i, :kh, :kw, 0, si] = ker
            kernels[i, :kh, :kw, 0, n_scales + si] = 1.0
    for i in range(n, nb):
        kernels[i] = kernels[n - 1]

    grids, totals = _batched_scores(
        weighted, torch.from_numpy(kernels).to(device), stride=step
    )
    return grids.cpu().numpy(), totals.cpu().numpy(), geoms, n_scales


def _run_bucket(
    items: Sequence[WorkItem], bucket: Tuple[int, int], step: int,
    device: torch.device,
) -> List[Dict[str, int]]:
    grids, totals, geoms, n_scales = score_bucket(items, bucket, step, device)
    out: List[Dict[str, int]] = []
    for i, item in enumerate(items):
        best = None
        for si, geom in enumerate(geoms[i]):
            if geom is None:
                continue
            cw, ch, mx, my = geom
            ny = my // step + 1
            nx = mx // step + 1
            inside = grids[i, :ny, :nx, si]
            boxsum = grids[i, :ny, :nx, n_scales + si]
            scores = (
                inside + OUTSIDE_IMPORTANCE * (totals[i] - boxsum)
            ) / (cw * ch)
            if scores.size == 0:
                continue
            idx = np.unravel_index(np.argmax(scores), scores.shape)
            top = float(scores[idx])
            if best is None or top > best[0]:
                best = (top, idx[1] * step, idx[0] * step, cw, ch)
        out.append(_crop_from_best(best, item))
    return out


def find_best_crop(
    rgb: np.ndarray,
    target_w: int = 100,
    target_h: int = 100,
    *,
    min_scale: float = 0.9,
    max_scale: float = 1.0,
    scale_step: float = 0.1,
    step: int = 8,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, int]:
    """Best crop of [h, w, 3] uint8 -> dict(x, y, width, height), in source
    pixel coords: the batched path at batch 1."""
    item = prepare_work(
        rgb, target_w, target_h, min_scale=min_scale, max_scale=max_scale,
        scale_step=scale_step, step=step,
    )
    return find_best_crops_batched([item], device=device)[0]


def smart_crop_image(
    rgb: np.ndarray, device: Union[str, torch.device] = "cuda"
) -> np.ndarray:
    """The single-image post-pass: crop `rgb` like the reference's
    `smartcrop.py | convert -crop` pipeline (100x100 target)."""
    return apply_crop(rgb, find_best_crop(rgb, 100, 100, device=device))
