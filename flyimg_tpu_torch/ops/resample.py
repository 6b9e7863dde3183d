"""Windowed separable resampling on PyTorch: dense matmuls or a banded kernel.

The port of ``flyimg_tpu/ops/resample.py``. The whole geometry chain of a
request — extract crop, fill-resize, gravity crop — collapses into ONE
windowed resample per axis: output sample i reads source position

    x(i) = span_start + (i + 0.5) * span_size / out_true - 0.5

(clamped to [0, in_true - 1]), so a crop is a span smaller than the image
and a resize is out != span. Every geometry input is a per-member tensor,
so one program serves every source size in a padded bucket.

Two formulations, chosen per plan by ``select_band_taps`` from the
process-wide ``kernel_mode`` (the ``resample_kernel`` knob):

- **dense** (``resample_image``): per-axis [out, in] weight matrices, then
  two f32 ``torch.matmul``s. A plain large matrix product, left to the
  library as the JAX package leaves it to XLA.
- **banded** (``resample_banded_u8``, or ``resample_banded_f32`` when a
  program stage follows the resample): a static K-tap band per output
  sample, weights from the UNCLIPPED tap positions with out-of-range taps
  zeroed before renormalising (docs/kernels.md "the unclipped-tap
  invariant"). On a CUDA tensor this is kernel K1
  (``csrc/resample_banded.cu``), which fuses the u8 load, both band passes
  and the round/clip/u8 store (or stores the f32 result); on a CPU tensor
  it is the plain PyTorch version ``resample_image_banded`` in this module.

Filter kernels mirror ImageMagick's resize filters (lanczos3, triangle,
gaussian, Mitchell cubic, box, nearest); downscale antialiasing stretches
the kernel by the scale factor and renormalises. Taps at or beyond
``in_true`` get zero weight, so zero-padded buckets are invisible.
"""

from __future__ import annotations

import ctypes
import math
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import torch

from flyimg_tpu_torch import cuda_build

# Filter support radii: the half-width of _kernel_fn's nonzero region.
# The K-from-support computation below is THE source of truth for band
# widths in this package (ops/compose.py, runtime/batcher.py, entry.py).
FILTER_SUPPORT = {
    "lanczos3": 3.0,
    "triangle": 1.0,
    "gaussian": 1.5,
    "cubic": 2.0,
    "box": 0.5,
    "nearest": 0.5,
}

#: serving-wide resample formulation: 'dense' (the shipped [out, in]
#: matrix einsums), 'banded' (static K-tap gather-contract), or 'auto'
#: (banded whenever the band is narrower than the dense matrix). The env
#: var seeds the default so offline tools can flip the variant without
#: config plumbing; the ``resample_kernel`` appconfig knob overrides it at
#: app construction (service/app.py).
KERNEL_MODES = ("dense", "banded", "auto")
_kernel_mode = os.environ.get("FLYIMG_RESAMPLE_KERNEL", "dense")
if _kernel_mode not in KERNEL_MODES:
    # a typo'd env seed must not become a request-time ValueError deep
    # in submit; the knob path (set_kernel_mode) still raises loudly
    _kernel_mode = "dense"


def kernel_mode() -> str:
    """The current process-wide resample-kernel mode."""
    return _kernel_mode


def set_kernel_mode(mode: str) -> str:
    """Set the process-wide resample-kernel mode (dense|banded|auto).
    Process-wide like the program caches the choice keys into: two apps
    in one process share it, last writer wins."""
    global _kernel_mode
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"resample_kernel must be one of {KERNEL_MODES}, got {mode!r}"
        )
    _kernel_mode = mode
    return _kernel_mode


#: ``mode='auto'`` worth-it threshold: band only when each axis's K is
#: strictly narrower than ``frac * axis``. 1.0 is the shipped policy
#: (band whenever the band is narrower at all); lowering it keeps marginal
#: geometries dense. The fraction steers SELECTION only; it is never part
#: of program identity (the selected band_taps is what every cache and
#: group key carries), so tuning it can't alias two different programs.
_auto_band_frac = 1.0
AUTO_BAND_FRAC_MIN = 0.1


def auto_band_frac() -> float:
    """The current ``auto``-mode band-width threshold fraction."""
    return _auto_band_frac


def set_auto_band_frac(frac: float) -> float:
    """Set the ``auto``-mode worth-it fraction, clamped to
    [AUTO_BAND_FRAC_MIN, 1.0]. Process-wide like ``set_kernel_mode``."""
    global _auto_band_frac
    _auto_band_frac = min(max(float(frac), AUTO_BAND_FRAC_MIN), 1.0)
    return _auto_band_frac


def band_taps(method: str, scale: float) -> int:
    """Exact taps one output sample needs at ``scale`` (= span/out; > 1
    is a downscale). Downscale antialiasing stretches the kernel by the
    scale factor, so the tap count grows with it: taps sit at integer
    positions within ``support * max(scale, 1)`` of the sample point, and
    a band of ``2*ceil(R) + 2`` centered at ``floor(x)`` covers every
    such position for any fractional x (the +2 absorbs the worst-case
    fractional offset on both sides)."""
    support = FILTER_SUPPORT.get(method, 3.0)
    radius = support * max(float(scale), 1.0)
    return int(2 * math.ceil(radius)) + 2


def bucket_taps(taps: int) -> int:
    """Round a tap count up the power-of-two ladder (floor 8) so a
    handful of band widths serve every geometry — the same bucketing
    philosophy as the batch-size ladder (ops/compose.py bucket_batch)."""
    return max(8, 1 << max(int(taps) - 1, 0).bit_length())


def select_band_taps(
    mode: str,
    method: str,
    in_hw: Tuple[int, int],
    span_y: Tuple[float, float],
    span_x: Tuple[float, float],
    out_true_hw: Tuple[float, float],
) -> Optional[Tuple[int, int]]:
    """Host-side kernel-variant policy for one plan geometry: the static
    per-axis band widths ``(Ky, Kx)`` for the banded path, or ``None``
    for dense. Called at submit time (runtime/batcher.py) and by the
    single-image path (ops/compose.py run_plan) with the member's true
    geometry, so K is dynamic per *program* and static per *compile* —
    the result is part of the program-cache key and the batch group key.

    ``mode='banded'`` always bands (K clamped to the bucket axis — a
    band as wide as the axis is just a permuted dense contract);
    ``mode='auto'`` bands only when BOTH axes' bands are strictly
    narrower than ``auto_band_frac()`` of the dense matrices they
    replace (the shipped fraction 1.0 = "narrower at all")."""
    if mode == "dense":
        return None
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"resample_kernel must be one of {KERNEL_MODES}, got {mode!r}"
        )
    in_h, in_w = int(in_hw[0]), int(in_hw[1])
    out_h = max(float(out_true_hw[0]), 1.0)
    out_w = max(float(out_true_hw[1]), 1.0)
    ky = bucket_taps(band_taps(method, float(span_y[1]) / out_h))
    kx = bucket_taps(band_taps(method, float(span_x[1]) / out_w))
    frac = _auto_band_frac
    if mode == "auto" and not (ky < in_h * frac and kx < in_w * frac):
        return None
    return (min(ky, max(in_h, 1)), min(kx, max(in_w, 1)))




# ---------------------------------------------------------------------------
# kernel K1's launch plan (host side; csrc/resample_banded.cu takes it as is)
# ---------------------------------------------------------------------------

K1_THREADS = 256
#: output rows one thread's vertical accumulators cover (the kernel's K1_SUB)
K1_SUB = 4
#: shared memory a block may take, and the share aimed for (3 blocks an SM)
K1_SMEM_LIMIT = 227 * 1024
K1_SMEM_TARGET = 72 * 1024
#: horizontal band widths compiled as constants; any other K runs the
#: run-time-K instance (0)
K1_STATIC_KX = (8, 16, 32)
K1_TILE_HEIGHTS = (4, 8, 12, 16)
#: most source rows of the dense vertical weight table held at once, most
#: bytes of staged column weights, most bytes of a run's staged row weights,
#: and most output rows in a block's run of row tiles
K1_ROW_CHUNK_MAX = 256
K1_STAGE_MAX = 32 * 1024
K1_STAGE_WY_MAX = 16 * 1024
K1_RUN_ROWS_MAX = 256
#: the card's SMs and the K1 blocks one SM holds at the target shared
#: memory; a launch aims for ``K1_WAVES`` waves of blocks
K1_SMS = 132
K1_BLOCKS_PER_SM = 3
K1_WAVES = 8


@dataclass(frozen=True)
class K1Plan:
    """One K1 launch: tiles of tile_h output rows x tile_w output columns;
    a block takes ``tiles_per_block`` row tiles of one column tile of a
    member, one after another. ``chunk_w`` source columns and ``row_chunk``
    source rows are staged per pass; a tile whose source window is larger
    takes several passes (the kernel finds each window on the card).
    ``stage_wx`` stages the column weights in shared memory, ``stage_wy``
    the row weights of the block's run of tiles."""

    tile_h: int
    tile_w: int
    chunk_w: int
    row_chunk: int
    stage_wx: bool
    stage_wy: bool
    kx_static: int
    tiles_per_block: int
    smem_bytes: int
    grid: Tuple[int, int]


def _k1_vs_pitch(chunk_w: int) -> int:
    """Row pitch (floats) of the vertical-pass buffer: the chunk's bytes
    from its first whole source word, float4-aligned."""
    return (3 * chunk_w + 8 + 3) & ~3


def _k1_os_pitch(tile_w: int) -> int:
    """Row pitch (bytes) of the u8 output staging: a row shifted by its
    destination's offset within a 32-bit word, 16-byte aligned."""
    return (3 * tile_w + 3 + 15) & ~15


def k1_smem_bytes(tile_h, tile_w, chunk_w, row_chunk, ky, kx, stage_wx,
                  stage_wy=False, tiles_per_block=1) -> int:
    """Bytes of shared memory one block takes: the dense vertical weights
    [row_chunk, tile_h], the vertical pass [tile_h, pitch], the horizontal
    partial sums [tile_h, tile_w * 3], the run's row weights [run rows, ky]
    when staged, the u8 output staging, the staged column weights [tile_w,
    kx | 1] (an odd pitch, against bank conflicts) and the band starts of
    the run's rows and the tile's columns."""
    run_rows = tiles_per_block * tile_h
    return (4 * (row_chunk * tile_h + tile_h * _k1_vs_pitch(chunk_w)
                 + tile_h * tile_w * 3 + (run_rows * ky if stage_wy else 0)
                 + (tile_w * (kx | 1) if stage_wx else 0) + run_rows + tile_w)
            + tile_h * _k1_os_pitch(tile_w))


def _k1_window(n_out_tile: int, q: float, taps: int, n_in: int) -> int:
    """Expected source extent of a tile of ``n_out_tile`` consecutive
    outputs at scale q (span / out) with K taps, within the axis."""
    return min(int(math.ceil((n_out_tile - 1) * q)) + taps + 1, n_in)


@lru_cache(maxsize=256)
def k1_plan(in_hw: Tuple[int, int], out_hw: Tuple[int, int],
            taps_hw: Tuple[int, int], batch: int) -> K1Plan:
    """Pick K1's tiles for a launch from its static shapes. The scale is
    estimated as bucket / output per axis (the true span lives on the
    card); a wrong estimate costs time, never correctness, since the
    kernel chunks any window larger than the plan's. Among the tile
    heights in ``K1_TILE_HEIGHTS`` and the column splits of the output, the
    plan with the fewest estimated instructions is taken whose shared memory
    stays within ``K1_SMEM_TARGET`` (``K1_SMEM_LIMIT`` if none does)."""
    in_h, in_w = int(in_hw[0]), int(in_hw[1])
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    ky, kx = int(taps_hw[0]), int(taps_hw[1])
    if min(in_h, in_w, out_h, out_w, ky, kx, batch) < 1:
        raise ValueError(f"K1 plan of empty shapes {in_hw} -> {out_hw} K={taps_hw}")
    qy, qx = in_h / out_h, in_w / out_w
    kx_static = kx if kx in K1_STATIC_KX else 0
    widths = sorted({-(-out_w // n) for n in range(1, out_w + 1)}, reverse=True)
    best = None
    for budget in (K1_SMEM_TARGET, K1_SMEM_LIMIT):
        for th in K1_TILE_HEIGHTS:
            rows = _k1_window(th, qy, ky, in_h)
            row_chunk = min(rows, K1_ROW_CHUNK_MAX)
            rows_sub = _k1_window(K1_SUB, qy, ky, in_h)
            for tw in widths:
                cols = _k1_window(tw, qx, kx, in_w)
                # the column weights are staged whenever they take at most
                # K1_STAGE_MAX (read from device memory they cost more than
                # a smaller chunk of columns does)
                stage = 4 * tw * (kx | 1) <= K1_STAGE_MAX
                # runs of row tiles: long enough to stage each column tile's
                # weights rarely, short enough for K1_WAVES waves of blocks
                n_rt, n_ct = -(-out_h // th), -(-out_w // tw)
                n_rg = max(1, min(n_rt, -(-K1_WAVES * K1_SMS * K1_BLOCKS_PER_SM
                                          // (batch * n_ct))))
                per_block = min(-(-n_rt // n_rg), K1_RUN_ROWS_MAX // th)
                stage_wy = 4 * per_block * th * ky <= K1_STAGE_WY_MAX
                room = budget - k1_smem_bytes(th, tw, 0, row_chunk, ky, kx, stage,
                                              stage_wy, per_block)
                chunk_w = min(cols, (room // (4 * th) - 11) // 3)
                if chunk_w < min(cols, 4):
                    continue
                smem = k1_smem_bytes(th, tw, chunk_w, row_chunk, ky, kx, stage,
                                     stage_wy, per_block)
                n_cc = -(-cols // chunk_w)
                n_rc = -(-rows // row_chunk)
                words = -(-3 * chunk_w // 4) + 1
                sweeps = -(-words * (-(-th // K1_SUB)) // K1_THREADS)
                vert = sweeps * rows_sub * 29 + (sweeps * n_rc if n_rc > 1 else 1) * (
                    -(-row_chunk * th // K1_THREADS)) * 8
                # column weights read from device memory: ~twice the time
                horiz = -(-th * tw // K1_THREADS) * (kx * 9 + 16) * (1 if stage else 2)
                store = th * (-(-3 * tw // (4 * K1_THREADS))) * 10
                tiles = batch * -(-out_h // th) * -(-out_w // tw)
                cost = tiles * (n_cc * (vert + horiz) + store + 40)
                if best is None or cost < best[0]:
                    best = (cost, K1Plan(
                        tile_h=th, tile_w=tw, chunk_w=chunk_w,
                        row_chunk=row_chunk, stage_wx=stage, stage_wy=stage_wy,
                        kx_static=kx_static, tiles_per_block=per_block,
                        smem_bytes=smem,
                        grid=(-(-n_rt // per_block) * n_ct, batch)))
        if best is not None:
            break
    else:
        raise ValueError(f"no K1 plan fits {in_hw} -> {out_hw} K={taps_hw}")
    return best[1]


def band_starts(
    in_size: int, out_size: int, taps: int, span_start: torch.Tensor,
    span_size: torch.Tensor, out_true: torch.Tensor, in_true: torch.Tensor,
) -> torch.Tensor:
    """The unclipped band start j0 [..., out] of every output sample, as
    K1's weight kernel computes it (0 when the band covers the axis)."""
    x, _ = _sample_positions(out_size, span_start, span_size, out_true, in_true)
    if taps >= in_size:
        return torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    return torch.floor(x).to(torch.int64) - taps // 2 + 1


def k1_tile_windows(plan: K1Plan, jy: torch.Tensor, jx: torch.Tensor,
                    in_hw: Tuple[int, int], taps_hw: Tuple[int, int]):
    """The source window of every K1 block as the kernel finds it, from the
    band starts ``jy`` [B, out_h] and ``jx`` [B, out_w]: a list, per
    member, of ((row lo, row hi), (col lo, col hi), row passes, column
    passes) for each (row tile, column tile), hi exclusive."""
    in_h, in_w = in_hw
    ky, kx = taps_hw
    out_h, out_w = jy.shape[1], jx.shape[1]
    th, tw = plan.tile_h, plan.tile_w
    result = []
    for b in range(jy.shape[0]):
        tiles = []
        for oy0 in range(0, out_h, th):
            t_last = min(oy0 + th, out_h) - 1
            rlo = max(int(jy[b, oy0]), 0)
            rhi = min(int(jy[b, t_last]) + ky, in_h)
            for ox0 in range(0, out_w, tw):
                x_last = min(ox0 + tw, out_w) - 1
                plo = min(max(int(jx[b, ox0]), 0), in_w - 1)
                phi = min(max(int(jx[b, x_last]) + kx - 1, 0), in_w - 1) + 1
                tiles.append((
                    (rlo, rhi), (plo, phi),
                    max(-(-(rhi - rlo) // plan.row_chunk), 1),
                    -(-(phi - plo) // plan.chunk_w),
                ))
        result.append(tiles)
    return result


#: filter name -> method code of csrc/resample_banded.cu
_METHOD_CODES = {
    "lanczos3": 0, "triangle": 1, "gaussian": 2, "cubic": 3, "box": 4,
    "nearest": 5,
}


def _kernel_fn(method: str, x: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if method == "lanczos3":
        return torch.where(
            x.abs() < 3.0, torch.sinc(x) * torch.sinc(x / 3.0), zero
        )
    if method == "triangle":
        return torch.clamp(1.0 - x.abs(), min=0.0)
    if method == "gaussian":
        # IM 'Gaussian': sigma 1/2, support 1.5 => exp(-2 x^2); the
        # amplitude cancels in the row renormalisation
        return torch.where(x.abs() < 1.5, torch.exp(-2.0 * x * x), zero)
    if method == "cubic":
        # Mitchell-Netravali B=C=1/3 (IM's general-purpose cubic)
        b, c = 1.0 / 3.0, 1.0 / 3.0
        ax = x.abs()
        ax2, ax3 = ax * ax, ax * ax * ax
        p1 = ((12 - 9 * b - 6 * c) * ax3 + (-18 + 12 * b + 6 * c) * ax2
              + (6 - 2 * b)) / 6.0
        p2 = ((-b - 6 * c) * ax3 + (6 * b + 30 * c) * ax2
              + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6.0
        return torch.where(ax < 1.0, p1, torch.where(ax < 2.0, p2, zero))
    if method in ("box", "nearest"):
        return ((x >= -0.5) & (x < 0.5)).to(x.dtype)
    raise ValueError(f"unknown resample method: {method}")


def _sample_positions(out_size, span_start, span_size, out_true, in_true,
                      fused: bool = False):
    """(x [..., out], stretch s [...]) for per-member geometry tensors of
    shape [...]; x is the clamped sample position of every output index.
    ``fused`` rounds ``start + (i + .5) q`` once, as one fused multiply-add:
    the reference's tiled programs are jitted, and XLA contracts it there."""
    i = torch.arange(out_size, dtype=torch.float32, device=span_start.device)
    q = span_size / torch.clamp(out_true, min=1.0)
    if fused:
        from flyimg_tpu_torch.ops.color import fma_f32

        x = fma_f32((i + 0.5).expand(q.shape + (out_size,)), q[..., None],
                    span_start[..., None].expand(q.shape + (out_size,))) - 0.5
    else:
        x = span_start[..., None] + (i + 0.5) * q[..., None] - 0.5
    hi = torch.clamp(in_true - 1.0, min=0.0)[..., None]
    x = torch.minimum(torch.clamp(x, min=0.0), hi)
    return x, torch.clamp(q, min=1.0)


def resample_matrix(
    in_size: int,
    out_size: int,
    span_start: torch.Tensor,
    span_size: torch.Tensor,
    out_true: torch.Tensor,
    in_true: torch.Tensor,
    method: str = "lanczos3",
    fused: bool = False,
) -> torch.Tensor:
    """Dense [..., out_size, in_size] weights for one axis, batched over
    the geometry tensors' leading shape [...]. ``in_size``/``out_size`` are
    the static (bucket) sizes; rows at i >= out_true are edge-replicated
    don't-cares (the host slices the valid region). ``fused`` as in
    ``_sample_positions``."""
    x, s = _sample_positions(out_size, span_start, span_size, out_true, in_true,
                             fused)
    j = torch.arange(in_size, dtype=torch.float32, device=x.device)
    if method == "nearest":
        # IM 'Point': one-hot at the floor-rounded sample position
        hi = torch.clamp(in_true - 1.0, min=0.0)[..., None]
        idx = torch.minimum(torch.clamp(torch.floor(x + 0.5), min=0.0), hi)
        return (j == idx[..., None]).to(torch.float32)
    d = (j - x[..., None]) / s[..., None, None]
    w = _kernel_fn(method, d)
    w = torch.where(j < in_true[..., None, None], w, torch.zeros_like(w))
    denom = w.sum(dim=-1, keepdim=True)
    return w / torch.where(denom == 0.0, torch.ones_like(denom), denom)


#: Weight-application form of the dense resample, as the JAX package's
#: ``RESAMPLE_FORM``: 'einsum' (the two f32 products below) or
#: 'fold2d_bf16' (``_apply_fold2d_bf16``), read once from the same
#: environment variable.
RESAMPLE_FORM = os.environ.get("FLYIMG_RESAMPLE_FORM", "einsum")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and held as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _apply_fold2d_bf16(image: torch.Tensor, wy: torch.Tensor,
                       wx: torch.Tensor) -> torch.Tensor:
    """The dense resample's two products on bf16 operands with f32
    accumulation, channels folded into the product's columns: [oh, h] @
    [h, w c], then [oh c, w] @ [w, ow], per member ([B, H, W, C] f32 image,
    [B, oh, h] and [B, ow, w] weights). The operands are rounded to bf16 and
    multiplied as f32 (TF32 off), where a product of two bf16 values is
    exact: the JAX package's ``preferred_element_type=f32`` arithmetic. A
    plain product the library computes, as XLA does for the reference."""
    b, h, w, c = image.shape
    out_h, out_w = wy.shape[1], wx.shape[1]
    tmp = torch.matmul(_bf16(wy), _bf16(image).reshape(b, h, w * c))
    t2 = _bf16(tmp).reshape(b, out_h, w, c).permute(0, 1, 3, 2).reshape(b, out_h * c, w)
    out = torch.matmul(t2, _bf16(wx).transpose(1, 2))
    return out.reshape(b, out_h, c, out_w).permute(0, 1, 3, 2)


def resample_image(
    image: torch.Tensor,
    out_hw: Tuple[int, int],
    span_y: torch.Tensor,
    span_x: torch.Tensor,
    out_true_hw: torch.Tensor,
    in_true_hw: torch.Tensor,
    method: str = "lanczos3",
) -> torch.Tensor:
    """Dense resample of a [B, H, W, C] f32 batch to [B, out_h, out_w, C].
    Geometry rows are per member: ``span_y``/``span_x`` (start, size),
    ``out_true_hw``/``in_true_hw`` (h, w), each [B, 2]. Two f32 matmuls:
    the H contraction, then the W contraction. The result is a permuted
    view of the second product."""
    b, in_h, in_w, c = image.shape
    out_h, out_w = out_hw
    wy = resample_matrix(
        in_h, out_h, span_y[:, 0], span_y[:, 1], out_true_hw[:, 0],
        in_true_hw[:, 0], method,
    )
    wx = resample_matrix(
        in_w, out_w, span_x[:, 0], span_x[:, 1], out_true_hw[:, 1],
        in_true_hw[:, 1], method,
    )
    if RESAMPLE_FORM == "fold2d_bf16":
        return _apply_fold2d_bf16(image, wy, wx)
    tmp = torch.matmul(wy, image.reshape(b, in_h, in_w * c))
    # W pass as one [out_w, W] @ [W, out_h * c] product per member
    tmp = tmp.reshape(b, out_h, in_w, c).permute(0, 2, 1, 3)
    out = torch.matmul(wx, tmp.reshape(b, in_w, out_h * c))
    return out.reshape(b, out_w, out_h, c).permute(0, 2, 1, 3)


def _band_axis(
    in_size: int,
    out_size: int,
    taps: int,
    span_start: torch.Tensor,
    span_size: torch.Tensor,
    out_true: torch.Tensor,
    in_true: torch.Tensor,
    method: str,
    in_lo: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded weights for one axis: ``(idx [..., out, K] int64, w [..., out,
    K] f32)`` for per-member geometry tensors of shape [...], with ``taps``
    (K) static. The K tap positions are the integer window centred at
    ``floor(x)``; weights come from the UNCLIPPED positions and taps outside
    [0, in_true) are zeroed before renormalising, so the nonzero weights are
    exactly the dense row restricted to the band. Gather indices are
    clipped to the static axis as don't-cares. ``in_lo`` (shaped like
    ``in_true``) zeroes the taps below it too: the tiled resample's
    lower valid row, whose sample positions round as the reference's jitted
    tiled program rounds them (``_sample_positions``'s ``fused``)."""
    x, s = _sample_positions(out_size, span_start, span_size, out_true, in_true,
                             in_lo is not None)
    k = torch.arange(taps, dtype=torch.int64, device=x.device)
    if taps >= in_size:
        # the band covers the whole axis: the full axis in index order,
        # identical weights to the dense matrix
        j = torch.broadcast_to(
            torch.arange(in_size, dtype=torch.int64, device=x.device),
            x.shape + (in_size,),
        )
    else:
        j0 = torch.floor(x).to(torch.int64) - taps // 2 + 1
        j = j0[..., None] + k
    jf = j.to(torch.float32)
    if method == "nearest":
        hi = torch.clamp(in_true - 1.0, min=0.0)[..., None]
        near = torch.minimum(torch.clamp(torch.floor(x + 0.5), min=0.0), hi)
        w = jf == near[..., None]
        if in_lo is not None:
            w = w & (jf >= in_lo[..., None, None])
        return torch.clamp(j, 0, in_size - 1), w.to(torch.float32)
    d = (jf - x[..., None]) / s[..., None, None]
    w = _kernel_fn(method, d)
    inside = (j >= 0) & (jf < in_true[..., None, None])
    if in_lo is not None:
        inside = inside & (jf >= in_lo[..., None, None])
    w = torch.where(inside, w, torch.zeros_like(w))
    denom = w.sum(dim=-1, keepdim=True)
    return (
        torch.clamp(j, 0, in_size - 1),
        w / torch.where(denom == 0.0, torch.ones_like(denom), denom),
    )


def resample_image_banded(
    image: torch.Tensor,
    out_hw: Tuple[int, int],
    span_y: torch.Tensor,
    span_x: torch.Tensor,
    out_true_hw: torch.Tensor,
    in_true_hw: torch.Tensor,
    taps_hw: Tuple[int, int],
    method: str = "lanczos3",
    row_lo: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Banded K-tap resample of a [B, H, W, C] f32 batch to [B, out_h,
    out_w, C] — the plain PyTorch version of kernel K1 (before its u8
    epilogue). Rows are gathered and contracted over Ky, then columns over
    Kx, one tap at a time in tap order (K1's order). ``row_lo`` [B] is
    each member's lowest valid source row (None: 0)."""
    b, in_h, in_w, c = image.shape
    out_h, out_w = out_hw
    iy, wy = _band_axis(
        in_h, out_h, int(taps_hw[0]), span_y[:, 0], span_y[:, 1],
        out_true_hw[:, 0], in_true_hw[:, 0], method, row_lo,
    )
    ix, wx = _band_axis(
        in_w, out_w, int(taps_hw[1]), span_x[:, 0], span_x[:, 1],
        out_true_hw[:, 1], in_true_hw[:, 1], method,
    )
    bidx = torch.arange(b, device=image.device)[:, None]
    tmp = torch.zeros((b, out_h, in_w, c), dtype=torch.float32,
                      device=image.device)
    for k in range(iy.shape[-1]):
        tmp = tmp + wy[:, :, k, None, None] * image[bidx, iy[:, :, k]]
    out = torch.zeros((b, out_h, out_w, c), dtype=torch.float32,
                      device=image.device)
    for k in range(ix.shape[-1]):
        out = out + wx[:, None, :, k, None] * tmp[bidx, :, ix[:, :, k]].permute(
            0, 2, 1, 3
        )
    return out


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """round (half to even) -> clip -> u8: the program epilogue."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _geometry(span_y, span_x, out_true_hw, in_true_hw) -> torch.Tensor:
    """[B, 8] f32 rows: span_y, span_x, out_true (h, w), in_true (h, w)."""
    return torch.cat(
        [span_y, span_x, out_true_hw, in_true_hw], dim=1
    ).to(torch.float32).contiguous()


def _check_banded_args(name, images, span_y, span_x, out_true_hw, in_true_hw,
                       method, row_lo=None):
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(
            f"{name} takes u8 [B, H, W, 3], got "
            f"{images.dtype} {tuple(images.shape)}"
        )
    b = images.shape[0]
    for arg, t in (("span_y", span_y), ("span_x", span_x),
                   ("out_true_hw", out_true_hw), ("in_true_hw", in_true_hw)):
        if t.shape != (b, 2) or t.device != images.device:
            raise ValueError(
                f"{arg} must be [{b}, 2] on {images.device}, got "
                f"{tuple(t.shape)} on {t.device}"
            )
    if row_lo is not None and (row_lo.shape != (b,) or row_lo.device != images.device
                               or row_lo.dtype != torch.float32):
        raise ValueError(
            f"row_lo must be f32 [{b}] on {images.device}, got {row_lo.dtype} "
            f"{tuple(row_lo.shape)} on {row_lo.device}"
        )
    if method not in _METHOD_CODES:
        raise ValueError(f"unknown resample method: {method}")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {images.device}")


def _k1_launch(images, out_hw, span_y, span_x, out_true_hw, in_true_hw,
               taps_hw, method, f32: bool, row_lo=None) -> torch.Tensor:
    """Launch K1 on a CUDA batch, storing u8 or (``f32``) the f32 result."""
    images = images.contiguous()
    if row_lo is not None:
        row_lo = row_lo.contiguous()
    b, in_h, in_w, _ = images.shape
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    ky, kx = int(taps_hw[0]), int(taps_hw[1])
    if in_w % 4 or images.data_ptr() % 4:
        # K1 reads source rows as 32-bit words; serving buckets are
        # multiples of 128 wide
        raise ValueError(f"K1 needs a source width that is a multiple of 4, got {in_w}")
    plan = k1_plan((in_h, in_w), (out_h, out_w), (ky, kx), b)
    lib = _k1_lib()
    dev = images.device
    geom = _geometry(span_y, span_x, out_true_hw, in_true_hw)
    out = torch.empty((b, out_h, out_w, 3),
                      dtype=torch.float32 if f32 else torch.uint8, device=dev)
    wy = torch.empty((b, out_h, ky), dtype=torch.float32, device=dev)
    jy = torch.empty((b, out_h), dtype=torch.int32, device=dev)
    wx = torch.empty((b, out_w, kx), dtype=torch.float32, device=dev)
    jx = torch.empty((b, out_w), dtype=torch.int32, device=dev)
    rc = lib.flyimg_resample_banded(
        images.data_ptr(), None if f32 else out.data_ptr(),
        out.data_ptr() if f32 else None, geom.data_ptr(),
        None if row_lo is None else row_lo.data_ptr(),
        wy.data_ptr(), jy.data_ptr(), wx.data_ptr(), jx.data_ptr(),
        b, in_h, in_w, out_h, out_w, ky, kx, _METHOD_CODES[method],
        plan.tile_h, plan.tile_w, plan.chunk_w, plan.row_chunk,
        int(plan.stage_wx), int(plan.stage_wy), plan.kx_static,
        plan.tiles_per_block, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "resample_banded_f32" if f32 else "resample_banded_u8")
    return out


def resample_banded_u8(
    images: torch.Tensor,
    out_hw: Tuple[int, int],
    span_y: torch.Tensor,
    span_x: torch.Tensor,
    out_true_hw: torch.Tensor,
    in_true_hw: torch.Tensor,
    taps_hw: Tuple[int, int],
    method: str = "lanczos3",
    row_lo: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Banded resample of a u8 [B, H, W, 3] batch straight to u8 [B,
    out_h, out_w, 3]: kernel K1 on a CUDA tensor, the plain PyTorch version
    (``resample_image_banded`` + ``quantize_u8``) on a CPU tensor. Geometry
    rows are [B, 2] f32 on the images' device. The tiled form gives
    ``row_lo`` [B] f32, each member's lowest valid source row: rows below it
    carry no weight, as rows at or past in_true never do."""
    _check_banded_args("resample_banded_u8", images, span_y, span_x,
                       out_true_hw, in_true_hw, method, row_lo)
    if images.device.type == "cpu":
        return quantize_u8(resample_image_banded(
            images.to(torch.float32), out_hw, span_y, span_x,
            out_true_hw, in_true_hw, taps_hw, method, row_lo,
        ))
    out = _k1_launch(images, out_hw, span_y, span_x, out_true_hw, in_true_hw,
                     taps_hw, method, False, row_lo)
    resample_banded_u8.launches += 1
    return out


#: K1 launches since the last reset (a plain integer)
resample_banded_u8.launches = 0


def resample_banded_f32(
    images: torch.Tensor,
    out_hw: Tuple[int, int],
    span_y: torch.Tensor,
    span_x: torch.Tensor,
    out_true_hw: torch.Tensor,
    in_true_hw: torch.Tensor,
    taps_hw: Tuple[int, int],
    method: str = "lanczos3",
    row_lo: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The f32-store form of ``resample_banded_u8``: the same band passes,
    the f32 result kept for the program stages that follow (no round, clip
    or u8). Kernel K1 on a CUDA tensor, ``resample_image_banded`` on a CPU
    tensor. Rows and columns past ``out_true`` hold the edge-clamped
    samples the plain version computes there. ``row_lo`` as in
    ``resample_banded_u8``."""
    _check_banded_args("resample_banded_f32", images, span_y, span_x,
                       out_true_hw, in_true_hw, method, row_lo)
    if images.device.type == "cpu":
        return resample_image_banded(
            images.to(torch.float32), out_hw, span_y, span_x,
            out_true_hw, in_true_hw, taps_hw, method, row_lo,
        )
    out = _k1_launch(images, out_hw, span_y, span_x, out_true_hw, in_true_hw,
                     taps_hw, method, True, row_lo)
    resample_banded_f32.launches += 1
    return out


#: launches of K1's f32-store form since the last reset
resample_banded_f32.launches = 0


def _k1_lib():
    lib = cuda_build.load("resample_banded")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.flyimg_resample_banded
        fn.argtypes = [p] * 9 + [i] * 17 + [p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib
