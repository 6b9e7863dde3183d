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
- **banded** (``resample_banded_u8``): a static K-tap band per output
  sample, weights from the UNCLIPPED tap positions with out-of-range taps
  zeroed before renormalising (docs/kernels.md "the unclipped-tap
  invariant"). On a CUDA tensor this is kernel K1
  (``csrc/resample_banded.cu``), which fuses the u8 load, both band passes
  and the round/clip/u8 store; on a CPU tensor it is the plain PyTorch
  version ``resample_image_banded`` in this module.

Filter kernels mirror ImageMagick's resize filters (lanczos3, triangle,
gaussian, Mitchell cubic, box, nearest); downscale antialiasing stretches
the kernel by the scale factor and renormalises. Taps at or beyond
``in_true`` get zero weight, so zero-padded buckets are invisible.
"""

from __future__ import annotations

import ctypes
import math
import os
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


def _sample_positions(out_size, span_start, span_size, out_true, in_true):
    """(x [..., out], stretch s [...]) for per-member geometry tensors of
    shape [...]; x is the clamped sample position of every output index."""
    i = torch.arange(out_size, dtype=torch.float32, device=span_start.device)
    q = span_size / torch.clamp(out_true, min=1.0)
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
) -> torch.Tensor:
    """Dense [..., out_size, in_size] weights for one axis, batched over
    the geometry tensors' leading shape [...]. ``in_size``/``out_size`` are
    the static (bucket) sizes; rows at i >= out_true are edge-replicated
    don't-cares (the host slices the valid region)."""
    x, s = _sample_positions(out_size, span_start, span_size, out_true, in_true)
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded weights for one axis: ``(idx [..., out, K] int64, w [..., out,
    K] f32)`` for per-member geometry tensors of shape [...], with ``taps``
    (K) static. The K tap positions are the integer window centred at
    ``floor(x)``; weights come from the UNCLIPPED positions and taps outside
    [0, in_true) are zeroed before renormalising, so the nonzero weights are
    exactly the dense row restricted to the band. Gather indices are
    clipped to the static axis as don't-cares."""
    x, s = _sample_positions(out_size, span_start, span_size, out_true, in_true)
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
        w = (jf == near[..., None]).to(torch.float32)
        return torch.clamp(j, 0, in_size - 1), w
    d = (jf - x[..., None]) / s[..., None, None]
    w = _kernel_fn(method, d)
    inside = (j >= 0) & (jf < in_true[..., None, None])
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
) -> torch.Tensor:
    """Banded K-tap resample of a [B, H, W, C] f32 batch to [B, out_h,
    out_w, C] — the plain PyTorch version of kernel K1 (before its u8
    epilogue). Rows are gathered and contracted over Ky, then columns over
    Kx, one tap at a time in tap order (K1's order)."""
    b, in_h, in_w, c = image.shape
    out_h, out_w = out_hw
    iy, wy = _band_axis(
        in_h, out_h, int(taps_hw[0]), span_y[:, 0], span_y[:, 1],
        out_true_hw[:, 0], in_true_hw[:, 0], method,
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


def resample_banded_u8(
    images: torch.Tensor,
    out_hw: Tuple[int, int],
    span_y: torch.Tensor,
    span_x: torch.Tensor,
    out_true_hw: torch.Tensor,
    in_true_hw: torch.Tensor,
    taps_hw: Tuple[int, int],
    method: str = "lanczos3",
) -> torch.Tensor:
    """Banded resample of a u8 [B, H, W, 3] batch straight to u8 [B,
    out_h, out_w, 3]: kernel K1 on a CUDA tensor, the plain PyTorch version
    (``resample_image_banded`` + ``quantize_u8``) on a CPU tensor. Geometry
    rows are [B, 2] f32 on the images' device."""
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[3] != 3:
        raise ValueError(
            f"resample_banded_u8 takes u8 [B, H, W, 3], got "
            f"{images.dtype} {tuple(images.shape)}"
        )
    b, in_h, in_w, _ = images.shape
    for name, t in (("span_y", span_y), ("span_x", span_x),
                    ("out_true_hw", out_true_hw), ("in_true_hw", in_true_hw)):
        if t.shape != (b, 2) or t.device != images.device:
            raise ValueError(
                f"{name} must be [{b}, 2] on {images.device}, got "
                f"{tuple(t.shape)} on {t.device}"
            )
    if method not in _METHOD_CODES:
        raise ValueError(f"unknown resample method: {method}")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    ky, kx = int(taps_hw[0]), int(taps_hw[1])
    if images.device.type == "cpu":
        return quantize_u8(resample_image_banded(
            images.to(torch.float32), (out_h, out_w), span_y, span_x,
            out_true_hw, in_true_hw, (ky, kx), method,
        ))
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    images = images.contiguous()
    if in_w % 4 or images.data_ptr() % 4:
        # K1 reads source rows as 32-bit words; serving buckets are
        # multiples of 128 wide
        raise ValueError(f"K1 needs a source width that is a multiple of 4, got {in_w}")
    lib = _k1_lib()
    smem = lib.flyimg_resample_banded_smem_bytes(in_w, ky)
    if smem > 227 * 1024:
        raise ValueError(f"source width {in_w} too wide for K1 ({smem} B)")
    dev = images.device
    geom = _geometry(span_y, span_x, out_true_hw, in_true_hw)
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.uint8, device=dev)
    wy = torch.empty((b, out_h, ky), dtype=torch.float32, device=dev)
    jy = torch.empty((b, out_h), dtype=torch.int32, device=dev)
    wx = torch.empty((b, out_w, kx), dtype=torch.float32, device=dev)
    jx = torch.empty((b, out_w), dtype=torch.int32, device=dev)
    rc = lib.flyimg_resample_banded_u8(
        images.data_ptr(), out.data_ptr(), geom.data_ptr(),
        wy.data_ptr(), jy.data_ptr(), wx.data_ptr(), jx.data_ptr(),
        b, in_h, in_w, out_h, out_w, ky, kx, _METHOD_CODES[method],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "resample_banded_u8")
    resample_banded_u8.launches += 1
    return out


#: K1 launches since the last reset (a plain integer)
resample_banded_u8.launches = 0


def _k1_lib():
    lib = cuda_build.load("resample_banded")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.flyimg_resample_banded_u8
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.flyimg_resample_banded_smem_bytes.argtypes = [i, i]
        lib.flyimg_resample_banded_smem_bytes.restype = ctypes.c_size_t
        lib._flyimg_bound = True
    return lib
