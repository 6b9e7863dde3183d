"""Gaussian blur / sharpen / unsharp as separable convolutions, and kernel K5.

The port of ``flyimg_tpu/ops/filters.py``. IM semantics:

- blur {radius}x{sigma}: plain Gaussian; radius 0 -> support derived from
  sigma (half-width ceil(3 sigma)).
- sharpen {radius}x{sigma}: unsharp with gain 1, threshold 0.
- unsharp {radius}x{sigma}+gain+threshold: out = img + gain*(img - blur)
  where |img - blur| >= threshold (a fraction of the [0, 255] range).

Edges replicate (IM's edge virtual-pixel policy); the H pass runs first,
then the W pass, as ``_separable_conv_core`` does. On a CUDA tensor every
filter is kernel K5 (``csrc/separable.cu``: both passes and the unsharp
epilogue, with an optional u8 store; one launch over 2-D tiles, or two
passes through a scratch buffer past 29 taps, as ``k5_plan`` picks); on
a CPU tensor it is the plain PyTorch version here (replicate padding +
depthwise ``F.conv2d``).

K5's tiled form (``halo`` > 0) is the per-rank body of the spatially
tiled filter (``parallel/tiling.py tiled_filter``): its input carries
``halo`` neighbour rows above and below the rank's own, which the H pass
reads instead of replicating edge rows.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.ops.resample import quantize_u8

#: K5's epilogue modes (csrc/separable.cu)
MODE_BLUR, MODE_UNSHARP = 0, 1
#: the card's shared memory a block may take
K5_SMEM_LIMIT = 227 * 1024
#: the 2-D tile form's output tile, rows x pixels (the kernel takes rows a
#: power of two from 8 to 32 and pixels a multiple of 8, at most 2048
#: pixels). Of the tiles from 8 x 8 to 8 x 256 swept on an H100 at 7 to 25
#: taps, 16 x 128 read fastest or within a tenth of the fastest.
K5_TILE = (16, 128)
#: the most shared memory a tile-form launch takes: two blocks an SM (228
#: KB an SM, 1 KB of it reserved a block). Past it the two-pass form reads
#: faster: on an H100 a 32 x 1540x2134 blur's tile form reads faster than
#: two passes at 29 taps (111 KB, two blocks an SM) and slower at 31 (116
#: KB, one block), as at 61 (stage_breakdown's rows by tap count).
K5_TILE_SMEM = 113 * 1024


@dataclass(frozen=True)
class K5Plan:
    """A K5 launch: ``form`` "tile" (one launch, ``tile_h`` x ``tile_w``
    output pixels a block) or "two_pass" (through an f32 scratch buffer;
    no tile), and the launch's shared memory in bytes."""

    form: str
    tile_h: int
    tile_w: int
    smem_bytes: int


def k5_smem_bytes(k: int, tile_h: int, tile_w: int, out_u8: bool) -> int:
    """Shared memory of a 2-D tile launch (csrc/separable.cu tile_layout):
    the taps; the (tile_h + k - 1)-row source window, each row from its
    16-byte-aligned start (the space then stages the output rows, an odd
    number of words each); the window rows' offsets; tile_h rows of H-pass
    sums, of an odd number of floats."""
    wp = ((tile_w + k - 1) * 3 + 6) & ~3
    vp = ((tile_w + k - 1) * 3) | 1
    spw = ((tile_w * 3 * (1 if out_u8 else 4) + 3) // 4 + 1) | 1
    win = max((tile_h + k - 1) * wp, tile_h * spw)
    rofs = (tile_h + k - 1 + 3) & ~3
    return 4 * (((k + 3) & ~3) + win + rofs + tile_h * vp)


def k5_plan(batch: int, h: int, w: int, k: int, halo: int,
            out_u8: bool = False) -> K5Plan:
    """Pick K5's form for a [batch, h (+ 2 halo), w, 3] filter by ``k``
    taps: the 2-D tile form at ``K5_TILE`` while its shared memory leaves
    two blocks an SM (``K5_TILE_SMEM``: up to 29 taps); past that the
    two-pass form, up to its shared-memory limit (~14,000 taps). Raises
    where no form takes the shape."""
    if k < 1 or k % 2 == 0:
        raise ValueError(f"K5 takes an odd tap count, got {k}")
    if not 0 <= halo <= k // 2:
        raise ValueError(f"halo must lie in [0, {k // 2}], got {halo}")
    if min(batch, h, w) < 1:
        raise ValueError(f"filter of an empty batch {batch} x {h} x {w}")
    if batch > 65535:
        raise ValueError(f"K5 takes at most 65535 members, got {batch}")
    smem = k5_smem_bytes(k, *K5_TILE, out_u8)
    if smem <= K5_TILE_SMEM:
        return K5Plan("tile", *K5_TILE, smem)
    smem = 4 * (((k + 3) & ~3) + (256 + k - 1) * 3)
    if smem > K5_SMEM_LIMIT:
        raise ValueError(f"K5 takes at most ~14,000 taps, got {k}")
    return K5Plan("two_pass", 0, 0, smem)


@lru_cache(maxsize=64)
def _gaussian_taps(radius: float, sigma: float) -> Tuple[float, ...]:
    sigma = max(float(sigma), 1e-6)
    if radius and radius >= 1.0:
        half = int(radius)
    else:
        half = max(int(math.ceil(3.0 * sigma)), 1)
    xs = np.arange(-half, half + 1, dtype=np.float32)
    kernel = np.exp(-(xs * xs) / np.float32(2.0 * sigma * sigma))
    kernel = kernel / kernel.sum(dtype=np.float32)
    return tuple(float(v) for v in kernel.astype(np.float32))


def gaussian_kernel(radius: float, sigma: float) -> np.ndarray:
    """1-D normalised Gaussian, f32, computed on the host as the JAX
    package computes it: 2 * half + 1 taps, half = int(radius) for a radius
    of at least 1, else ceil(3 sigma) (at least 1)."""
    return np.asarray(_gaussian_taps(float(radius), float(sigma)), np.float32)


def separable_conv_plain(image: torch.Tensor, kernel: np.ndarray,
                         halo: int = 0) -> torch.Tensor:
    """Depthwise separable conv over [B, H, W, C] with edge replication:
    the H pass, then the W pass (the plain version of K5's two passes).
    With ``halo`` the input holds that many extra rows above and below,
    read before any replication, and the output the H rows between."""
    k = int(kernel.shape[0])
    half = k // 2
    c = image.shape[-1]
    x = image.permute(0, 3, 1, 2)
    ker = torch.from_numpy(np.ascontiguousarray(kernel)).to(image.device)
    if half > halo:
        x = F.pad(x, (0, 0, half - halo, half - halo), mode="replicate")
    x = F.conv2d(x, ker.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    x = F.pad(x, (half, half, 0, 0), mode="replicate")
    x = F.conv2d(x, ker.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return x.permute(0, 2, 3, 1).contiguous()


def unsharp_from_blurred(
    image: torch.Tensor, blurred: torch.Tensor, gain: float, threshold: float,
) -> torch.Tensor:
    """IM UnsharpMaskImage arithmetic given the blur: amplify (img - blur)
    where |img - blur| >= threshold * 255."""
    diff = image - blurred
    amount = float(np.float32(gain)) * diff
    mask = torch.abs(diff) >= float(np.float32(threshold * 255.0))
    return image + torch.where(mask, amount, torch.zeros_like(amount))


def separable_filter(
    image: torch.Tensor,
    kernel: np.ndarray,
    mode: int = MODE_BLUR,
    gain: float = 1.0,
    threshold: float = 0.0,
    out_u8: bool = False,
    halo: int = 0,
) -> torch.Tensor:
    """Separable blur of an f32 [B, H, W, 3] batch by the 1-D ``kernel``,
    then the unsharp epilogue (``mode`` MODE_UNSHARP) and a u8 store when
    ``out_u8``: kernel K5 on a CUDA tensor, the plain version on a CPU
    tensor. With ``halo`` (0 to K // 2; the tiled form) the input holds
    ``halo`` neighbour rows above and below each member's own H - 2 halo
    rows, and the output only those own rows."""
    if image.dtype != torch.float32 or image.dim() != 4 or image.shape[3] != 3:
        raise ValueError(
            f"separable_filter takes f32 [B, H, W, 3], got {image.dtype} "
            f"{tuple(image.shape)}"
        )
    kernel = np.asarray(kernel, np.float32)
    k = int(kernel.shape[0]) if kernel.ndim == 1 else 0
    if k < 1 or k % 2 == 0:
        raise ValueError(f"kernel must be 1-D with an odd tap count, got {kernel.shape}")
    if mode not in (MODE_BLUR, MODE_UNSHARP):
        raise ValueError(f"unknown filter mode {mode}")
    if not 0 <= halo <= k // 2:
        raise ValueError(f"halo must lie in [0, {k // 2}], got {halo}")
    b, h, w, _ = image.shape
    h -= 2 * halo
    if min(b, h, w) < 1:
        raise ValueError(f"filter of an empty batch {tuple(image.shape)} (halo {halo})")
    if image.device.type == "cpu":
        out = separable_conv_plain(image, kernel, halo)
        if mode == MODE_UNSHARP:
            out = unsharp_from_blurred(image[:, halo:halo + h], out, gain, threshold)
        return quantize_u8(out) if out_u8 else out
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    out = k5_launch(image, kernel, k5_plan(b, h, w, k, halo, out_u8), mode, gain,
                    threshold, out_u8, halo)
    separable_filter.launches += 1
    return out


#: K5 launches since the last reset (a plain integer; one per call, whichever
#: form runs)
separable_filter.launches = 0


def k5_launch(image: torch.Tensor, kernel: np.ndarray, plan: K5Plan, mode: int = MODE_BLUR,
              gain: float = 1.0, threshold: float = 0.0, out_u8: bool = False,
              halo: int = 0) -> torch.Tensor:
    """One K5 launch in ``plan``'s form and tile on a CUDA tensor, whatever
    ``k5_plan`` would pick: ``separable_filter``'s launch, and how
    ``chip_smoke.py`` and ``stage_breakdown`` hold one form against the
    other (both sum the taps in the same order). Not counted as a launch
    of ``separable_filter``."""
    if image.device.type != "cuda":
        raise ValueError(f"K5 launches on a CUDA tensor, got one on {image.device}")
    kernel = np.asarray(kernel, np.float32)
    b, h, w, _ = image.shape
    h -= 2 * halo
    k = int(kernel.shape[0])
    image = image.contiguous()
    dev = image.device
    taps = _taps_on(str(dev), tuple(float(v) for v in kernel))
    tmp = (torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
           if plan.form == "two_pass" else None)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=dev)
    rc = _lib().flyimg_separable(
        image.data_ptr(), None if tmp is None else tmp.data_ptr(),
        None if out_u8 else out.data_ptr(), out.data_ptr() if out_u8 else None,
        taps.data_ptr(), b, h, w, k, halo, mode, float(np.float32(gain)),
        float(np.float32(threshold * 255.0)), _FORMS[plan.form], plan.tile_h,
        plan.tile_w, torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, f"separable_filter ({plan.form} form)")
    return out


def gaussian_blur(image: torch.Tensor, radius: float, sigma: float,
                  out_u8: bool = False) -> torch.Tensor:
    return separable_filter(image, gaussian_kernel(radius, sigma),
                            out_u8=out_u8)


def unsharp_mask(
    image: torch.Tensor,
    radius: float,
    sigma: float,
    gain: float = 1.0,
    threshold: float = 0.05,
    out_u8: bool = False,
) -> torch.Tensor:
    """IM UnsharpMaskImage: amplify (img - blur) where it reaches the
    threshold. Pixel range is [0, 255]; threshold is a fraction of it."""
    return separable_filter(image, gaussian_kernel(radius, sigma),
                            MODE_UNSHARP, gain, threshold, out_u8)


def sharpen(image: torch.Tensor, radius: float, sigma: float,
            out_u8: bool = False) -> torch.Tensor:
    """IM SharpenImage ~ unsharp with gain 1, no threshold."""
    return unsharp_mask(image, radius, sigma, 1.0, 0.0, out_u8)


#: K5's form codes (csrc/separable.cu flyimg_separable)
_FORMS = {"tile": 0, "two_pass": 1}
#: the two-pass form's plan, for k5_launch
K5_TWO_PASS = K5Plan("two_pass", 0, 0, 0)


@lru_cache(maxsize=64)
def _taps_on(device: str, taps: Tuple[float, ...]) -> torch.Tensor:
    """A filter's taps on the card, copied once (a copy per launch would
    stall the host on the launch's stream)."""
    return torch.tensor(taps, dtype=torch.float32, device=device)


def _lib():
    lib = cuda_build.load("separable")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.flyimg_separable
        fn.argtypes = [p] * 5 + [i] * 6 + [f] * 2 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib
