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
epilogue, with an optional u8 store); on a CPU tensor it is the plain
PyTorch version here (replicate padding + depthwise ``F.conv2d``).

K5's tiled form (``halo`` > 0) is the per-rank body of the spatially
tiled filter (``parallel/tiling.py tiled_filter``): its input carries
``halo`` neighbour rows above and below the rank's own, which the H pass
reads instead of replicating edge rows.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.ops.resample import quantize_u8

#: K5's epilogue modes (csrc/separable.cu)
MODE_BLUR, MODE_UNSHARP = 0, 1
#: shared memory of K5's horizontal pass, which takes (256 + K - 1) pixels
K5_SMEM_LIMIT = 227 * 1024


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
    if 4 * (((k + 3) & ~3) + (256 + k - 1) * 3) > K5_SMEM_LIMIT or b > 65535:
        raise ValueError(f"K5 takes at most ~18000 taps and 65535 members, got {k}, {b}")
    image = image.contiguous()
    dev = image.device
    taps = _taps_on(str(dev), tuple(float(v) for v in kernel))
    tmp = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, w, 3), dtype=torch.uint8 if out_u8 else torch.float32,
                      device=dev)
    rc = _lib().flyimg_separable(
        image.data_ptr(), tmp.data_ptr(), None if out_u8 else out.data_ptr(),
        out.data_ptr() if out_u8 else None, taps.data_ptr(), b, h, w, k, halo,
        mode, float(np.float32(gain)), float(np.float32(threshold * 255.0)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(rc, "separable_filter")
    separable_filter.launches += 1
    return out


#: K5 launches since the last reset (a plain integer; one per call, which
#: runs the kernel's two passes)
separable_filter.launches = 0


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
        fn.argtypes = [p] * 5 + [i] * 6 + [f] * 2 + [p]
        fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib
