"""Spatial tiling: images split by height across ranks, with halo exchange
or a ring.

The port of ``flyimg_tpu/parallel/tiling.py``. A tall image's rows are cut
into n tiles, one a rank of the mesh's ``axis``; a rank's device may be its
own card or a card (or CPU) that other ranks share (a virtual mesh, where
the ranks run one after another). Two communication patterns:

- **halo exchange** (``tiled_transform``, ``tiled_filter``): each rank gets
  ``halo`` boundary rows from each neighbour (a copy to its device; on a
  shared device a slice, no copy), the outer halos filled with zeros or
  the edge row. The resample is kernel K1 (banded, per-rank geometry with
  a lower valid row) or two ``torch.matmul``s (dense); the filter is
  kernel K5 reading the halo rows instead of clamping;
- **ring** (``tiled_rotate``): tiles circulate the ring in n steps (n - 1
  hops), and each rank adds the bilinear taps that the visiting tile owns
  into its output rows: kernel K15 (``ops/rotate.py ring_rotate_step``).

On CUDA tensors every rank launches its kernels or raises; on CPU tensors
the kernels' plain versions run. A geometry the schedules cannot take (a
halo wider than a tile) raises ``TilingInfeasible``, the one error the
handler falls back on.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flyimg_tpu_torch.ops.color import fma_f32
from flyimg_tpu_torch.ops.filters import (
    MODE_BLUR,
    MODE_UNSHARP,
    gaussian_kernel,
    separable_conv_plain,
    separable_filter,
    unsharp_from_blurred,
)
from flyimg_tpu_torch.ops.resample import (
    kernel_mode,
    quantize_u8,
    resample_banded_f32,
    resample_banded_u8,
    resample_image_banded,
    resample_matrix,
    select_band_taps,
)
from flyimg_tpu_torch.ops.rotate import ring_geometry, ring_rotate_step, ring_rotate_step_plain
from flyimg_tpu_torch.parallel.mesh import Mesh
from flyimg_tpu_torch.parallel.mesh import on_device as _on
from flyimg_tpu_torch.spec.plan import rotated_bounds


class TilingInfeasible(ValueError):
    """The tiled schedule cannot take this geometry: the halo it needs is
    wider than a tile."""


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with its last row repeated ``rows`` times below (edge)."""
    if not rows:
        return x
    return torch.cat([x, x[-1:].expand((rows,) + tuple(x.shape[1:]))])


def _split(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Rank k's tile of rows, on its device (a view when it is x's). Tiles
    move in the caller's type (a u8 frame: a quarter of f32's bytes) and
    are cast on their device."""
    tile_h = x.shape[0] // len(devices)
    return [x[k * tile_h:(k + 1) * tile_h].to(dev) for k, dev in enumerate(devices)]


def _gather(outs: Sequence[torch.Tensor], rows: int) -> torch.Tensor:
    """The ranks' outputs stacked on rank 0's device, cut to ``rows``."""
    dev = outs[0].device
    return torch.cat([o.to(dev) for o in outs])[:rows]


def _halo_exchange(tiles: Sequence[torch.Tensor], halo: int,
                   fill: str = "zero") -> List[torch.Tensor]:
    """Each rank's tile with ``halo`` rows of the previous rank's above it
    and the next rank's below: [tile_h + 2 halo, W, C] on the rank's
    device. The outer halos (rank 0's top, rank n-1's bottom) hold zeros
    (``"zero"``: masked out of the resample weights) or the edge row
    (``"edge"``: the filters' virtual pixels). A neighbour on another
    device sends its rows by a copy to this rank's device; on the same
    device they are a slice."""
    if fill not in ("zero", "edge"):
        raise ValueError(f"unknown halo fill {fill!r}")
    n = len(tiles)
    out = []
    for k, tile in enumerate(tiles):
        dev = tile.device
        shape = (halo,) + tuple(tile.shape[1:])
        if k == 0:
            top = tile[:1].expand(shape) if fill == "edge" else tile.new_zeros(shape)
        else:
            top = tiles[k - 1][-halo:].to(dev)
        if k == n - 1:
            bot = tile[-1:].expand(shape) if fill == "edge" else tile.new_zeros(shape)
        else:
            bot = tiles[k + 1][:halo].to(dev)
        with _on(dev):
            out.append(torch.cat([top, tile, bot]))
    return out


def required_halo(
    in_h_pad: int, out_h_pad: int, src_h: int, dst_h: int, n: int
) -> int:
    """Neighbor rows each tile needs: kernel support at the true scale plus
    the cumulative drift between the padded tile grid and the true span
    (device idx's outputs start at idx*out_tile_h*row_scale but its tile
    starts at idx*tile_h)."""
    scale_y = max(src_h / dst_h, 1.0)
    drift = (out_h_pad // n) * (src_h / dst_h) - in_h_pad // n
    return int(3.0 * scale_y + 2.0 + abs(drift) * (n - 1)) + 1


def _rank_loop(devices, fn: Callable, tiles) -> List[torch.Tensor]:
    outs = []
    for k, (dev, tile) in enumerate(zip(devices, tiles)):
        with _on(dev):
            outs.append(fn(k, tile))
    return outs


# ---------------------------------------------------------------------------
# tiled resample: halo exchange, K1 with a per-rank geometry (or dense)
# ---------------------------------------------------------------------------


def tiled_transform(
    image: torch.Tensor,
    out_hw: Tuple[int, int],
    mesh: Mesh,
    *,
    axis: str = "sp",
    method: str = "lanczos3",
    kernel: Optional[str] = None,
    out_u8: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Resize [H, W, 3] -> [out_h, out_w, 3] with H split over
    ``mesh[axis]``. Heights the ranks do not divide are padded to it
    (edge-replicated input rows, garbage output rows sliced off).

    ``kernel`` (default: the process-wide ``resample_kernel`` mode) picks
    the form: banded (K1, u8 ``image`` only) or dense (two f32 products).
    Returns f32, or u8 (rounded, clipped) when ``out_u8``. ``plain`` runs
    K1's plain version on any device (to hold K1 against it on the card)."""
    n = int(mesh.shape[axis])
    in_h, in_w = int(image.shape[0]), int(image.shape[1])
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    pad_in = (-in_h) % n
    pad_out = (-out_h) % n
    if required_halo(in_h + pad_in, out_h + pad_out, in_h, out_h, n) > (
        (in_h + pad_in) // n
    ):
        # extreme downscales of short-ish tiles would need more neighbor
        # rows than a tile holds; clamping would silently corrupt pixels
        raise TilingInfeasible(
            f"tiled resample infeasible: halo exceeds tile height for "
            f"{in_h}->{out_h} over {n} devices"
        )
    halo, taps, rank_fn = _build_tiled_program(
        in_h + pad_in, in_w, (out_h + pad_out, out_w), mesh, axis, method,
        true_in_h=in_h, true_out_h=out_h, kernel=kernel or kernel_mode(),
        out_u8=out_u8, plain=plain,
    )
    if taps is not None:
        if image.dtype != torch.uint8:
            raise ValueError(f"the banded tiled resample takes u8, got {image.dtype}")
        x = image
        if in_w % 4:
            # K1 reads whole 32-bit words of a row; the columns past in_w
            # carry no weight (in_true)
            x = torch.cat([x, x.new_zeros((in_h, (-in_w) % 4, x.shape[2]))], dim=1)
    else:
        x = image
    devices = mesh.axis_devices(axis)
    tiles = _split(_pad_rows(x, pad_in), devices)
    if taps is None:
        tiles = [t.to(torch.float32) for t in tiles]
    ext = _halo_exchange(tiles, halo, "zero")
    return _gather(_rank_loop(devices, rank_fn, ext), out_h)


@lru_cache(maxsize=128)
def _build_tiled_program(
    in_h: int,
    in_w: int,
    out_hw: Tuple[int, int],
    mesh: Mesh,
    axis: str,
    method: str,
    *,
    true_in_h: int,
    true_out_h: int,
    kernel: str,
    out_u8: bool,
    plain: bool,
):
    """(halo, band taps or None, rank_fn) for one tiled-resample geometry;
    ``rank_fn(k, ext)`` resamples rank k's extended tile [tile_h + 2 halo,
    W, 3] to its [out_h / n, out_w, 3] output rows.

    Rank k's output row r (global r0 = k out_tile_h) samples global source
    y = (r0 + r + .5) src_h / dst_h - .5, local y = y - (k tile_h - halo),
    so its span starts at k out_tile_h row_scale - (k tile_h - halo), in
    the f32 arithmetic of the jitted reference (which XLA contracts into
    fused multiply-adds: here, and in each row's sample position). Valid
    local rows: [top_valid, bottom_valid) — rank 0's zero top halo and
    rank n-1's zero bottom halo are out, and so are rows at or past the
    TRUE source height."""
    n = int(mesh.shape[axis])
    out_h, out_w = out_hw
    if in_h % n or out_h % n:
        raise ValueError(f"H={in_h} and out_h={out_h} must divide mesh axis {n}")
    tile_h = in_h // n
    out_tile_h = out_h // n
    halo = required_halo(in_h, out_h, true_in_h, true_out_h, n)
    assert halo <= tile_h, (halo, tile_h)
    local_rows = tile_h + 2 * halo
    f32 = np.float32
    row_scale = true_in_h / true_out_h
    span_size = float(f32(out_tile_h * row_scale))
    taps = select_band_taps(
        kernel, method, (local_rows, in_w), (0.0, span_size),
        (0.0, float(in_w)), (out_tile_h, out_w),
    )
    devices = mesh.axis_devices(axis)
    geoms = []
    for k, dev in enumerate(devices):
        local_offset = k * tile_h - halo
        # k out_tile_h row_scale - local_offset, one fused multiply-add as
        # XLA computes the jitted reference
        span_start = fma_f32(torch.tensor(float(k * out_tile_h)), float(f32(row_scale)),
                             torch.tensor(-float(local_offset)))
        bottom = local_rows - halo if k == n - 1 else local_rows
        bottom = min(f32(bottom), f32(f32(true_in_h) - f32(local_offset)))
        top = halo if k == 0 else 0
        geoms.append((dev, float(span_start), float(bottom), float(top)))

    if taps is None:
        def rows(values, dev):
            return torch.tensor(values, dtype=torch.float32, device=dev)

        mats = []
        for dev, span_start, bottom, top in geoms:
            wy = resample_matrix(
                local_rows, out_tile_h, rows(span_start, dev), rows(span_size, dev),
                rows(float(out_tile_h), dev), rows(bottom, dev), method, fused=True,
            )
            # also zero taps above top_valid (rank 0's zero halo), then
            # renormalise, as the reference does
            j = torch.arange(local_rows, dtype=torch.float32, device=dev)
            wy = torch.where(j[None, :] >= top, wy, torch.zeros_like(wy))
            denom = wy.sum(dim=-1, keepdim=True)
            wy = wy / torch.where(denom == 0.0, torch.ones_like(denom), denom)
            wx = resample_matrix(
                in_w, out_w, rows(0.0, dev), rows(float(in_w), dev),
                rows(float(out_w), dev), rows(float(in_w), dev), method,
            )
            mats.append((wy, wx))

        def rank_fn(k, ext):
            wy, wx = mats[k]
            tmp = torch.matmul(wy, ext.reshape(local_rows, in_w * 3))
            tmp = tmp.reshape(out_tile_h, in_w, 3).permute(1, 0, 2)
            out = torch.matmul(wx, tmp.reshape(in_w, out_tile_h * 3))
            out = out.reshape(out_w, out_tile_h, 3).permute(1, 0, 2)
            return quantize_u8(out) if out_u8 else out.contiguous()

        return halo, None, rank_fn

    members = []
    for dev, span_start, bottom, top in geoms:
        def row(values, dev=dev):
            return torch.tensor([values], dtype=torch.float32, device=dev)

        members.append((
            row([span_start, span_size]), row([0.0, float(in_w)]),
            row([float(out_tile_h), float(out_w)]), row([bottom, float(in_w)]),
            torch.tensor([top], dtype=torch.float32, device=dev),
        ))
    resample = resample_banded_u8 if out_u8 else resample_banded_f32
    if plain:
        def resample(images, *args):
            out = resample_image_banded(images.to(torch.float32), *args)
            return quantize_u8(out) if out_u8 else out

    def rank_fn(k, ext):
        span_y, span_x, out_true, in_true, row_lo = members[k]
        return resample(ext[None], (out_tile_h, out_w), span_y, span_x,
                        out_true, in_true, taps, method, row_lo)[0]

    return halo, taps, rank_fn


# ---------------------------------------------------------------------------
# tiled convolution filters: halo exchange with IM's edge virtual pixels
# ---------------------------------------------------------------------------


def tiled_filter(
    image: torch.Tensor,
    mesh: Mesh,
    op: str,
    radius: float,
    sigma: float,
    *,
    gain: float = 1.0,
    threshold: float = 0.05,
    axis: str = "sp",
    out_u8: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Gaussian ``blur`` / ``sharpen`` / ``unsharp`` of [H, W, 3] with H
    split over ``mesh[axis]`` — the semantics of ops/filters.py, with the
    kernel's half-width exchanged as halo rows (edge-filled at the image's
    top and bottom, the filter's virtual pixels). Each rank runs K5's tiled
    form (``plain``: its plain version, on any device). Returns f32, or u8
    (rounded, clipped) when ``out_u8``."""
    if op not in ("blur", "sharpen", "unsharp"):
        raise ValueError(f"unknown tiled filter op {op!r}")
    n = int(mesh.shape[axis])
    in_h = int(image.shape[0])
    half = int(gaussian_kernel(radius, sigma).shape[0]) // 2
    pad_in = (-in_h) % n
    if half > (in_h + pad_in) // n:
        raise TilingInfeasible(
            f"tiled filter infeasible: kernel half-width {half} exceeds "
            f"tile height {(in_h + pad_in) // n} over {n} devices"
        )
    rank_fn = _build_tiled_filter(
        float(radius), float(sigma), op, float(gain), float(threshold), out_u8,
        plain,
    )
    devices = mesh.axis_devices(axis)
    # edge padding IS the filter's virtual-pixel policy, so the pad rows
    # never perturb true outputs
    tiles = [t.to(torch.float32) for t in _split(_pad_rows(image, pad_in), devices)]
    ext = _halo_exchange(tiles, half, "edge")
    return _gather(_rank_loop(devices, rank_fn, ext), in_h)


@lru_cache(maxsize=128)
def _build_tiled_filter(radius: float, sigma: float, op: str, gain: float,
                        threshold: float, out_u8: bool, plain: bool):
    """rank_fn(k, ext) of one tiled filter: K5's tiled form over the
    extended tile [tile_h + 2 half, W, 3] -> the rank's [tile_h, W, 3]."""
    kern = gaussian_kernel(radius, sigma)
    half = int(kern.shape[0]) // 2
    mode = MODE_BLUR if op == "blur" else MODE_UNSHARP
    # sharpen == unsharp with gain 1, no threshold (ops.filters.sharpen)
    eff_gain = gain if op == "unsharp" else 1.0
    eff_threshold = threshold if op == "unsharp" else 0.0

    def rank_fn(k, ext):
        if plain:
            out = separable_conv_plain(ext[None], kern, half)[0]
            if mode == MODE_UNSHARP:
                out = unsharp_from_blurred(ext[half:-half], out, eff_gain, eff_threshold)
            return quantize_u8(out) if out_u8 else out
        return separable_filter(ext[None], kern, mode, eff_gain, eff_threshold,
                                out_u8, halo=half)[0]

    return rank_fn


# ---------------------------------------------------------------------------
# ring rotate: all-to-all-distance gather via tile circulation
# ---------------------------------------------------------------------------


def tiled_rotate(
    image: torch.Tensor,
    degrees: float,
    mesh: Mesh,
    *,
    axis: str = "sp",
    background=None,
    out_u8: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Rotate [H, W, 3] by ``degrees`` (IM convention, clockwise) with H
    split over ``mesh[axis]`` — the sampling of ops/rotate.py (inverse
    affine, bilinear, clamped taps, background fill) as an n-step ring:
    every output pixel's two y-taps are CLAMPED to the true image rows, so
    each tap row is owned by exactly one tile, and adding the taps each
    visiting tile owns over the whole ring reconstructs the single-device
    bilinear sum. Quarter turns run the ring too (integer coordinates copy
    exactly). Each ring step is K15 (``plain``: its plain version, on any
    device). Returns ``image`` itself at 0 degrees, else f32 (or u8 when
    ``out_u8``)."""
    quad = float(degrees) % 360.0
    if quad == 0.0:
        return image
    n = int(mesh.shape[axis])
    in_h, in_w = int(image.shape[0]), int(image.shape[1])
    out_w, out_h = rotated_bounds(in_w, in_h, quad)
    pad_in = (-in_h) % n
    pad_out = (-out_h) % n
    run = _build_ring_rotate(
        in_h + pad_in, in_w, quad, mesh, axis,
        true_in_h=in_h,
        out_hw=(out_h + pad_out, out_w),
        true_out_hw=(out_h, out_w),
        background=tuple(background) if background else None,
        out_u8=out_u8,
        plain=plain,
    )
    # padded rows are never sampled (taps clamp to true rows); edge mode
    # just keeps the values finite
    tiles = _split(_pad_rows(image, pad_in), mesh.axis_devices(axis))
    return _gather(run([t.to(torch.float32) for t in tiles]), out_h)


@lru_cache(maxsize=128)
def _build_ring_rotate(
    in_h: int,
    in_w: int,
    degrees: float,
    mesh: Mesh,
    axis: str,
    *,
    true_in_h: int,
    out_hw: Tuple[int, int],
    true_out_hw: Tuple[int, int],
    background,
    out_u8: bool,
    plain: bool,
):
    """run(tiles) of one ring-rotate geometry: the ranks' output rows
    [out_h / n, out_w, 3]. At step s rank r holds the tile of rank
    (r + s) mod n and adds its taps (K15); the visiting tiles then move one
    rank back. n - 1 hops, then the last visit, which also applies the
    inside test and the background."""
    n = int(mesh.shape[axis])
    out_h, out_w = out_hw
    tile_h = in_h // n
    out_tile_h = out_h // n
    geom = ring_geometry((true_in_h, in_w), true_out_hw, degrees)
    devices = mesh.axis_devices(axis)
    step_fn = ring_rotate_step_plain if plain else ring_rotate_step

    def run(tiles):
        accs = [torch.zeros((out_tile_h, out_w, 3), dtype=torch.float32, device=d)
                for d in devices]
        visit = list(tiles)
        for step in range(n):
            last = step == n - 1
            for r, dev in enumerate(devices):
                with _on(dev):
                    accs[r] = step_fn(
                        visit[r], ((r + step) % n) * tile_h, r * out_tile_h,
                        accs[r], geom, last, background, out_u8 and last,
                    )
            if not last:
                visit = [visit[(r + 1) % n].to(devices[r]) for r in range(n)]
        return accs

    return run
