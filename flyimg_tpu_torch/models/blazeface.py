"""The BlazeFace face detector's forward, and kernels K9 and K10.

The port of the serving half of ``flyimg_tpu/models/blazeface.py``: a
single-shot anchor detector built from depthwise-separable "BlazeBlocks"
(a 5x5/2 stem, 16 blocks from 24 to 96 channels, two anchor maps of 16x16
x 2 and 8x8 x 6 = 896 anchors, 128x128 RGB input in [-1, 1]), at full
width with the packaged weights. Training (``init_params``, ``loss_fn``,
``make_train_step``, ``synthetic_batch``, ``train_synthetic``, kernels
K11-K14) lives in ``models/blazeface_train.py``; those names are importable
from here too.

Activations stay NHWC and kernels HWIO, as flax stores them. On the card:

- K9 (``conv5x5``, ``csrc/blazeface.cu``): the stem (full 5x5/2
  convolution + bias + ReLU) and every depthwise 5x5 convolution, in
  shared-memory tiles with a zero halo (``k9_plan``);
- K10 (``pointwise``): each block's 1x1 convolution + bias + residual
  (2x2 max-pooled at stride 2, zero-padded in channels) + ReLU; and its
  head form (``head_decode``, ``head_plan``): both maps' class and offset
  convolutions with the sigmoid and the anchor decode in the epilogue,
  written into the [N, 896] probabilities and [N, 896, 4] boxes in one
  launch.

A forward is 34 launches: 17 of K9, 16 of K10 and 1 of its head form.
``conv5x5_plain``, ``pointwise_plain`` and ``head_plain`` (+
``decode_boxes``) are the plain PyTorch versions (``F.conv2d``,
``F.max_pool2d``); each wrapper runs its plain version for a CPU tensor
only. The host side — views, Pillow-exact BILINEAR network inputs
(models/thumbnail.py), chunks of at most ``MAX_BATCH_BUCKET`` views on the
power-of-two ladder, per-image NMS — is the JAX package's, line for line.

Weights: ``load_weights`` reads the ``.npz`` that
``tools/export_blazeface_npz.py`` writes from the JAX package's orbax
checkpoint (``models/weights/blazeface.npz`` is packaged), with numpy and
torch alone.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models.thumbnail import bilinear_resize
from flyimg_tpu_torch.runtime.batcher import MAX_BATCH_BUCKET, _round_batch

INPUT_SIZE = 128
ANCHORS_16 = 2   # anchors per cell on the 16x16 map
ANCHORS_8 = 6    # anchors per cell on the 8x8 map
NUM_ANCHORS = 16 * 16 * ANCHORS_16 + 8 * 8 * ANCHORS_8  # 896

#: (features, stride) of the 16 BlazeBlocks; the 16x16 map is the output
#: of block X16_BLOCK, the 8x8 map that of the last
BLOCKS = (
    (24, 1), (28, 1), (32, 2), (36, 1), (42, 1), (48, 2), (56, 1), (64, 1),
    (72, 1), (80, 1), (88, 1), (96, 2), (96, 1), (96, 1), (96, 1), (96, 1),
)
X16_BLOCK = 10
STEM_FEATURES = 24

PACKAGED_WEIGHTS = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "weights", "blazeface.npz"
)
EXPORTER = "tools/export_blazeface_npz.py"


# ---------------------------------------------------------------------------
# kernels and their plain versions
# ---------------------------------------------------------------------------


def same_pads(size: int, stride: int, k: int = 5) -> Tuple[int, int, int]:
    """(pad before, pad after, output size) of XLA's SAME padding."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2, out


def _is_depthwise(kernel: torch.Tensor, cin: int) -> bool:
    return kernel.shape[2] == 1 and kernel.shape[3] == cin


def conv5x5_plain(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor], stride: int,
                  relu: bool) -> torch.Tensor:
    """The plain version of K9: SAME 5x5 convolution of NHWC ``x`` with an
    HWIO ``kernel`` (depthwise when it is [5, 5, 1, C_in])."""
    n, h, w, cin = x.shape
    pt, pb, _ = same_pads(h, stride)
    pl, pr, _ = same_pads(w, stride)
    groups = cin if _is_depthwise(kernel, cin) else 1
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xn, kernel.permute(3, 2, 0, 1), bias, stride=stride,
                 groups=groups)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def conv5x5(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor], stride: int,
            relu: bool) -> torch.Tensor:
    """K9 on a CUDA tensor, ``conv5x5_plain`` on a CPU tensor: f32 NHWC
    [N, H, W, C_in] -> [N, ceil(H / s), ceil(W / s), C_out]; on the card
    stride 1 or 2, launched as ``k9_plan`` says."""
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"conv5x5 takes f32 NHWC, got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    depthwise = _is_depthwise(kernel, cin)
    if tuple(kernel.shape[:2]) != (5, 5) or (
        not depthwise and kernel.shape[2] != cin
    ):
        raise ValueError(
            f"conv5x5 kernel {tuple(kernel.shape)} does not fit C_in = {cin}"
        )
    cout = kernel.shape[3]
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} for C_out = {cout}")
    dev = x.device
    if dev.type == "cpu":
        return conv5x5_plain(x, kernel, bias, stride, relu)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    plan = k9_plan(n, h, w, cin, cout, stride, depthwise, _sm_count(dev.index))
    pt, _, oh = same_pads(h, stride)
    pl, _, ow = same_pads(w, stride)
    x, kernel = (t if t.is_contiguous() else t.contiguous() for t in (x, kernel))
    if bias is not None and not bias.is_contiguous():
        bias = bias.contiguous()
    out = torch.empty((n, oh, ow, cout), dtype=torch.float32, device=dev)
    rc = _lib().flyimg_bf_conv5x5(
        x.data_ptr(), kernel.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, w, cin, oh, ow, cout, stride, pt, pl, int(depthwise), int(relu),
        plan.th, plan.run, plan.rp, plan.threads, plan.blocks,
        cuda_build.current_stream(dev.index),
    )
    cuda_build.check(rc, "blazeface conv5x5")
    conv5x5.launches += 1
    return out


#: K9 launches since the last reset (a plain integer)
conv5x5.launches = 0


def _residual(res: torch.Tensor, stride: int, cout: int) -> torch.Tensor:
    if stride == 2:
        res = F.max_pool2d(res.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return F.pad(res, (0, cout - res.shape[-1]))


def pointwise_plain(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                    res: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain version of K10's block form: relu(1x1 conv of ``y`` + bias
    + the residual ``res`` pooled at stride 2 and zero-padded)."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    out = torch.matmul(y, kernel.reshape(cin, cout)) + bias
    return F.relu(out + _residual(res, stride, cout)).contiguous()


#: a block's shared memory on Hopper, and an SM's (1 KB of it reserved a block)
SMEM_BLOCK_MAX = 227 * 1024
SMEM_SM = 228 * 1024
#: the largest K10 tile, in pixels, the most threads a K10 block takes, and
#: the output channels a thread computes (of 4 pixels; csrc kCo)
K10_MAX_TILE = 64
K10_MAX_THREADS = 512
K10_CO = 4


class K10Plan(NamedTuple):
    """How K10's block form walks one layer (``k10_plan``)."""

    tile_px: int      # pixels a tile: a multiple of 4, and of W at stride 2
    stage_out: bool   # gather the tile's output in shared memory, store one span
    threads: int      # threads a block: an item (4 pixels x 4 channels) each
    blocks: int       # persistent blocks; block b takes tiles b, b + blocks, ...
    smem_bytes: int   # dynamic shared memory a block


def _row_pitch(c: int) -> int:
    """A staged row's floats: an odd number of 16-byte chunks (csrc
    row_pitch), so a warp's lanes, a pixel each, hit distinct banks."""
    return 4 * (((c + 3) // 4) | 1)


def k10_smem_bytes(cin: int, cout: int, res_c: int, stride: int, tile_px: int,
                   stage_out: bool) -> int:
    """K10's shared memory a block (csrc pointwise_smem_floats): the weights
    [ceil4(C_in), ceil4(C_out)] and bias, two stages of the tile's input
    rows and residual rows (4 per pixel at stride 2), and with ``stage_out``
    the tile's output."""
    cin4 = (cin + 3) // 4 * 4
    cpad = -(-cout // K10_CO) * K10_CO
    rpx = (4 if stride == 2 else 1) * tile_px if res_c else 0
    return 4 * (cin4 * cpad + cpad
                + 2 * (tile_px * _row_pitch(cin) + rpx * _row_pitch(res_c))
                + (tile_px * cout if stage_out else 0))


@functools.lru_cache(maxsize=512)
def k10_plan(n: int, h: int, w: int, cin: int, cout: int, res_c: int,
             stride: int, sm_count: int = 132) -> K10Plan:
    """K10's launch plan for a layer with an [n, h, w] output: the largest
    tile of at most K10_MAX_TILE pixels, and of the power of two at or above
    the pixels an SM gets (whole output rows at stride 2), whose two stages
    fit a block's shared memory; the tile's output gathered in shared memory
    and stored as one span where C_out is no multiple of 8 (from registers a
    pixel's outputs would not fill whole 32-byte sectors); a thread an item
    of the tile; as many persistent blocks as the card holds at once, or one
    a tile when there are fewer tiles. (A sweep of tiles 16-256, 4 or 8
    channels a thread, 2 or 3 stages and the staged output on an H100 found
    these within a few percent of the best at every layer of the 64-view
    forward; PERF.md.)"""
    pixels = n * h * w
    stage_out = cout % 8 != 0
    unit = math.lcm(4, w) if stride == 2 else 4
    share = 1 << max(0, pixels // sm_count - 1).bit_length()
    top = max(unit, min(K10_MAX_TILE, share) // unit * unit)
    for tile_px in range(top, 0, -unit):
        smem = k10_smem_bytes(cin, cout, res_c, stride, tile_px, stage_out)
        if smem <= SMEM_BLOCK_MAX:
            break
    else:
        raise ValueError(
            f"pointwise: a {cin} -> {cout} layer at stride {stride}, width {w} "
            f"needs {smem} bytes of shared memory for its smallest tile "
            f"(> {SMEM_BLOCK_MAX})"
        )
    items = -(-cout // K10_CO) * (tile_px // 4)
    threads = min(K10_MAX_THREADS, -(-items // 32) * 32)
    tiles = -(-pixels // tile_px)
    return K10Plan(tile_px, stage_out, threads,
                   min(tiles, sm_count * _per_sm(smem, threads)), smem)


#: the most threads a K9 block takes (csrc kK9MaxThreads)
K9_MAX_THREADS = 512


class K9Plan(NamedTuple):
    """How K9 walks one layer (``k9_plan``)."""

    th: int           # output rows a tile: a band of one image, the whole width
    run: int          # output pixels a thread: a run of 8 or 4 consecutive
                      # ones (depthwise), or 4 pixels k, k + cols, ... (full
                      # form, csrc kK9FullPx)
    rp: int           # floats a staged row (bank-padded)
    threads: int      # threads a block
    blocks: int       # persistent blocks; block b takes tiles b, b + blocks, ...
    smem_bytes: int   # dynamic shared memory a block (two stages where a
                      # block takes more than one tile)


def k9_geometry(ow: int, c_in: int, c_out: int, stride: int, depthwise: bool,
                run: int) -> Tuple[int, int, int]:
    """(floats a staged pixel, staged columns, items a tile row) of K9 on an
    output ``ow`` wide. Depthwise: a pixel is ceil4(C) floats, a row's runs
    of ``run`` outputs read s (runs run - 1) + 5 columns, an item is 4
    channels x a run. Full form: a pixel is C_in floats, a thread's pixels
    k, k + cols, ... (cols = ceil(ow / run)) read s (cols run - 1) + 5
    columns, an item is 8 channels x ``run`` pixels."""
    runs = -(-ow // run)
    span = (runs * run - 1) * stride + 5
    if depthwise:
        pc = -(-c_in // 4) * 4
        return pc, span, pc // 4 * runs
    return c_in, span, -(-c_out // 8) * runs


def k9_row_pitch(ow: int, c_in: int, c_out: int, stride: int, depthwise: bool,
                 run: int) -> int:
    """A staged row's floats. Depthwise: the smallest pitch >= the row whose
    16-byte chunks times s are G = ceil(C / 4) modulo 8, so the eight lanes
    of a shared-memory phase (channel groups fastest, then rows) hit eight
    banks (none at stride 2 with G odd: the plain row). Full form: the row
    and up to 3 floats of lead (csrc: the image's first column starts on a
    copy boundary), to a multiple of 4."""
    pc, span, _ = k9_geometry(ow, c_in, c_out, stride, depthwise, run)
    if not depthwise:
        return (span * pc + 3 + 3) // 4 * 4
    chunks, g = span * pc // 4, pc // 4
    for pad in range(8):
        if (stride * (chunks + pad) - g) % 8 == 0:
            return 4 * (chunks + pad)
    return 4 * chunks


def k9_smem_bytes(c_in: int, c_out: int, stride: int, depthwise: bool, th: int,
                  rp: int, stages: int) -> int:
    """K9's shared memory a block (csrc conv5x5_smem_floats): the filter
    ([25, ceil4(C)] depthwise, [25 C_in, ceil8(C_out)] full) and ``stages``
    stages of s (th - 1) + 5 staged rows of ``rp`` floats."""
    wf = 25 * (-(-c_in // 4) * 4 if depthwise else c_in * (-(-c_out // 8) * 8))
    return 4 * (wf + stages * ((th - 1) * stride + 5) * rp)


#: registers a K9 thread may take (the launch bound's 65,536 / 512)
K9_REGS = 128


def _per_sm(smem: int, threads: int, regs: int = 32) -> int:
    """Blocks an SM holds at once, by shared memory, threads and registers."""
    return max(1, min(SMEM_SM // (smem + 1024), 2048 // threads,
                      65536 // (threads * regs)))


@functools.lru_cache(maxsize=512)
def k9_plan(n: int, h: int, w: int, c_in: int, c_out: int, stride: int,
            depthwise: bool, sm_count: int = 132) -> K9Plan:
    """K9's launch plan for a layer with an [n, h, w, c_in] input: in the
    depthwise form runs of 8 outputs a thread at stride 1 on outputs at least
    16 wide, else 4 (4 pixels of 8 channels in the full form); tiles of the
    most output rows (the whole height, else a power of two) whose items fit
    K9_MAX_THREADS and whose two stages fit a block's shared memory, while
    there are at least half as many tiles as SMs (else the fewest rows that
    fit); one stage and a block a tile when every tile fits on the card at
    once (by shared memory, threads and K9_REGS registers a thread), else two
    stages and as many persistent blocks as fit. (A sweep of rows 1-64 and
    runs 4 and 8 on an H100 found these within ~10% of the best at every
    layer of the 64-view forward; PERF.md.)"""
    if stride not in (1, 2):
        raise ValueError(f"conv5x5 on the card takes stride 1 or 2, got {stride}")
    oh, ow = same_pads(h, stride)[2], same_pads(w, stride)[2]
    run = 8 if depthwise and stride == 1 and ow >= 16 else 4
    rp = k9_row_pitch(ow, c_in, c_out, stride, depthwise, run)
    per_row = k9_geometry(ow, c_in, c_out, stride, depthwise, run)[2]

    def smem(t, stages):
        return k9_smem_bytes(c_in, c_out, stride, depthwise, t, rp, stages)

    tops = [oh] + [1 << k for k in range(oh.bit_length() - 1, -1, -1) if 1 << k < oh]
    fit = [t for t in tops if smem(t, 2) <= SMEM_BLOCK_MAX
           and (t == 1 or t * per_row <= K9_MAX_THREADS)]
    if not fit:
        raise ValueError(
            f"conv5x5: a {c_in} -> {c_out} layer {w} wide at stride {stride} "
            f"needs {smem(1, 2)} bytes of shared memory for one output row "
            f"(> {SMEM_BLOCK_MAX})"
        )
    th = next((t for t in fit if 2 * n * -(-oh // t) >= sm_count), fit[-1])
    threads = min(K9_MAX_THREADS, -(-(th * per_row) // 32) * 32)
    tiles = n * -(-oh // th)
    if tiles <= sm_count * _per_sm(smem(th, 1), threads, K9_REGS):
        stages, blocks = 1, tiles
    else:
        stages, blocks = 2, min(tiles, sm_count * _per_sm(smem(th, 2), threads, K9_REGS))
    return K9Plan(th, run, rp, threads, blocks, smem(th, stages))


#: threads a block of K10's head form
HEAD_THREADS = 256


class HeadPlan(NamedTuple):
    """How K10's head form walks the anchor maps (``head_plan``)."""

    threads: int
    tile_px: Tuple[int, ...]  # contiguous pixels a block, by map
    tiles: Tuple[int, ...]    # blocks by map; map i's follow map i - 1's
    smem_bytes: int           # dynamic shared memory a block (the largest map's)


def head_smem_bytes(cin: int, na: int, tile_px: int) -> int:
    """K10 head form's shared memory a block (csrc head_smem_floats): the
    weight columns [C_in, 5 na] and biases, each from a 16-byte boundary,
    ``tile_px`` staged pixels and their 5 na logits (rounded up to 4
    pixels: a thread computes a column of 4)."""
    cols, px = 5 * na, -(-tile_px // 4) * 4
    return 4 * ((cin * cols + 3) // 4 * 4 + (cols + 3) // 4 * 4
                + px * (_row_pitch(cin) + cols))


@functools.lru_cache(maxsize=64)
def head_plan(n: int, maps: Tuple[Tuple[int, int, int], ...]) -> HeadPlan:
    """The head form's launch plan over ``maps``, (pixels an image, C_in,
    anchors a pixel) each: a block of HEAD_THREADS a tile of as many pixels,
    a multiple of 4, as give one item (a column of 4 pixels; a pixel has
    5 na columns) a thread, so the whole of both maps at 64 views is one wave
    of small blocks. (A sweep of 64-512 threads and one or two items a
    thread on an H100 found this the fastest or within a few percent;
    PERF.md.)"""
    threads = HEAD_THREADS
    tile_px = tuple(max(4, threads * 4 // (5 * na) // 4 * 4) for _hw, _c, na in maps)
    tiles = tuple(-(-n * hw // t) for (hw, _c, _na), t in zip(maps, tile_px))
    smem = max(head_smem_bytes(c, na, t) for (_hw, c, na), t in zip(maps, tile_px))
    return HeadPlan(threads, tile_px, tiles, smem)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pointwise(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              res: torch.Tensor, stride: int) -> torch.Tensor:
    """K10 (block form) on a CUDA tensor, ``pointwise_plain`` on a CPU
    tensor: ``y`` f32 [N, H, W, C_in], ``kernel`` [1, 1, C_in, C_out],
    ``res`` the block input [N, s H, s W, C_r <= C_out]; launched as
    ``k10_plan`` says."""
    if y.dtype != torch.float32 or y.dim() != 4:
        raise ValueError(f"pointwise takes f32 NHWC, got {y.dtype} {tuple(y.shape)}")
    n, h, w, cin = y.shape
    if tuple(kernel.shape[:3]) != (1, 1, cin):
        raise ValueError(f"pointwise kernel {tuple(kernel.shape)} for C_in = {cin}")
    cout = kernel.shape[3]
    if stride not in (1, 2) or tuple(res.shape[:3]) != (n, stride * h, stride * w) \
            or res.shape[3] > cout:
        raise ValueError(
            f"residual {tuple(res.shape)} does not fit {tuple(y.shape)} at "
            f"stride {stride} -> {cout} channels"
        )
    dev = y.device
    if dev.type == "cpu":
        return pointwise_plain(y, kernel, bias, res, stride)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    res_c = res.shape[3]
    plan = k10_plan(n, h, w, cin, cout, res_c, stride, _sm_count(dev.index))
    y, kernel, bias, res = (t if t.is_contiguous() else t.contiguous()
                            for t in (y, kernel, bias, res))
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=dev)
    rc = _lib().flyimg_bf_pointwise(
        y.data_ptr(), kernel.data_ptr(), bias.data_ptr(), res.data_ptr(),
        out.data_ptr(), n, h, w, cin, cout, res_c, int(stride == 2),
        plan.tile_px, int(plan.stage_out), plan.threads, plan.blocks,
        cuda_build.current_stream(dev.index),
    )
    cuda_build.check(rc, "blazeface pointwise")
    pointwise.launches += 1
    return out


#: K10 (block form) launches since the last reset
pointwise.launches = 0


def head_plain(x: torch.Tensor, cls_kernel: torch.Tensor, cls_bias: torch.Tensor,
               reg_kernel: torch.Tensor, reg_bias: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A map's raw head outputs: class logits [N, H W A] and box offsets
    [N, H W A, 4], flattened in (y, x, anchor) order as the JAX package
    flattens them."""
    n, h, w, cin = x.shape
    cls = torch.matmul(x, cls_kernel.reshape(cin, -1)) + cls_bias
    reg = torch.matmul(x, reg_kernel.reshape(cin, -1)) + reg_bias
    return cls.reshape(n, -1), reg.reshape(n, -1, 4)


def decode_boxes(raw: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Anchor-relative offsets [..., K, 4] -> (cx, cy, w, h) in [0, 1]."""
    cx = anchors[:, 0] + raw[..., 0] * 0.1 * anchors[:, 2]
    cy = anchors[:, 1] + raw[..., 1] * 0.1 * anchors[:, 3]
    w = anchors[:, 2] * torch.exp(torch.clamp(raw[..., 2] * 0.2, -4.0, 4.0))
    h = anchors[:, 3] * torch.exp(torch.clamp(raw[..., 3] * 0.2, -4.0, 4.0))
    return torch.stack([cx, cy, w, h], dim=-1)


def head_decode(maps: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor, int]],
                anchors: torch.Tensor, probs: torch.Tensor, boxes: torch.Tensor) -> None:
    """K10's head form: for each of the two anchor maps of ``maps`` — (x
    [N, H, W, C_in], class kernel, class bias, offset kernel, offset bias,
    anchor offset) — writes the sigmoid probabilities into ``probs`` [N, K]
    and the decoded boxes into ``boxes`` [N, K, 4] at anchors ``offset`` ..
    ``offset + H W A``. On CUDA tensors one launch for both maps
    (``head_plan``); on CPU tensors the plain head, sigmoid and
    ``decode_boxes`` a map."""
    if len(maps) != 2:
        raise ValueError(f"head_decode takes the two anchor maps, got {len(maps)}")
    k = anchors.shape[0]
    dev = maps[0][0].device
    shapes = []
    for x, cls_kernel, _cb, reg_kernel, _rb, offset in maps:
        n, h, w, cin = x.shape
        na = cls_kernel.shape[3]
        if (tuple(cls_kernel.shape[:3]) != (1, 1, cin)
                or tuple(reg_kernel.shape) != (1, 1, cin, 4 * na)
                or tuple(probs.shape) != (n, k) or tuple(boxes.shape) != (n, k, 4)
                or offset + h * w * na > k or x.device != dev):
            raise ValueError(
                f"head of {tuple(x.shape)} with kernels {tuple(cls_kernel.shape)}, "
                f"{tuple(reg_kernel.shape)} does not fit outputs {tuple(probs.shape)} "
                f"at offset {offset}"
            )
        shapes.append((h * w, cin, na))
    if dev.type == "cpu":
        for x, ck, cb, rk, rb, offset in maps:
            cls, raw = head_plain(x, ck, cb, rk, rb)
            end = offset + cls.shape[1]
            probs[:, offset:end] = torch.sigmoid(cls)
            boxes[:, offset:end] = decode_boxes(raw, anchors[offset:end])
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (probs.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("head outputs must be contiguous")
    plan = head_plan(probs.shape[0], tuple(shapes))
    # the contiguous copies are held until the launch is queued
    tensors = [[t if t.is_contiguous() else t.contiguous() for t in m[:5]] for m in maps]
    anchors = anchors if anchors.is_contiguous() else anchors.contiguous()
    args = []
    for i in range(2):
        args += [t.data_ptr() for t in tensors[i]]
        args += [*shapes[i], maps[i][5], plan.tile_px[i]]
    rc = _lib().flyimg_bf_head(
        *args, anchors.data_ptr(), probs.data_ptr(), boxes.data_ptr(),
        probs.shape[0], k, plan.threads, cuda_build.current_stream(dev.index),
    )
    cuda_build.check(rc, "blazeface head")
    head_decode.launches += 1


#: K10 (head form) launches since the last reset
head_decode.launches = 0


def _lib():
    lib = cuda_build.load("blazeface")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flyimg_bf_conv5x5.argtypes = [p] * 4 + [i] * 17 + [p]
        lib.flyimg_bf_pointwise.argtypes = [p] * 5 + [i] * 11 + [p]
        lib.flyimg_bf_head.argtypes = ([p] * 5 + [i] * 5) * 2 + [p] * 3 + [i] * 3 + [p]
        for fn in (lib.flyimg_bf_conv5x5, lib.flyimg_bf_pointwise,
                   lib.flyimg_bf_head):
            fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


class Conv(nn.Module):
    """A convolution's HWIO kernel and bias, as flax stores them."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kh, kw, cin, cout),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)


class BlazeBlock(nn.Module):
    """Depthwise 5x5 (K9) + pointwise 1x1 with residual and ReLU (K10);
    optional stride 2."""

    def __init__(self, channels: int, features: int, stride: int = 1) -> None:
        super().__init__()
        self.stride = stride
        self.dw_kernel = nn.Parameter(torch.zeros(5, 5, 1, channels),
                                      requires_grad=False)
        self.pw = Conv(1, 1, channels, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv5x5(x, self.dw_kernel, None, self.stride, relu=False)
        return pointwise(y, self.pw.kernel, self.pw.bias, x, self.stride)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        y = conv5x5_plain(x, self.dw_kernel, None, self.stride, relu=False)
        return pointwise_plain(y, self.pw.kernel, self.pw.bias, x, self.stride)


class BlazeFace(nn.Module):
    """Backbone + dual-scale anchor heads. ``forward`` maps [N, 128, 128, 3]
    f32 in [-1, 1] to (probs [N, 896], boxes [N, 896, 4]) through K9/K10 on
    the card; ``forward_plain`` gives what flax's ``BlazeFace().apply``
    gives — (logits [N, 896], raw offsets [N, 896, 4]) — from the plain
    versions on any device."""

    def __init__(self) -> None:
        super().__init__()
        self.stem = Conv(5, 5, 3, STEM_FEATURES)
        blocks, c = [], STEM_FEATURES
        for features, stride in BLOCKS:
            blocks.append(BlazeBlock(c, features, stride))
            c = features
        self.blocks = nn.ModuleList(blocks)
        c16 = BLOCKS[X16_BLOCK][0]
        self.cls16 = Conv(1, 1, c16, ANCHORS_16)
        self.reg16 = Conv(1, 1, c16, ANCHORS_16 * 4)
        self.cls8 = Conv(1, 1, c, ANCHORS_8)
        self.reg8 = Conv(1, 1, c, ANCHORS_8 * 4)
        self.register_buffer("anchors", torch.from_numpy(anchor_centers()),
                             persistent=False)

    def _heads(self):
        return ((self.cls16, self.reg16, 0),
                (self.cls8, self.reg8, 16 * 16 * ANCHORS_16))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = conv5x5(images, self.stem.kernel, self.stem.bias, 2, relu=True)
        maps = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i == X16_BLOCK:
                maps.append(x)
        maps.append(x)
        n = images.shape[0]
        probs = torch.empty((n, NUM_ANCHORS), dtype=torch.float32, device=x.device)
        boxes = torch.empty((n, NUM_ANCHORS, 4), dtype=torch.float32, device=x.device)
        head_decode([(fmap, cls.kernel, cls.bias, reg.kernel, reg.bias, offset)
                     for fmap, (cls, reg, offset) in zip(maps, self._heads())],
                    self.anchors, probs, boxes)
        return probs, boxes

    def forward_plain(self, images: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = conv5x5_plain(images, self.stem.kernel, self.stem.bias, 2, relu=True)
        maps = []
        for i, block in enumerate(self.blocks):
            x = block.forward_plain(x)
            if i == X16_BLOCK:
                maps.append(x)
        maps.append(x)
        parts = [head_plain(fmap, cls.kernel, cls.bias, reg.kernel, reg.bias)
                 for fmap, (cls, reg, _) in zip(maps, self._heads())]
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1))


def anchor_centers() -> np.ndarray:
    """[896, 4] anchors as (cx, cy, w, h) in [0, 1]."""
    anchors = []
    for grid, count, scale in ((16, ANCHORS_16, 0.10), (8, ANCHORS_8, 0.30)):
        for gy in range(grid):
            for gx in range(grid):
                cx = (gx + 0.5) / grid
                cy = (gy + 0.5) / grid
                for k in range(count):
                    s = scale * (1.0 + 0.5 * k / max(count - 1, 1))
                    anchors.append((cx, cy, s, s))
    return np.asarray(anchors, dtype=np.float32)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flat(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def flax_names() -> Dict[str, str]:
    """``BlazeFace`` state-dict key -> flax tree path under ``params/``."""
    names = {"stem": "Conv_0", "cls16": "Conv_1", "reg16": "Conv_2",
             "cls8": "Conv_3", "reg8": "Conv_4"}
    pairs = {}
    for ours, theirs in names.items():
        pairs[f"{ours}.kernel"] = f"{theirs}/kernel"
        pairs[f"{ours}.bias"] = f"{theirs}/bias"
    for i in range(len(BLOCKS)):
        pairs[f"blocks.{i}.dw_kernel"] = f"BlazeBlock_{i}/Conv_0/kernel"
        pairs[f"blocks.{i}.pw.kernel"] = f"BlazeBlock_{i}/Conv_1/kernel"
        pairs[f"blocks.{i}.pw.bias"] = f"BlazeBlock_{i}/Conv_1/bias"
    return pairs


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A ``BlazeFace`` state dict from the flax parameter tree (nested, or
    flat with ``/``-joined keys as the exporter writes it), arrays as
    stored (HWIO)."""
    flat = _flat(tree)
    flat = {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in flat.items()}
    pairs = flax_names()
    missing = sorted(v for v in pairs.values() if v not in flat)
    extra = sorted(set(flat) - set(pairs.values()))
    if missing or extra:
        raise ValueError(
            f"not a BlazeFace parameter tree: missing {missing[:4]}, "
            f"unexpected {extra[:4]}"
        )
    return {ours: torch.from_numpy(np.asarray(flat[theirs], np.float32).copy())
            for ours, theirs in pairs.items()}


def load_weights(path: str = PACKAGED_WEIGHTS,
                 device: Union[str, torch.device] = "cuda") -> BlazeFace:
    """A ``BlazeFace`` with the weights of the ``.npz`` at ``path``, on
    ``device``. An orbax checkpoint directory is refused: export it with
    ``tools/export_blazeface_npz.py`` first."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?); the PyTorch "
            f"package reads a .npz: run python {EXPORTER} --checkpoint "
            f"{path} --out <file>.npz and point face_checkpoint at that file"
        )
    with np.load(path) as z:
        state = params_from_flax({k: z[k] for k in z.files})
    model = BlazeFace()
    model.load_state_dict(state)
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# serving: views, network inputs, batched forward, NMS
# ---------------------------------------------------------------------------


def _forward(model: BlazeFace, images: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigmoid probabilities [N, 896], decoded boxes [N, 896, 4])."""
    with torch.inference_mode():
        return model(images)


def _network_input(rgb: np.ndarray) -> np.ndarray:
    resized = bilinear_resize(rgb, INPUT_SIZE, INPUT_SIZE).astype(np.float32)
    return resized / 127.5 - 1.0


def _boxes_from_scores(
    probs: np.ndarray,
    boxes: np.ndarray,
    src_w: int,
    src_h: int,
    score_threshold: float,
    max_faces: int,
) -> List[Tuple[int, int, int, int]]:
    """Greedy NMS over decoded anchors -> pixel boxes; the candidate budget
    scales with the number of views concatenated."""
    n_views = max(1, len(probs) // NUM_ANCHORS)
    keep = np.argsort(-probs)[: max_faces * 4 * n_views]
    out: List[Tuple[int, int, int, int]] = []
    taken: List[Tuple[float, float, float, float]] = []
    for idx in keep:
        if probs[idx] < score_threshold or len(out) >= max_faces:
            break
        cx, cy, w, h = boxes[idx]
        cand = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
        if any(_iou(cand, t) > 0.3 for t in taken):
            continue
        taken.append(cand)
        x0 = int(max(cand[0], 0.0) * src_w)
        y0 = int(max(cand[1], 0.0) * src_h)
        x1 = int(min(cand[2], 1.0) * src_w)
        y1 = int(min(cand[3], 1.0) * src_h)
        if x1 > x0 and y1 > y0:
            out.append((x0, y0, x1 - x0, y1 - y0))
    return out


#: corner tiles are added above this size (group-photo heads back in the
#: training scale range)
MULTISCALE_MIN_SIDE = 256
_TILE_FRAC = 0.6


def _views(rgb: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """(x, y, w, h) regions the fixed-input network runs over: the full
    frame, a zoomed-out 2x canvas, and four overlapping corner tiles for
    large frames. Regions may extend beyond the image (mid-gray)."""
    h, w = rgb.shape[:2]
    views = [(0, 0, w, h), (-w // 2, -h // 2, 2 * w, 2 * h)]
    if min(h, w) >= MULTISCALE_MIN_SIDE:
        tw, th = int(w * _TILE_FRAC), int(h * _TILE_FRAC)
        for ox in (0, w - tw):
            for oy in (0, h - th):
                views.append((ox, oy, tw, th))
    return views


def _view_input(rgb: np.ndarray, x: int, y: int, vw: int, vh: int) -> np.ndarray:
    """Network input for view (x, y, vw, vh), mid-gray outside the image;
    the visible part of a padded view resizes straight into its slot of
    the 128x128 canvas."""
    h, w = rgb.shape[:2]
    if 0 <= x and 0 <= y and x + vw <= w and y + vh <= h:
        return _network_input(rgb[y : y + vh, x : x + vw])
    canvas = np.full((INPUT_SIZE, INPUT_SIZE, 3), 128, np.uint8)
    sx0, sy0 = max(x, 0), max(y, 0)
    sx1, sy1 = min(x + vw, w), min(y + vh, h)
    if sx1 > sx0 and sy1 > sy0:
        dx0 = round((sx0 - x) * INPUT_SIZE / vw)
        dx1 = round((sx1 - x) * INPUT_SIZE / vw)
        dy0 = round((sy0 - y) * INPUT_SIZE / vh)
        dy1 = round((sy1 - y) * INPUT_SIZE / vh)
        if dx1 > dx0 and dy1 > dy0:
            canvas[dy0:dy1, dx0:dx1] = bilinear_resize(
                rgb[sy0:sy1, sx0:sx1], dx1 - dx0, dy1 - dy0
            )
    return canvas.astype(np.float32) / 127.5 - 1.0


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def detect_faces(
    model: BlazeFace,
    rgb: np.ndarray,
    *,
    score_threshold: float = 0.5,
    max_faces: int = 16,
) -> List[Tuple[int, int, int, int]]:
    """[h, w, 3] uint8 -> list of (x, y, w, h) pixel boxes."""
    return detect_faces_batch(
        model, [rgb], score_threshold=score_threshold, max_faces=max_faces
    )[0]


def detect_faces_batch(
    model: BlazeFace,
    rgbs: List[np.ndarray],
    *,
    score_threshold: float = 0.5,
    max_faces: int = 16,
) -> List[List[Tuple[int, int, int, int]]]:
    """Many images -> boxes: every view of every image through the
    network on the model's device in chunks of at most
    ``MAX_BATCH_BUCKET`` views, each padded (zeros) up the power-of-two
    ladder; per image, one NMS over all its views' anchors."""
    if not rgbs:
        return []
    dev = model.anchors.device
    views_per = [_views(rgb) for rgb in rgbs]
    flat: List[np.ndarray] = []
    for rgb, views in zip(rgbs, views_per):
        for x, y, vw, vh in views:
            flat.append(_view_input(rgb, x, y, vw, vh))
    probs_parts, boxes_parts = [], []
    for start in range(0, len(flat), MAX_BATCH_BUCKET):
        chunk = flat[start : start + MAX_BATCH_BUCKET]
        nb = _round_batch(len(chunk))
        inputs = np.zeros((nb, INPUT_SIZE, INPUT_SIZE, 3), np.float32)
        inputs[: len(chunk)] = np.stack(chunk)
        p, b = _forward(model, torch.from_numpy(inputs).to(dev))
        probs_parts.append(p[: len(chunk)].cpu().numpy())
        boxes_parts.append(b[: len(chunk)].cpu().numpy())
    probs = np.concatenate(probs_parts)
    boxes = np.concatenate(boxes_parts)

    out: List[List[Tuple[int, int, int, int]]] = []
    vi = 0
    for rgb, views in zip(rgbs, views_per):
        h, w = rgb.shape[:2]
        ps, bs = [], []
        for x, y, vw, vh in views:
            p = probs[vi]
            b = boxes[vi]
            vi += 1
            # view-normalized (cx, cy, w, h) -> full-frame normalized
            gb = np.stack(
                [
                    (x + b[:, 0] * vw) / w,
                    (y + b[:, 1] * vh) / h,
                    b[:, 2] * vw / w,
                    b[:, 3] * vh / h,
                ],
                axis=-1,
            )
            ps.append(p)
            bs.append(gb)
        out.append(
            _boxes_from_scores(
                np.concatenate(ps), np.concatenate(bs), w, h,
                score_threshold, max_faces,
            )
        )
    return out


#: the training half, importable under the JAX package's names
_TRAIN_NAMES = ("init_params", "loss_fn", "make_train_step", "synthetic_batch",
                "train_synthetic")


def __getattr__(name: str):
    if name in _TRAIN_NAMES:
        from flyimg_tpu_torch.models import blazeface_train

        return getattr(blazeface_train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
