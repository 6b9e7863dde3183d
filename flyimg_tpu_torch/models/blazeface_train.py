"""BlazeFace training on the card: the loss, its backward and Adam (K11-K14).

The port of the training half of ``flyimg_tpu/models/blazeface.py``:
``init_params`` (flax's ``nn.Conv`` defaults: ``lecun_normal`` kernels —
truncated normals of variance 1 / fan_in — and zero biases, drawn from a
``torch.Generator``), ``synthetic_batch`` (numpy, the same draws in the
same order as the JAX package's), ``loss_fn``, ``make_train_step``
(``value_and_grad`` + ``optax.adam(1e-3)``) and ``train_synthetic``.
Weights go out as the ``.npz`` of ``tools/export_blazeface_npz.py``
(``save_weights``), which ``models/blazeface.py load_weights`` and the
service's ``face_checkpoint`` read.

The train step runs through ``torch.autograd.Function``s whose forward is
the serving kernels and whose backward is this module's:

- ``_Conv5x5`` (the stem): forward K9 (``conv5x5``), backward K11
  (``conv5x5_backward``, ``csrc/blazeface_train.cu``);
- ``_Block`` (each BlazeBlock): forward K9 then K10 (``pointwise``),
  backward K12 (``pointwise_backward``) then K11, which adds the depthwise
  convolution's input gradient into K12's residual gradient;
- ``_HeadLoss``: forward K13 (``head_loss``: both maps' head products, the
  sigmoid, the loss and its gradient in the logits and raw offsets),
  backward the heads' 1x1 products through K12 with no ReLU and no
  residual;
- the update: K14 (``adam_update``) over the flat parameter buffer
  (``flatten_parameters``), with its first and second moments. In a train
  step the backward kernels write the weight gradients straight into the
  flat gradient buffer that K14 reads.

Each wrapper runs its plain PyTorch twin only for a CPU tensor; for a
CUDA tensor it launches its kernel or raises. The plain reference is
``loss_fn_plain`` (torch autograd over ``BlazeFace.forward_plain`` and
``loss_plain``: cuDNN's convolutions on the card) with
``adam_update_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models import blazeface as bf

LEARNING_RATE = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: flax's lecun_normal: a standard normal truncated to [-2, 2], scaled so
#: that the variance is 1 / fan_in (this is that normal's std)
_TRUNC_STD = 0.87962566103423978


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on_card(what: str, **tensors) -> bool:
    """False for CPU tensors (run the plain twin), True for CUDA ones. The
    first tensor names the device; every other one given (``None`` is
    skipped) must lie on it, so that no host pointer reaches a kernel."""
    given = [(k, t) for k, t in tensors.items() if t is not None]
    dev = given[0][1].device
    for name, t in given[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return True


def _grad_out(t: Optional[torch.Tensor], shape, like: torch.Tensor, what: str):
    """``t`` checked as where a gradient of ``shape`` is written, or a new
    tensor when it is None."""
    if t is None:
        return torch.empty(tuple(shape), dtype=torch.float32, device=like.device)
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or not t.is_contiguous()):
        raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} is not a contiguous f32 "
                         f"{tuple(shape)}")
    return t


def _put(result: Optional[torch.Tensor], out: Optional[torch.Tensor]):
    """A plain twin's ``result``, copied into ``out`` when one is given."""
    return result if out is None or result is None else out.copy_(result)


# ---------------------------------------------------------------------------
# K11 and K12: launch plans and scratch
# ---------------------------------------------------------------------------

#: threads a K11 or K12 block (csrc kThreads)
TRAIN_THREADS = 256
#: K11: channels a slice (a block takes one), outputs a thread's window
#: slides over (csrc kRun), sums a dk thread hands to the lane reduction
K11_SLICE = 8
K11_RUN = 4
K11_RED = 24
#: K11: the most chunks a slice's tiles are cut into (each a block whose
#: partial the slice's last block sums), and the shared memory a plan aims
#: under (two blocks an SM)
K11_MAX_CHUNKS = 64
K11_SMEM_TARGET = 110 * 1024
#: K12: the most channels on a side of a dW tile, pixels staged at a time by
#: a dW block and its stages (csrc kDwSubPx, kDwStages), the fewest pixels a chunk,
#: dW blocks an SM, the most partial floats a tile, the most chunks one
#: block sums alone (more are summed in two levels), sums a dW thread hands
#: to the lane reduction
K12_MAX_TILE = 32
K12_SUB_PX = 32
K12_STAGES = 4
K12_MIN_CHUNK_PX = 64
K12_WAVES = 2
K12_PARTIAL_CAP = 262144
K12_ONE_LEVEL = 24
K12_RED = 20


def _ceil4(c: int) -> int:
    return -(-c // 4) * 4


def _bank_pitch(floats: int, c4: int) -> int:
    """The smallest multiple of 4 floats >= ``floats`` whose 16-byte chunks
    are c4 modulo 8: staged rows that many chunks apart put the c4 channel
    groups of eight consecutive rows on eight distinct banks."""
    chunks = -(-floats // 4)
    return 4 * next(chunks + pad for pad in range(8) if (chunks + pad - c4) % 8 == 0)


class K11Plan(NamedTuple):
    """How K11 walks one layer (``k11_plan``)."""

    cs: int               # channels a slice (depthwise C, else C_out); a multiple of 4
    slices: int
    tho: int              # output-gradient rows a tile (a band of one image, the whole width)
    bands: int
    tiles_per_chunk: int
    chunks: int           # a block a (slice, chunk); blocks = slices x chunks
    g_rows: int           # staged rows: g (the band and its halo), x (under the band)
    gp: int               # floats a staged g row
    x_rows: int
    xp: int               # floats a staged x row
    lanes: int            # threads sharing one dk sum (a float4 of channels x a kernel row)
    stages: int
    smem_bytes: int
    partial_floats: int   # the dk partials of every (slice, chunk)


def _k11_gw_cols(w: int, stride: int, depthwise: bool) -> int:
    """g window columns K11 reads (csrc k11_gw_cols): the runs of 4 outputs
    past the row's end, and at stride 2 each parity class's runs."""
    pl, _, ow = bf.same_pads(w, stride)
    runs = -(-ow // K11_RUN)
    if not depthwise:
        return runs * K11_RUN
    if stride == 1:
        return runs * K11_RUN + 4
    need = runs * K11_RUN + 2
    for px in (0, 1):
        n_lo, n_hi = (pl - px + 1) // 2, (w - 1 + pl - px) // 2
        need = max(need, n_lo + -(-max(0, n_hi - n_lo + 1) // K11_RUN) * K11_RUN + 2)
    return need


@functools.lru_cache(maxsize=512)
def k11_plan(n: int, h: int, w: int, cin: int, cout: int, stride: int, depthwise: bool,
             masked: bool, sm_count: int = 132) -> K11Plan:
    """K11's launch plan for a layer with an [n, h, w, cin] input: slices of
    K11_SLICE channels (depthwise) or output channels (the stem); tiles of
    the output-gradient rows that give the block's threads about one dx item
    each (a float4 x a run of 4), or 4 rows for the stem, shrunk while two
    stages exceed K11_SMEM_TARGET; the tiles cut into at most K11_MAX_CHUNKS
    chunks a slice, about two blocks an SM in all."""
    if stride not in (1, 2):
        raise ValueError(f"conv5x5_backward on the card takes stride 1 or 2, got {stride}")
    oh, ow = bf.same_pads(h, stride)[2], bf.same_pads(w, stride)[2]
    c = cin if depthwise else cout
    cs = min(K11_SLICE, _ceil4(c))
    c4 = cs // 4
    runs = -(-ow // K11_RUN)
    qn = 5 * c4 * (1 if depthwise else cin)
    if qn > TRAIN_THREADS:
        raise ValueError(f"conv5x5_backward: {cin} input channels are more than a block takes")
    lanes = TRAIN_THREADS // qn
    gw = _k11_gw_cols(w, stride, depthwise)
    xw = (runs * K11_RUN - 1) * stride + 5
    if depthwise:
        gp, xp = _bank_pitch(gw * cs, c4), _bank_pitch(xw * cs, c4)
    else:
        gp, xp = gw * cs, _ceil4(3 + xw * cin)

    def rows(tho):
        g_rows = tho + (4 if stride == 1 else 3) if depthwise else tho
        return g_rows, (tho - 1) * stride + 5

    def smem(tho, stages):
        g_rows, x_rows = rows(tho)
        stage = (2 if masked else 1) * g_rows * gp + x_rows * xp
        return 4 * max((25 * cs if depthwise else 0) + stages * stage, TRAIN_THREADS * K11_RED)

    want = -(-TRAIN_THREADS // (c4 * runs * stride * stride)) if depthwise else 4
    tho = max(1, min(oh, want))
    while tho > 1 and smem(tho, 2) > K11_SMEM_TARGET:
        tho -= 1
    if smem(tho, 2) > bf.SMEM_BLOCK_MAX:
        raise ValueError(f"conv5x5_backward: a layer {w} wide with {cin} -> {cout} channels "
                         f"needs {smem(tho, 2)} bytes of shared memory for one row")
    bands = -(-oh // tho)
    tiles = n * bands
    slices = -(-c // cs)
    chunks = min(tiles, -(-2 * sm_count // slices), K11_MAX_CHUNKS)
    tpc = -(-tiles // chunks)
    chunks = -(-tiles // tpc)
    stages = 2 if tpc > 1 else 1
    g_rows, x_rows = rows(tho)
    part = (26 if depthwise else 25 * cin + 1) * cs
    return K11Plan(cs, slices, tho, bands, tpc, chunks, g_rows, gp, x_rows, xp, lanes,
                   stages, smem(tho, stages), slices * chunks * part)


class K12Plan(NamedTuple):
    """How K12 walks one layer (``k12_plan``)."""

    dy_tile: int        # pixels a dy block: 64, 32 or 16
    dy_blocks: int
    tci: int            # a dW tile's channels: ci (a multiple of 4, <= K12_MAX_TILE)
    tco: int            # ... and co
    ci_tiles: int
    co_tiles: int
    chunk_px: int       # pixels a dW block (a multiple of K12_SUB_PX)
    chunks: int         # dW blocks = ci_tiles x co_tiles x chunks, launched first
    group: int          # chunks a group: the last block of each sums the group's
                        # partials, the last of those the tile's group sums
    smem_bytes: int
    partial_floats: int  # the dW/db partials of every (tile, chunk), then the group sums
    counters: int        # tickets: a tile's groups and the tile


@functools.lru_cache(maxsize=512)
def k12_plan(n: int, h: int, w: int, cin: int, cout: int, masked: bool,
             sm_count: int = 132) -> K12Plan:
    """K12's launch plan for a layer of [n, h, w] pixels: dy blocks of the
    largest of 64, 32, 16 pixels that still gives half as many blocks as
    SMs; dW tiles of at most K12_MAX_TILE x K12_MAX_TILE channels, each
    tile's pixels cut into about K12_WAVES dW blocks an SM in all (chunks of
    at least K12_MIN_CHUNK_PX pixels, and no more than keeps a tile's
    partials within K12_PARTIAL_CAP floats); more than K12_ONE_LEVEL chunks
    are summed in groups of about sqrt(chunks), so that no one block sums
    more than ~2 sqrt(chunks) partials. (Sweeps of the waves and the cap on
    an H100 chose these; PERF.md, PR 10.)"""
    pixels = n * h * w
    dy_tile = next((t for t in (64, 32) if pixels >= t * sm_count // 2), 16)
    tci, tco = min(K12_MAX_TILE, _ceil4(cin)), min(K12_MAX_TILE, _ceil4(cout))
    ci_tiles, co_tiles = -(-cin // tci), -(-cout // tco)
    tiles = ci_tiles * co_tiles
    tsz = tci * tco + tco
    chunks = max(1, min(-(-pixels // K12_MIN_CHUNK_PX), -(-K12_WAVES * sm_count // tiles),
                        K12_PARTIAL_CAP // tsz))
    chunk_px = -(-(-(-pixels // chunks)) // K12_SUB_PX) * K12_SUB_PX
    chunks = -(-pixels // chunk_px)
    wp = bf._row_pitch(cout)
    k = 2 if masked else 1
    dy_floats = (_ceil4(cin) + k * dy_tile) * wp
    dw_floats = max(K12_STAGES * K12_SUB_PX * (bf._row_pitch(tci) + k * bf._row_pitch(tco)),
                    TRAIN_THREADS * K12_RED)
    group = chunks if chunks <= K12_ONE_LEVEL else math.isqrt(chunks - 1) + 1
    groups = -(-chunks // group)
    return K12Plan(dy_tile, -(-pixels // dy_tile), tci, tco, ci_tiles, co_tiles, chunk_px,
                   chunks, group, 4 * max(dy_floats, dw_floats),
                   tiles * (chunks + groups) * tsz, tiles * (groups + 1))


#: (device index, stream) -> (f32 partials, int32 ticket counters): K11's
#: and K12's scratch, grown as a layer needs and kept, the counters left at
#: zero by the kernels (calls on one stream run in order)
_SCRATCH = {}


def _scratch(dev: torch.device, stream: int, floats: int, counters: int):
    key = (dev.index, stream)
    part, count = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
    if count is None or count.numel() < counters:
        count = torch.zeros(max(counters, 64), dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, count)
    return part, count


# ---------------------------------------------------------------------------
# K11: the backward of K9
# ---------------------------------------------------------------------------


def conv5x5_backward_plain(g: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                           out: Optional[torch.Tensor], stride: int, has_bias: bool,
                           need_dx: bool, dx_into: Optional[torch.Tensor] = None):
    """The plain version of K11: (dx or None, dkernel HWIO, dbias or None)
    of ``conv5x5(x, kernel, bias, stride, relu)`` given the output gradient
    ``g``; ``out`` is the saved output when the layer had a ReLU. With
    ``dx_into`` the input gradient is added into it in place (``dx_into +=
    dx``) and dx is ``dx_into``."""
    n, h, w, cin = x.shape
    pt, pb, _ = bf.same_pads(h, stride)
    pl, pr, _ = bf.same_pads(w, stride)
    if out is not None:
        g = torch.where(out > 0, g, torch.zeros_like(g))
    groups = cin if bf._is_depthwise(kernel, cin) else 1
    gn = g.permute(0, 3, 1, 2)
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wn = kernel.permute(3, 2, 0, 1)
    dk = torch.nn.grad.conv2d_weight(xp, wn.shape, gn, stride=stride, groups=groups)
    dk = dk.permute(2, 3, 1, 0).contiguous()
    db = g.sum(dim=(0, 1, 2)) if has_bias else None
    dx = None
    if need_dx:
        dxp = torch.nn.grad.conv2d_input(xp.shape, wn, gn, stride=stride, groups=groups)
        dx = dxp[:, :, pt:pt + h, pl:pl + w].permute(0, 2, 3, 1).contiguous()
        if dx_into is not None:
            dx = dx_into.add_(dx)
    return dx, dk, db


def conv5x5_backward(g: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                     out: Optional[torch.Tensor] = None, stride: int = 1,
                     has_bias: bool = False, need_dx: bool = True,
                     grads_out: Optional[Tuple] = None,
                     dx_into: Optional[torch.Tensor] = None):
    """K11 on a CUDA tensor (one launch, as ``k11_plan`` says),
    ``conv5x5_backward_plain`` on a CPU tensor. The input gradient is taken
    of depthwise convolutions only (the stem's input is the images); with
    ``dx_into`` (a contiguous f32 tensor of x's shape, K12's residual
    gradient in a block) it is added into that in place and returned.
    ``grads_out``: (dkernel, dbias or None), where the weight gradients are
    written instead of new tensors."""
    n, h, w, cin = x.shape
    depthwise = bf._is_depthwise(kernel, cin)
    cout = kernel.shape[3]
    _, _, oh = bf.same_pads(h, stride)
    _, _, ow = bf.same_pads(w, stride)
    if tuple(g.shape) != (n, oh, ow, cout):
        raise ValueError(f"gradient {tuple(g.shape)} for output {(n, oh, ow, cout)}")
    if need_dx and not depthwise:
        raise ValueError("conv5x5_backward takes the input gradient of depthwise "
                         "convolutions only")
    if dx_into is not None and (not need_dx or tuple(dx_into.shape) != tuple(x.shape)
                                or dx_into.dtype != torch.float32
                                or not dx_into.is_contiguous()):
        raise ValueError("dx_into must be a contiguous f32 tensor of x's shape, and the "
                         "input gradient taken")
    dk_out, db_out = (None, None) if grads_out is None else grads_out
    if not _on_card("conv5x5_backward", x=x, g=g, kernel=kernel, out=out,
                    dkernel=dk_out, dbias=db_out, dx_into=dx_into):
        dx, dk, db = conv5x5_backward_plain(g, x, kernel, out, stride, has_bias, need_dx,
                                            dx_into)
        return dx, _put(dk, dk_out), _put(db, db_out)
    pt, _, _ = bf.same_pads(h, stride)
    pl, _, _ = bf.same_pads(w, stride)
    x, g, kernel = x.contiguous(), g.contiguous(), kernel.detach().contiguous()
    out = None if out is None else out.contiguous()
    dev = x.device
    plan = k11_plan(n, h, w, cin, cout, stride, depthwise, out is not None,
                    bf._sm_count(dev.index))
    stream = cuda_build.current_stream(dev.index)
    partial, counters = _scratch(dev, stream, plan.partial_floats, plan.slices)
    dk = _grad_out(dk_out, kernel.shape, x, "conv5x5_backward dkernel")
    db = _grad_out(db_out, (cout,), x, "conv5x5_backward dbias") if has_bias else None
    dx = None
    if need_dx:
        dx = dx_into if dx_into is not None else torch.empty_like(x)
    rc = _lib().flyimg_bf_conv5x5_backward(
        x.data_ptr(), g.data_ptr(), _ptr(out), kernel.data_ptr(), _ptr(dx), _ptr(dx_into),
        dk.data_ptr(), _ptr(db), partial.data_ptr(), counters.data_ptr(), n, h, w, cin, oh,
        ow, cout, stride, pt, pl, int(depthwise), plan.cs, plan.tho, plan.tiles_per_chunk,
        plan.gp, plan.xp, plan.lanes, stream,
    )
    cuda_build.check(rc, "blazeface conv5x5_backward")
    conv5x5_backward.launches += 1
    return dx, dk, db


#: K11 launches since the last reset (one a call)
conv5x5_backward.launches = 0


# ---------------------------------------------------------------------------
# K12: the backward of K10, and of the heads
# ---------------------------------------------------------------------------


def _pool_backward(g: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """Route g [N, H, W, C] to the first maximum, in row-major order, of
    each 2x2 window of res [N, 2H, 2W, C]; zeros elsewhere."""
    n, h2, w2, c = res.shape
    win = res.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    first = F.one_hot(win.reshape(n, h2 // 2, w2 // 2, c, 4).argmax(-1), 4)
    d = first.to(g.dtype) * g[..., None]
    return d.reshape(n, h2 // 2, w2 // 2, c, 2, 2).permute(0, 1, 4, 2, 5, 3).reshape(res.shape)


def pointwise_backward_plain(g, y, kernel, out=None, res=None, stride=1, gscale=None,
                             dy=None):
    """The plain version of K12: (dy, dkernel, dbias, dres or None) of
    ``relu(y . W + b + residual(res))`` (``out`` the saved output) or, with
    no ``out`` and no ``res``, of a head's ``y . W + b``; ``g`` is scaled by
    ``gscale``, and ``dy`` when given is added to in place."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    if gscale is not None:
        g = g * gscale
    if out is not None:
        g = torch.where(out > 0, g, torch.zeros_like(g))
    g2 = g.reshape(-1, cout)
    d = torch.matmul(g2, kernel.reshape(cin, cout).t()).reshape(y.shape)
    if dy is None:
        dy = d
    else:
        dy.add_(d)
    dk = torch.matmul(y.reshape(-1, cin).t(), g2).reshape(kernel.shape)
    db = g2.sum(dim=0)
    dres = None
    if res is not None:
        gr = g[..., :res.shape[3]]
        dres = _pool_backward(gr, res) if stride == 2 else gr.contiguous()
    return dy, dk, db, dres


def pointwise_backward(g, y, kernel, out=None, res=None, stride=1, gscale=None, dy=None,
                       grads_out=None):
    """K12 on a CUDA tensor (one launch, as ``k12_plan`` says),
    ``pointwise_backward_plain`` on a CPU tensor. ``g`` [N, H, W, C_out] may
    have any member stride (a head's slice of the [N, 896] gradients) but
    dense pixels and channels. ``grads_out``: (dkernel, dbias), where the
    weight gradients are written instead of new tensors."""
    n, h, w, cin = y.shape
    cout = kernel.shape[3]
    if tuple(kernel.shape[:3]) != (1, 1, cin) or tuple(g.shape) != (n, h, w, cout):
        raise ValueError(f"pointwise_backward: gradient {tuple(g.shape)}, input "
                         f"{tuple(y.shape)}, kernel {tuple(kernel.shape)}")
    if res is not None and (tuple(res.shape[:3]) != (n, stride * h, stride * w)
                            or res.shape[3] > cout):
        raise ValueError(f"residual {tuple(res.shape)} does not fit {tuple(y.shape)} "
                         f"at stride {stride}")
    if dy is not None and (tuple(dy.shape) != tuple(y.shape) or not dy.is_contiguous()):
        raise ValueError("dy to add to must be contiguous and of y's shape")
    dk_out, db_out = (None, None) if grads_out is None else grads_out
    if not _on_card("pointwise_backward", y=y, g=g, kernel=kernel, out=out, res=res,
                    gscale=gscale, dy=dy, dkernel=dk_out, dbias=db_out):
        dy, dk, db, dres = pointwise_backward_plain(g, y, kernel, out, res, stride, gscale, dy)
        return dy, _put(dk, dk_out), _put(db, db_out), dres
    if tuple(g.stride()[1:]) != (w * cout, cout, 1):
        g = g.contiguous()
    y, kernel = y.contiguous(), kernel.detach().contiguous()
    out = None if out is None else out.contiguous()
    res = None if res is None else res.contiguous()
    gscale = None if gscale is None else gscale.detach().contiguous()
    dev = y.device
    plan = k12_plan(n, h, w, cin, cout, out is not None, bf._sm_count(dev.index))
    stream = cuda_build.current_stream(dev.index)
    partial, counters = _scratch(dev, stream, plan.partial_floats, plan.counters)
    dk = _grad_out(dk_out, kernel.shape, y, "pointwise_backward dkernel")
    db = _grad_out(db_out, (cout,), y, "pointwise_backward dbias")
    accumulate = dy is not None
    if dy is None:
        dy = torch.empty_like(y)
    dres = None if res is None else torch.empty_like(res)
    rc = _lib().flyimg_bf_pointwise_backward(
        g.data_ptr(), g.stride(0), _ptr(gscale), _ptr(out), y.data_ptr(),
        kernel.data_ptr(), _ptr(res), dy.data_ptr(), _ptr(dres), dk.data_ptr(),
        db.data_ptr(), partial.data_ptr(), counters.data_ptr(), n, h, w, cin, cout,
        0 if res is None else res.shape[3], int(stride == 2), int(accumulate),
        plan.dy_tile, plan.tci, plan.tco, plan.chunk_px, plan.group, stream,
    )
    cuda_build.check(rc, "blazeface pointwise_backward")
    pointwise_backward.launches += 1
    return dy, dk, db, dres


#: K12 launches since the last reset (one a call)
pointwise_backward.launches = 0


# ---------------------------------------------------------------------------
# K13: the heads, the loss and its gradient
# ---------------------------------------------------------------------------


def loss_plain(logits, raw, target_probs, target_boxes, anchor_mask):
    """The JAX package's ``loss_fn`` after the forward, in torch ops:
    focal-weighted BCE on ``sigmoid(logits)`` plus the masked smooth-L1 of
    the raw offsets."""
    probs = torch.sigmoid(logits)
    bce = -(target_probs * torch.log(probs + 1e-7)
            + (1.0 - target_probs) * torch.log(1.0 - probs + 1e-7))
    focal = bce * (0.25 + 0.75 * target_probs)
    cls_loss = torch.mean(focal)
    diff = raw - target_boxes
    l1 = torch.where(diff.abs() < 1.0, 0.5 * diff * diff, diff.abs() - 0.5)
    reg_loss = torch.sum(l1 * anchor_mask[..., None]) / (torch.sum(anchor_mask) * 4.0 + 1e-6)
    return cls_loss + reg_loss


def head_loss_plain(x16, x8, heads, target_probs, target_boxes, anchor_mask):
    """The plain version of K13: (loss, dlogits [N, 896], draw [N, 896, 4])
    from the two maps and ``heads`` = ((cls kernel, cls bias, reg kernel,
    reg bias) of the 16x16 map, the same of the 8x8 map), by autograd over
    ``loss_plain``."""
    parts = [bf.head_plain(x.detach(), *(t.detach() for t in h))
             for x, h in zip((x16, x8), heads)]
    logits = torch.cat([p[0] for p in parts], dim=1).requires_grad_(True)
    raw = torch.cat([p[1] for p in parts], dim=1).requires_grad_(True)
    with torch.enable_grad():
        loss = loss_plain(logits, raw, target_probs, target_boxes, anchor_mask)
        dlogits, draw = torch.autograd.grad(loss, (logits, raw))
    return loss.detach(), dlogits, draw


#: K13's pixel tiles (16x16 map, 8x8 map), largest first: a plan takes the
#: largest whose tiles fill the card's SMs; threads a K13 block (csrc
#: kHeadThreads: a thread an anchor of the tile)
K13_TILES = ((64, 16), (32, 16), (16, 8), (8, 4))
K13_THREADS = 128


class K13Plan(NamedTuple):
    tile16: int     # pixels of the 16x16 map a tile (a block)
    tile8: int      # pixels of the 8x8 map a tile
    tiles16: int    # tiles of the 16x16 map, n ceil(hw16 / tile16)
    tiles: int      # all tiles
    partial_floats: int


def k13_plan(n: int, hw16: int, na16: int, hw8: int, na8: int, sms: int = 132) -> K13Plan:
    """K13's tiles at ``n`` members: the largest pair of ``K13_TILES``
    giving at least ``sms`` tiles (the smallest when none does), capped so
    that a block's ``K13_THREADS`` threads hold a tile's anchors. Tile t < tiles16 is
    pixels [(t % per16) tile16, ...) of member t // per16 of the 16x16 map;
    the rest the same of the 8x8 map."""
    for tile16, tile8 in K13_TILES:
        tile16 = min(tile16, hw16, K13_THREADS // na16)
        tile8 = min(tile8, hw8, K13_THREADS // na8)
        tiles16 = n * -(-hw16 // tile16)
        tiles = tiles16 + n * -(-hw8 // tile8)
        if tiles >= sms:
            break
    return K13Plan(tile16, tile8, tiles16, tiles, 2 * tiles)


def head_loss(x16, x8, heads, target_probs, target_boxes, anchor_mask):
    """K13 on a CUDA tensor (one launch, as ``k13_plan`` says),
    ``head_loss_plain`` on a CPU tensor."""
    n = x16.shape[0]
    if (x8.shape[0] != n or tuple(target_probs.shape) != (n, bf.NUM_ANCHORS)
            or tuple(target_boxes.shape) != (n, bf.NUM_ANCHORS, 4)
            or tuple(anchor_mask.shape) != (n, bf.NUM_ANCHORS)):
        raise ValueError(f"head_loss: maps {tuple(x16.shape)}, {tuple(x8.shape)}, "
                         f"targets {tuple(target_probs.shape)}, "
                         f"{tuple(target_boxes.shape)}, {tuple(anchor_mask.shape)}")
    anchors = 0
    for x, (ck, _cb, rk, _rb) in zip((x16, x8), heads):
        c = x.shape[3]
        if tuple(ck.shape[:3]) != (1, 1, c) or tuple(rk.shape) != (1, 1, c, 4 * ck.shape[3]):
            raise ValueError(f"head kernels {tuple(ck.shape)}, {tuple(rk.shape)} "
                             f"for a map of {c} channels")
        anchors += x.shape[1] * x.shape[2] * ck.shape[3]
    if anchors != bf.NUM_ANCHORS:
        raise ValueError(f"the maps carry {anchors} anchors, not {bf.NUM_ANCHORS}")
    if not _on_card("head_loss", x16=x16, x8=x8, target_probs=target_probs,
                    target_boxes=target_boxes, anchor_mask=anchor_mask,
                    **{f"heads[{i}][{j}]": t for i, h in enumerate(heads)
                       for j, t in enumerate(h)}):
        return head_loss_plain(x16, x8, heads, target_probs, target_boxes, anchor_mask)
    args, keep = [], []  # keep: the contiguous copies, alive through the call
    for x, head in zip((x16, x8), heads):
        x, ck, cb, rk, rb = (t.detach().contiguous() for t in (x, *head))
        keep += [x, ck, cb, rk, rb]
        args += [x.data_ptr(), ck.data_ptr(), cb.data_ptr(), rk.data_ptr(),
                 rb.data_ptr(), x.shape[1] * x.shape[2], x.shape[3], ck.shape[3]]
    dev = x16.device
    f32 = dict(dtype=torch.float32, device=dev)
    tp, tb, mask = (t.contiguous() for t in (target_probs, target_boxes, anchor_mask))
    dlogits = torch.empty((n, bf.NUM_ANCHORS), **f32)
    draw = torch.empty((n, bf.NUM_ANCHORS, 4), **f32)
    loss = torch.empty(1, **f32)
    plan = k13_plan(n, args[5], args[7], args[13], args[15], bf._sm_count(dev.index))
    stream = cuda_build.current_stream(dev.index)
    partial, counters = _scratch(dev, stream, plan.partial_floats, 1)
    count = np.float32(n * bf.NUM_ANCHORS)
    rc = _lib().flyimg_bf_head_loss(
        *args, tp.data_ptr(), tb.data_ptr(), mask.data_ptr(), dlogits.data_ptr(),
        draw.data_ptr(), loss.data_ptr(), partial.data_ptr(), counters.data_ptr(), n,
        plan.tile16, plan.tile8, float(np.float32(1.0) / count), float(count), stream,
    )
    cuda_build.check(rc, "blazeface head_loss")
    head_loss.launches += 1
    return loss.view(()), dlogits, draw


#: K13 launches since the last reset (one a call)
head_loss.launches = 0


# ---------------------------------------------------------------------------
# K14: Adam
# ---------------------------------------------------------------------------


def adam_constants(step: int):
    """optax.adam(1e-3)'s f32 constants at step ``step`` (1-based): (1 - b1,
    b1, 1 - b2, b2, 1 - b1^t, 1 - b2^t, eps, -lr)."""
    f = np.float32
    return (f(1 - ADAM_B1), f(ADAM_B1), f(1 - ADAM_B2), f(ADAM_B2),
            f(1) - f(ADAM_B1) ** f(step), f(1) - f(ADAM_B2) ** f(step), f(ADAM_EPS),
            f(-LEARNING_RATE))


def adam_update_plain(params, grads, mu, nu, step) -> None:
    """The plain version of K14, in place: optax's ``mu = (1 - b1) g + b1
    mu``, ``nu = (1 - b2) g^2 + b2 nu`` and ``params += -lr mu_hat /
    (sqrt(nu_hat) + eps)`` with bias-corrected moments, every constant a
    tensor on the parameters' device (so no division turns into a
    multiply by a reciprocal)."""
    omb1, b1f, omb2, b2f, bc1, bc2, epsf, neg_lr = (
        torch.tensor(c, dtype=torch.float32, device=params.device)
        for c in adam_constants(step))
    mu.copy_(omb1 * grads + b1f * mu)
    nu.copy_(omb2 * (grads * grads) + b2f * nu)
    params.add_(neg_lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + epsf)))


def adam_update(params, grads, mu, nu, step) -> None:
    """K14 on CUDA tensors (one launch), ``adam_update_plain`` on CPU
    tensors: flat f32 ``params``, ``mu``, ``nu`` updated in place."""
    for t in (params, grads, mu, nu):
        if t.dtype != torch.float32 or t.dim() != 1 or t.shape != params.shape \
                or not t.is_contiguous():
            raise ValueError("adam_update takes flat contiguous f32 tensors of one size")
    if not _on_card("adam_update", params=params, grads=grads, mu=mu, nu=nu):
        adam_update_plain(params, grads, mu, nu, step)
        return
    consts = [float(c) for c in adam_constants(step)]
    rc = _lib().flyimg_bf_adam(
        params.data_ptr(), grads.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        params.numel(), *consts, _stream(params),
    )
    cuda_build.check(rc, "blazeface adam")
    adam_update.launches += 1


#: K14 launches since the last reset
adam_update.launches = 0


class Adam:
    """optax.adam(1e-3) on a flat parameter buffer through K14; ``count`` is
    optax's step count."""

    def __init__(self, params: torch.Tensor) -> None:
        self.params = params
        self.mu = torch.zeros_like(params)
        self.nu = torch.zeros_like(params)
        self.count = 0

    def step(self, grads: torch.Tensor) -> None:
        self.count += 1
        adam_update(self.params, grads, self.mu, self.nu, self.count)


def _lib():
    lib = cuda_build.load("blazeface_train")
    if not getattr(lib, "_flyimg_bound", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flyimg_bf_conv5x5_backward.argtypes = [p] * 10 + [i] * 17 + [p]
        lib.flyimg_bf_pointwise_backward.argtypes = (
            [p, ll] + [p] * 11 + [i] * 13 + [p])
        lib.flyimg_bf_head_loss.argtypes = (
            ([p] * 5 + [i] * 3) * 2 + [p] * 8 + [i] * 3 + [f, f, p])
        lib.flyimg_bf_adam.argtypes = [p] * 4 + [ll] + [f] * 8 + [p]
        for fn in (lib.flyimg_bf_conv5x5_backward, lib.flyimg_bf_pointwise_backward,
                   lib.flyimg_bf_head_loss, lib.flyimg_bf_adam):
            fn.restype = ctypes.c_int
        lib._flyimg_bound = True
    return lib


# ---------------------------------------------------------------------------
# autograd: the kernels' forward and backward
# ---------------------------------------------------------------------------


# ``into`` below: None, or where the backward writes its weight gradients
# (views of ``model.flat_grads``, the parameters' ``.grad``); it then
# returns None for them, so autograd adds nothing to the buffer.


class _Conv5x5(torch.autograd.Function):
    """K9 forward, K11 backward."""

    @staticmethod
    def forward(ctx, x, kernel, bias, stride, relu, into):
        out = bf.conv5x5(x, kernel, bias, stride, relu)
        ctx.stride, ctx.has_bias, ctx.into = stride, bias is not None, into
        ctx.save_for_backward(x, kernel, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, out = ctx.saved_tensors
        dx, dk, db = conv5x5_backward(g, x, kernel, out, ctx.stride, ctx.has_bias,
                                      ctx.needs_input_grad[0], ctx.into)
        if ctx.into is not None:
            dk = db = None
        return dx, dk, db, None, None, None


class _Block(torch.autograd.Function):
    """A BlazeBlock: K9 (the depthwise 5x5) then K10 forward; K12 then K11
    backward, K11 adding its input gradient into K12's residual gradient,
    so the block input gets one gradient and autograd adds nothing."""

    @staticmethod
    def forward(ctx, x, dw_kernel, pw_kernel, pw_bias, stride, into):
        y = bf.conv5x5(x, dw_kernel, None, stride, False)
        out = bf.pointwise(y, pw_kernel, pw_bias, x, stride)
        ctx.stride, ctx.into = stride, into
        ctx.save_for_backward(x, dw_kernel, y, pw_kernel, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, dw_kernel, y, pw_kernel, out = ctx.saved_tensors
        into = (None, None, None) if ctx.into is None else ctx.into
        dy, dpk, dpb, dres = pointwise_backward(
            g, y, pw_kernel, out, x, ctx.stride,
            grads_out=None if ctx.into is None else into[1:])
        dx, ddk, _ = conv5x5_backward(
            dy, x, dw_kernel, None, ctx.stride, False, True,
            None if ctx.into is None else (into[0], None), dx_into=dres)
        if ctx.into is not None:
            ddk = dpk = dpb = None
        return dx, ddk, dpk, dpb, None, None


class _HeadLoss(torch.autograd.Function):
    """K13 forward (the loss; its gradient in the logits and offsets is
    kept), the heads' products' backward through K12."""

    @staticmethod
    def forward(ctx, x16, x8, target_probs, target_boxes, anchor_mask, into, *head_params):
        heads = (head_params[:4], head_params[4:])
        loss, dlogits, draw = head_loss(x16, x8, heads, target_probs, target_boxes,
                                        anchor_mask)
        ctx.into = into
        ctx.save_for_backward(x16, x8, dlogits, draw, *head_params)
        return loss

    @staticmethod
    def backward(ctx, gl):
        x16, x8, dlogits, draw, *hp = ctx.saved_tensors
        views = (None,) * 8 if ctx.into is None else ctx.into
        n = x16.shape[0]
        dxs, grads, off = [], [], 0
        for i, x in enumerate((x16, x8)):
            ck, cb, rk, rb = hp[4 * i:4 * i + 4]
            _, h, w, _ = x.shape
            na = ck.shape[3]
            k = h * w * na
            gc = dlogits[:, off:off + k].view(n, h, w, na)
            gr = draw[:, off:off + k].view(n, h, w, 4 * na)
            dx, dck, dcb, _ = pointwise_backward(gc, x, ck, gscale=gl,
                                                 grads_out=views[4 * i:4 * i + 2])
            dx, drk, drb, _ = pointwise_backward(gr, x, rk, gscale=gl, dy=dx,
                                                 grads_out=views[4 * i + 2:4 * i + 4])
            dxs.append(dx)
            grads += [dck, dcb, drk, drb]
            off += k
        if ctx.into is not None:
            grads = [None] * 8
        return (dxs[0], dxs[1], None, None, None, None, *grads)


def _head_params(model: bf.BlazeFace):
    return [t for cls, reg, _ in model._heads()
            for t in (cls.kernel, cls.bias, reg.kernel, reg.bias)]


def loss_fn(model: bf.BlazeFace, images, target_probs, target_boxes, anchor_mask):
    """The JAX package's ``loss_fn`` through the kernels: K9/K10 forward,
    K13 for the heads and the loss; ``backward()`` runs K12/K11. A 0-dim
    tensor."""
    return _kernel_loss(model, images, target_probs, target_boxes, anchor_mask, False)


def _kernel_loss(model, images, target_probs, target_boxes, anchor_mask, into_flat):
    """``loss_fn``; with ``into_flat`` its backward writes every parameter's
    gradient into ``model.flat_grads`` (overwriting it, not adding to it)
    and none reaches autograd."""

    def into(*params):
        if not into_flat:
            return None
        return tuple(None if p is None else model.grad_views[p] for p in params)

    x = _Conv5x5.apply(images, model.stem.kernel, model.stem.bias, 2, True,
                       into(model.stem.kernel, model.stem.bias))
    maps = []
    for i, block in enumerate(model.blocks):
        x = _Block.apply(x, block.dw_kernel, block.pw.kernel, block.pw.bias, block.stride,
                         into(block.dw_kernel, block.pw.kernel, block.pw.bias))
        if i == bf.X16_BLOCK:
            maps.append(x)
    heads = _head_params(model)
    return _HeadLoss.apply(maps[0], x, target_probs, target_boxes, anchor_mask,
                           into(*heads), *heads)


def loss_fn_plain(model: bf.BlazeFace, images, target_probs, target_boxes, anchor_mask):
    """The same loss from ``forward_plain`` and ``loss_plain``: torch
    autograd (cuDNN on the card) differentiates it."""
    logits, raw = model.forward_plain(images)
    return loss_plain(logits, raw, target_probs, target_boxes, anchor_mask)


# ---------------------------------------------------------------------------
# parameters, the step, the loop
# ---------------------------------------------------------------------------


def flatten_parameters(model: bf.BlazeFace) -> bf.BlazeFace:
    """Make every parameter trainable and a view of one flat buffer
    (``model.flat_params``, in ``parameters()`` order), so that K14 updates
    all of them in one pass; ``model.flat_grads`` is the same layout for
    their gradients (``model.grad_views``: each parameter's view of it).
    Call it after the model is on its device."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    model.flat_grads = torch.zeros_like(flat)
    model.grad_views = {}
    off = 0
    for p in params:
        p.data = flat[off:off + p.numel()].view_as(p)
        p.requires_grad_(True)
        model.grad_views[p] = model.flat_grads[off:off + p.numel()].view_as(p)
        off += p.numel()
    model.flat_params = flat
    return model


def init_params(seed: int = 0, device: Union[str, torch.device] = "cuda") -> bf.BlazeFace:
    """A trainable ``BlazeFace`` with flax's ``nn.Conv`` initialisation:
    lecun_normal kernels (fan_in = kh kw C_in / groups), zero biases, drawn
    on the CPU from ``torch.Generator().manual_seed(seed)`` (JAX's
    ``PRNGKey`` values cannot be reproduced: carry them across with
    ``params_from_flax`` and ``flatten_parameters``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = bf.BlazeFace()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
                continue
            std = (1.0 / (p.shape[0] * p.shape[1] * p.shape[2])) ** 0.5 / _TRUNC_STD
            torch.nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return flatten_parameters(model.to(dev))


def make_train_step(model: bf.BlazeFace):
    """(optimizer, train_step): ``train_step(images, target_probs,
    target_boxes, anchor_mask)`` takes one ``value_and_grad`` + adam step
    of ``model`` in place and returns the loss before the step (0-dim, on
    the device). The backward kernels write the gradients into
    ``model.flat_grads``, which K14 reads; each parameter's ``.grad`` is
    its view of that buffer."""
    if not hasattr(model, "flat_params"):
        flatten_parameters(model)
    for p, view in model.grad_views.items():
        p.grad = view
    optimizer = Adam(model.flat_params)

    def train_step(images, target_probs, target_boxes, anchor_mask):
        loss = _kernel_loss(model, images, target_probs, target_boxes, anchor_mask, True)
        loss.backward()
        optimizer.step(model.flat_grads)
        return loss.detach()

    return optimizer, train_step


def synthetic_batch(rng: np.random.Generator, batch: int):
    """Synthetic training batch: coloured ellipse "faces" on noise with the
    matching anchor targets — the JAX package's draws, in its order, so one
    seed gives both packages the same arrays."""
    anchors = bf.anchor_centers()
    size_in = bf.INPUT_SIZE
    images = rng.uniform(-1, 1, (batch, size_in, size_in, 3)).astype(np.float32)
    target_probs = np.zeros((batch, bf.NUM_ANCHORS), np.float32)
    target_boxes = np.zeros((batch, bf.NUM_ANCHORS, 4), np.float32)
    mask = np.zeros((batch, bf.NUM_ANCHORS), np.float32)
    for i in range(batch):
        cx, cy = rng.uniform(0.3, 0.7, 2)
        size = rng.uniform(0.15, 0.4)
        yy, xx = np.mgrid[0:size_in, 0:size_in] / size_in
        ellipse = ((xx - cx) ** 2 + (yy - cy) ** 2) < (size / 2) ** 2
        images[i][ellipse] = (0.56, 0.14, -0.12)  # skin-ish in [-1, 1]
        dist = np.abs(anchors[:, 0] - cx) + np.abs(anchors[:, 1] - cy)
        pos = np.argsort(dist)[:8]
        target_probs[i, pos] = 1.0
        mask[i, pos] = 1.0
        target_boxes[i, pos, 0] = (cx - anchors[pos, 0]) / (0.1 * anchors[pos, 2])
        target_boxes[i, pos, 1] = (cy - anchors[pos, 1]) / (0.1 * anchors[pos, 3])
        target_boxes[i, pos, 2] = np.log(size / anchors[pos, 2]) / 0.2
        target_boxes[i, pos, 3] = np.log(size / anchors[pos, 3]) / 0.2
    return images, target_probs, target_boxes, mask


def batch_to(arrays: Sequence[np.ndarray], dev: torch.device):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def train_synthetic(steps: int = 200, batch: int = 16, seed: int = 0,
                    log_every: int = 0, device: Union[str, torch.device] = "cuda"):
    """Train from scratch on the synthetic ellipse-face task: ``(model,
    loss)``, the loss of the last step's batch before its update (NaN for
    ``steps=0``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = init_params(seed, dev)
    _optimizer, train_step = make_train_step(model)
    loss = None
    for step in range(steps):
        loss = train_step(*batch_to(synthetic_batch(rng, batch), dev))
        if log_every and step % log_every == 0:
            print(f"step {step}: loss {float(loss):.4f}")
    return model, float("nan") if loss is None else float(loss)


def save_weights(model: bf.BlazeFace, path: str) -> None:
    """Write ``model``'s parameters as the ``.npz`` that
    ``tools/export_blazeface_npz.py`` writes: keys
    ``params/BlazeBlock_i/Conv_j/kernel`` and so on, flax HWIO, f32."""
    names = bf.flax_names()
    arrays = {f"params/{names[k]}": v.detach().cpu().numpy().astype(np.float32)
              for k, v in model.state_dict().items()}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    np.savez_compressed(path, **dict(sorted(arrays.items())))
