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

- ``_Conv5x5``: forward K9 (``conv5x5``), backward K11
  (``conv5x5_backward``, ``csrc/blazeface_train.cu``);
- ``_Pointwise``: forward K10 (``pointwise``), backward K12
  (``pointwise_backward``);
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
import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from flyimg_tpu_torch import cuda_build
from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models import blazeface as bf

LEARNING_RATE = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
#: the number of per-chunk partial sums K11 and K12 aim for (a reduction
#: over pixels is two-stage: chunks, then the chunks in order)
CHUNK_TARGET = 256
K12_TILE = 16
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
# K11: the backward of K9
# ---------------------------------------------------------------------------


def k11_plan(n: int, oh: int) -> Tuple[int, int]:
    """(output rows a chunk, chunks) of K11's weight-gradient reduction."""
    rows = max(1, -(-n * oh // CHUNK_TARGET))
    return rows, -(-n * oh // rows)


def conv5x5_backward_plain(g: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                           out: Optional[torch.Tensor], stride: int, has_bias: bool,
                           need_dx: bool):
    """The plain version of K11: (dx or None, dkernel HWIO, dbias or None)
    of ``conv5x5(x, kernel, bias, stride, relu)`` given the output gradient
    ``g``; ``out`` is the saved output when the layer had a ReLU."""
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
    return dx, dk, db


def conv5x5_backward(g: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                     out: Optional[torch.Tensor] = None, stride: int = 1,
                     has_bias: bool = False, need_dx: bool = True,
                     grads_out: Optional[Tuple] = None):
    """K11 on a CUDA tensor, ``conv5x5_backward_plain`` on a CPU tensor.
    The input gradient is taken of depthwise convolutions only (the stem's
    input is the images). ``grads_out``: (dkernel, dbias or None), where
    the weight gradients are written instead of new tensors."""
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
    dk_out, db_out = (None, None) if grads_out is None else grads_out
    if not _on_card("conv5x5_backward", x=x, g=g, kernel=kernel, out=out,
                    dkernel=dk_out, dbias=db_out):
        dx, dk, db = conv5x5_backward_plain(g, x, kernel, out, stride, has_bias, need_dx)
        return dx, _put(dk, dk_out), _put(db, db_out)
    pt, _, _ = bf.same_pads(h, stride)
    pl, _, _ = bf.same_pads(w, stride)
    x, g, kernel = x.contiguous(), g.contiguous(), kernel.detach().contiguous()
    out = None if out is None else out.contiguous()
    rows, chunks = k11_plan(n, oh)
    q = cin if depthwise else cin * cout
    m = 25 * q + (cout if has_bias else 0)
    partial = torch.empty(chunks * m, dtype=torch.float32, device=x.device)
    dk = _grad_out(dk_out, kernel.shape, x, "conv5x5_backward dkernel")
    db = _grad_out(db_out, (cout,), x, "conv5x5_backward dbias") if has_bias else None
    dx = torch.empty_like(x) if need_dx else None
    rc = _lib().flyimg_bf_conv5x5_backward(
        x.data_ptr(), g.data_ptr(), _ptr(out), kernel.data_ptr(), _ptr(dx),
        dk.data_ptr(), _ptr(db), partial.data_ptr(), n, h, w, cin, oh, ow, cout,
        stride, pt, pl, int(depthwise), rows, _stream(x),
    )
    cuda_build.check(rc, "blazeface conv5x5_backward")
    conv5x5_backward.launches += 1
    return dx, dk, db


#: K11 launches since the last reset (a call is three launches, two
#: without the input gradient)
conv5x5_backward.launches = 0


# ---------------------------------------------------------------------------
# K12: the backward of K10, and of the heads
# ---------------------------------------------------------------------------


def k12_plan(pixels: int) -> Tuple[int, int]:
    """(pixels a chunk, a multiple of the 16-pixel tile; chunks) of K12."""
    per = -(-pixels // CHUNK_TARGET)
    per = max(K12_TILE, -(-per // K12_TILE) * K12_TILE)
    return per, -(-pixels // per)


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
    """K12 on a CUDA tensor, ``pointwise_backward_plain`` on a CPU tensor.
    ``g`` [N, H, W, C_out] may have any member stride (a head's slice of
    the [N, 896] gradients) but dense pixels and channels. ``grads_out``:
    (dkernel, dbias), where the weight gradients are written instead of
    new tensors."""
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
    chunk_px, chunks = k12_plan(n * h * w)
    partial = torch.empty(chunks * (cin * cout + cout), dtype=torch.float32, device=y.device)
    dk = _grad_out(dk_out, kernel.shape, y, "pointwise_backward dkernel")
    db = _grad_out(db_out, (cout,), y, "pointwise_backward dbias")
    accumulate = dy is not None
    if dy is None:
        dy = torch.empty_like(y)
    dres = None if res is None else torch.empty_like(res)
    rc = _lib().flyimg_bf_pointwise_backward(
        g.data_ptr(), g.stride(0), _ptr(gscale), _ptr(out), y.data_ptr(),
        kernel.data_ptr(), _ptr(res), dy.data_ptr(), _ptr(dres), dk.data_ptr(),
        db.data_ptr(), partial.data_ptr(), n, h, w, cin, cout,
        0 if res is None else res.shape[3], int(stride == 2), int(accumulate),
        chunk_px, _stream(y),
    )
    cuda_build.check(rc, "blazeface pointwise_backward")
    pointwise_backward.launches += 1
    return dy, dk, db, dres


#: K12 launches since the last reset (a call is two launches)
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


def head_loss(x16, x8, heads, target_probs, target_boxes, anchor_mask):
    """K13 on a CUDA tensor (two launches), ``head_loss_plain`` on a CPU
    tensor."""
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
    f32 = dict(dtype=torch.float32, device=x16.device)
    tp, tb, mask = (t.contiguous() for t in (target_probs, target_boxes, anchor_mask))
    dlogits = torch.empty((n, bf.NUM_ANCHORS), **f32)
    draw = torch.empty((n, bf.NUM_ANCHORS, 4), **f32)
    loss = torch.empty(1, **f32)
    partial = torch.empty(3 * (-(-n * bf.NUM_ANCHORS // 256)), **f32)
    count = np.float32(n * bf.NUM_ANCHORS)
    rc = _lib().flyimg_bf_head_loss(
        *args, tp.data_ptr(), tb.data_ptr(), mask.data_ptr(), dlogits.data_ptr(),
        draw.data_ptr(), loss.data_ptr(), partial.data_ptr(), n,
        float(np.float32(1.0) / count), float(count), _stream(x16),
    )
    cuda_build.check(rc, "blazeface head_loss")
    head_loss.launches += 1
    return loss.view(()), dlogits, draw


#: K13 launches since the last reset (a call is two launches)
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
        lib.flyimg_bf_conv5x5_backward.argtypes = [p] * 8 + [i] * 12 + [p]
        lib.flyimg_bf_pointwise_backward.argtypes = (
            [p, ll] + [p] * 10 + [i] * 9 + [p])
        lib.flyimg_bf_head_loss.argtypes = (
            ([p] * 5 + [i] * 3) * 2 + [p] * 7 + [i, f, f, p])
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


class _Pointwise(torch.autograd.Function):
    """K10 forward, K12 backward."""

    @staticmethod
    def forward(ctx, y, kernel, bias, res, stride, into):
        out = bf.pointwise(y, kernel, bias, res, stride)
        ctx.stride, ctx.into = stride, into
        ctx.save_for_backward(y, kernel, res, out)
        return out

    @staticmethod
    def backward(ctx, g):
        y, kernel, res, out = ctx.saved_tensors
        dy, dk, db, dres = pointwise_backward(g, y, kernel, out, res, ctx.stride,
                                              grads_out=ctx.into)
        if ctx.into is not None:
            dk = db = None
        return dy, dk, db, dres, None, None


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
        y = _Conv5x5.apply(x, block.dw_kernel, None, block.stride, False,
                           into(block.dw_kernel, None))
        x = _Pointwise.apply(y, block.pw.kernel, block.pw.bias, x, block.stride,
                             into(block.pw.kernel, block.pw.bias))
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
