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
  convolution + bias + ReLU) and every depthwise 5x5 convolution;
- K10 (``pointwise``): each block's 1x1 convolution + bias + residual
  (2x2 max-pooled at stride 2, zero-padded in channels) + ReLU; and its
  head form (``head_decode``): a map's class and offset convolutions with
  the sigmoid and the anchor decode in the epilogue, written into the
  [N, 896] probabilities and [N, 896, 4] boxes.

A forward is 35 launches: 17 of K9, 16 of K10 and 2 of its head form.
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
import os
from typing import Dict, List, Mapping, Optional, Tuple, Union

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
    [N, H, W, C_in] -> [N, ceil(H / s), ceil(W / s), C_out]."""
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
    if x.device.type == "cpu":
        return conv5x5_plain(x, kernel, bias, stride, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    pt, _, oh = same_pads(h, stride)
    pl, _, ow = same_pads(w, stride)
    x = x.contiguous()
    kernel = kernel.detach().contiguous()
    bias = None if bias is None else bias.detach().contiguous()
    out = torch.empty((n, oh, ow, cout), dtype=torch.float32, device=x.device)
    rc = _lib().flyimg_bf_conv5x5(
        x.data_ptr(), kernel.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, w, cin, oh, ow, cout, stride, pt, pl, int(depthwise), int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
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


def pointwise(y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              res: torch.Tensor, stride: int) -> torch.Tensor:
    """K10 (block form) on a CUDA tensor, ``pointwise_plain`` on a CPU
    tensor: ``y`` f32 [N, H, W, C_in], ``kernel`` [1, 1, C_in, C_out],
    ``res`` the block input [N, s H, s W, C_r <= C_out]."""
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
    if y.device.type == "cpu":
        return pointwise_plain(y, kernel, bias, res, stride)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    y = y.contiguous()
    res = res.contiguous()
    kernel = kernel.detach().contiguous()
    bias = bias.detach().contiguous()
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=y.device)
    rc = _lib().flyimg_bf_pointwise(
        y.data_ptr(), kernel.data_ptr(), bias.data_ptr(), res.data_ptr(),
        out.data_ptr(), n, h, w, cin, cout, res.shape[3], int(stride == 2),
        torch.cuda.current_stream(y.device).cuda_stream,
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


def head_decode(x: torch.Tensor, cls_kernel: torch.Tensor, cls_bias: torch.Tensor,
                reg_kernel: torch.Tensor, reg_bias: torch.Tensor,
                anchors: torch.Tensor, probs: torch.Tensor, boxes: torch.Tensor,
                offset: int) -> None:
    """K10's head form on a CUDA tensor (the plain head, sigmoid and
    ``decode_boxes`` on a CPU tensor): writes the map's sigmoid
    probabilities into ``probs`` [N, K] and its decoded boxes into
    ``boxes`` [N, K, 4] at anchors ``offset`` .. ``offset + H W A``."""
    n, h, w, cin = x.shape
    na = cls_kernel.shape[3]
    k = anchors.shape[0]
    if (tuple(cls_kernel.shape[:3]) != (1, 1, cin)
            or tuple(reg_kernel.shape) != (1, 1, cin, 4 * na)
            or tuple(probs.shape) != (n, k) or tuple(boxes.shape) != (n, k, 4)
            or offset + h * w * na > k):
        raise ValueError(
            f"head of {tuple(x.shape)} with kernels {tuple(cls_kernel.shape)}, "
            f"{tuple(reg_kernel.shape)} does not fit outputs {tuple(probs.shape)} "
            f"at offset {offset}"
        )
    end = offset + h * w * na
    if x.device.type == "cpu":
        cls, raw = head_plain(x, cls_kernel, cls_bias, reg_kernel, reg_bias)
        probs[:, offset:end] = torch.sigmoid(cls)
        boxes[:, offset:end] = decode_boxes(raw, anchors[offset:end])
        return
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (probs.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("head outputs must be contiguous")
    x = x.contiguous()
    args = [t.detach().contiguous() for t in
            (cls_kernel, cls_bias, reg_kernel, reg_bias, anchors)]
    rc = _lib().flyimg_bf_head(
        x.data_ptr(), *(t.data_ptr() for t in args), probs.data_ptr(),
        boxes.data_ptr(), n, h * w, cin, na, k, offset,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, "blazeface head")
    head_decode.launches += 1


#: K10 (head form) launches since the last reset
head_decode.launches = 0


def _lib():
    lib = cuda_build.load("blazeface")
    if not getattr(lib, "_flyimg_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flyimg_bf_conv5x5.argtypes = [p] * 4 + [i] * 12 + [p]
        lib.flyimg_bf_pointwise.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.flyimg_bf_head.argtypes = [p] * 8 + [i] * 6 + [p]
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
        for fmap, (cls, reg, offset) in zip(maps, self._heads()):
            head_decode(fmap, cls.kernel, cls.bias, reg.kernel, reg.bias,
                        self.anchors, probs, boxes, offset)
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
