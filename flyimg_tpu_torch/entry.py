"""The flagship batched forward of the PyTorch package.

The counterpart of ``__graft_entry__.entry()``: ``entry()`` returns
``(fn, args)`` where ``fn(*args)`` runs one batch of the
"resize + smart-crop" workload on the card —

1. the crop-fill resample of 512x512x3 u8 sources to 300x250 u8
   (``w_300,h_250,c_1``), dense (two f32 matmuls) or banded (kernel K1)
   as the process-wide ``resample_kernel`` mode selects;
2. the smart-crop saliency field of every output (kernel K2);
3. the scoring correlation of each field with one 150x150 importance
   kernel at stride 8 (kernel K3), giving a [B, 13, 19] score grid.

``fn`` returns ``(out u8 [B, 250, 300, 3], scores f32 [B, 13, 19])``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from flyimg_tpu_torch.device import resolve_device
from flyimg_tpu_torch.models.smartcrop import (
    _batched_scores,
    _batched_weighted,
    importance_kernel,
)
from flyimg_tpu_torch.ops.compose import make_program_fn, plan_layout
from flyimg_tpu_torch.ops.resample import kernel_mode, select_band_taps
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan

BATCH = 256
SRC = 512
OUT_HW = (250, 300)
STRIDE = 8


def flagship_band():
    """The band widths the current kernel mode selects for the flagship
    geometry (None = dense)."""
    plan = build_plan(OptionsBag("w_300,h_250,c_1"), SRC, SRC)
    layout = plan_layout(plan)
    return select_band_taps(
        kernel_mode(), plan.filter_method, (SRC, SRC),
        layout.span_y, layout.span_x, layout.out_true,
    )


def flagship_fn(device: Union[str, torch.device] = "cuda"):
    dev = resolve_device(device)
    plan = build_plan(OptionsBag("w_300,h_250,c_1"), SRC, SRC).device_plan()
    program = make_program_fn(
        OUT_HW, None, (0, 0), plan, band_taps=flagship_band()
    )
    kernel = torch.from_numpy(importance_kernel(150.0, 150.0)).to(dev)
    kernels = kernel[None, :, :, None, None].contiguous()

    def forward(images, in_true, span_y, span_x, out_true):
        out = program(images, in_true, span_y, span_x, out_true)
        b = out.shape[0]
        valid = torch.tensor(OUT_HW, dtype=torch.float32, device=out.device)
        weighted = _batched_weighted(out, valid.expand(b, 2).contiguous())
        grids, _totals = _batched_scores(weighted, kernels, STRIDE)
        return out, grids[..., 0]

    return forward


def entry(device: Union[str, torch.device] = "cuda", batch: int = BATCH):
    """(fn, example_args) for one flagship batch on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 255, (batch, SRC, SRC, 3), dtype=np.uint8)
    ).to(dev)

    def rows(values):
        return torch.tensor([values], dtype=torch.float32, device=dev).repeat(
            batch, 1
        )

    in_true = rows([float(SRC), float(SRC)])
    # crop-fill 512x512 -> 300x250: fill scale .5859 -> window 512x426.7
    span_y = rows([42.6, 426.7])
    span_x = rows([0.0, 512.0])
    out_true = rows([250.0, 300.0])
    return flagship_fn(dev), (images, in_true, span_y, span_x, out_true)
