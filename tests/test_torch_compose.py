"""The PyTorch package's program composer and batcher against the JAX
package's ``run_plan``, dense and banded, on the same numpy-seeded images.
Bound: at most 1 u8 level (tests/test_resample_banded.py's)."""

import numpy as np
import pytest
import torch

from flyimg_tpu.ops import compose as jcompose
from flyimg_tpu.ops import resample as jresample
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu_torch.exceptions import NotPortedException
from flyimg_tpu_torch.ops import compose as tcompose
from flyimg_tpu_torch.ops import resample as tresample
from flyimg_tpu_torch.runtime.batcher import BatchController, classify_error
from flyimg_tpu_torch.spec.options import OptionsBag as TOptionsBag
from flyimg_tpu_torch.spec.plan import build_plan as tbuild_plan

torch.set_num_threads(1)

OPTIONS = [
    "w_300,h_250,c_1",
    "w_200",
    "h_150",
    "e_1,p1x_30,p1y_20,p2x_260,p2y_190",
    "w_120,h_120,c_1,g_NorthWest",
    "w_160,h_90,c_1,g_SouthEast,f_triangle",
]


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 3) % 256, (xx * 2) % 256, (xx + yy) % 256], -1)
    noise = rng.integers(0, 40, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.fixture(params=["dense", "banded"])
def mode(request):
    before_t, before_j = tresample.kernel_mode(), jresample.kernel_mode()
    tresample.set_kernel_mode(request.param)
    jresample.set_kernel_mode(request.param)
    yield request.param
    tresample.set_kernel_mode(before_t)
    jresample.set_kernel_mode(before_j)


@pytest.mark.parametrize("opts", OPTIONS)
def test_run_plan_matches_jax(opts, mode):
    img = image(240, 320, len(opts))
    tplan = tbuild_plan(TOptionsBag(opts), 320, 240)
    jplan = jbuild_plan(JOptionsBag(opts), 320, 240)
    got = tcompose.run_plan(img, tplan, device="cpu")
    ref = jcompose.run_plan(img, jplan)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_run_plan_src_window_matches_jax(mode):
    img = image(240, 320, 3)
    opts = "w_100,h_100,c_1"
    tplan = tbuild_plan(TOptionsBag(opts), 320, 240)
    jplan = jbuild_plan(JOptionsBag(opts), 320, 240)
    window = img[10:230, 30:290]
    got = tcompose.run_plan(window, tplan, src_window=(30, 10), device="cpu")
    ref = jcompose.run_plan(window, jplan, src_window=(30, 10))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_batched_program_pads_three_to_four(mode):
    batcher = BatchController(device="cpu", deadline_ms=60_000.0,
                              max_batch=3, lone_flush=False)
    try:
        imgs = [image(300, 400, s) for s in range(3)]
        plan = tbuild_plan(TOptionsBag("w_300,h_250,c_1"), 400, 300)
        futures = [batcher.submit(im, plan) for im in imgs]
        outs = [f.result(timeout=120) for f in futures]
    finally:
        batcher.close()
    assert list(batcher.launch_log) == [("transform", 3, 4)]
    jplan = jbuild_plan(JOptionsBag("w_300,h_250,c_1"), 400, 300)
    for im, out in zip(imgs, outs):
        ref = jcompose.run_plan(im, jplan)
        assert out.shape == ref.shape == (250, 300, 3)
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_batcher_slices_bucketed_fit_outputs(mode):
    batcher = BatchController(device="cpu", deadline_ms=60_000.0,
                              max_batch=2, lone_flush=False)
    try:
        plans = [tbuild_plan(TOptionsBag("w_150"), 320, 240),
                 tbuild_plan(TOptionsBag("w_150"), 320, 200)]
        imgs = [image(240, 320, 1), image(200, 320, 2)]
        outs = [batcher.submit(im, p) for im, p in zip(imgs, plans)]
        outs = [f.result(timeout=120) for f in outs]
    finally:
        batcher.close()
    for im, out, h in zip(imgs, outs, (240, 200)):
        ref = jcompose.run_plan(im, jbuild_plan(JOptionsBag("w_150"), 320, h))
        assert out.shape == ref.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("opts,stage", [
    ("w_200,r_90", "rotate"),
    ("w_200,clsp_Gray", "grayscale"),
    ("w_200,mnchr_1", "monochrome"),
    ("w_200,unsh_0.25x0.25+8+0.065", "unsharp"),
    ("w_200,sh_2x1", "sharpen"),
    ("w_200,blr_1x0.5", "blur"),
    ("w_300,h_250,ett_400x320", "pad"),
])
def test_unported_stage_raises_naming_it(opts, stage):
    plan = tbuild_plan(TOptionsBag(opts), 320, 240)
    with pytest.raises(NotPortedException, match=stage):
        tcompose.run_plan(image(240, 320, 0), plan, device="cpu")


def test_out_of_memory_is_never_poison():
    assert classify_error(torch.OutOfMemoryError("CUDA out of memory")) == "oversize"
    assert classify_error(ValueError("bad member")) == "error"
