"""The PyTorch package's program composer and batcher against the JAX
package's ``run_plan``, dense and banded, on the same numpy-seeded images.
Bound: at most 1 u8 level (tests/test_resample_banded.py's); the staged
programs allow more only at counted knife-edge values."""

import jax.numpy as jnp
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
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.runtime.resilience import OVERSIZE, POISON, classify_batch_error
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


STAGE_CASES = [
    ("w_200,r_90", "rotate"),
    ("w_200,clsp_Gray", "grayscale"),
    ("w_200,mnchr_1", "monochrome"),
    ("w_200,unsh_0.25x0.25+8+0.065", "unsharp"),
    ("w_200,sh_2x1", "sharpen"),
    ("w_200,blr_1x0.5", "blur"),
    ("w_300,h_250,ett_400x320", "pad"),
]

#: distance to a knife-edge within which the two sides may disagree
KNIFE = 1e-3


def _jax_stage_inputs(img, jplan, monkeypatch):
    """Run the JAX package's program eagerly with run_plan's inputs,
    recording what its dither, unsharp and rotate stages receive: the
    JAX-side values that say where a knife-edge lies."""
    seen = {}
    for name in ("monochrome_dither", "unsharp_mask", "rotate_image"):
        def spy(x, *args, _real=getattr(jcompose, name), _name=name):
            seen[_name] = (np.asarray(x), args)
            return _real(x, *args)
        monkeypatch.setattr(jcompose, name, spy)
    h, w = img.shape[:2]
    layout = jcompose.plan_layout(jplan)
    bh, bw = jcompose._bucket_dim(h), jcompose._bucket_dim(w)
    padded = np.zeros((bh, bw, 3), np.uint8)
    padded[:h, :w] = img
    band = jresample.select_band_taps(
        jresample.kernel_mode(), jplan.filter_method, (bh, bw),
        layout.span_y, layout.span_x, layout.out_true)
    fn = jcompose.make_program_fn(
        layout.resample_out, layout.pad_canvas, layout.pad_offset,
        jplan.device_plan(), band_taps=band)
    f32 = jnp.float32
    fn(jnp.asarray(padded), jnp.array([h, w], f32), jnp.array(layout.span_y, f32),
       jnp.array(layout.span_x, f32), jnp.array(layout.out_true, f32))
    return seen


def _knife_edges(seen, out_shape):
    """[h, w, 3] bool: output values within KNIFE of a dither threshold, an
    unsharp threshold or rotate's fill edge, from the JAX side's values."""
    from flyimg_tpu.ops.color import LUMA_WEIGHTS, _BAYER8
    from flyimg_tpu.ops.filters import gaussian_blur

    knife = np.zeros(out_shape, bool)
    if "monochrome_dither" in seen:
        x, _ = seen["monochrome_dither"]
        luma = (x.astype(np.float64) * np.array(LUMA_WEIGHTS)).sum(-1)
        h, w = luma.shape
        tile = np.tile(_BAYER8, (h // 8 + 1, w // 8 + 1))[:h, :w]
        thr = (tile.astype(np.float64) + 0.5) * (255.0 / 64.0)
        knife |= (np.abs(luma - thr) < KNIFE)[..., None]
    if "unsharp_mask" in seen:
        x, (r, s, _gain, thr) = seen["unsharp_mask"]
        diff = np.abs(x - np.asarray(gaussian_blur(jnp.asarray(x), r, s)))
        knife |= np.abs(diff - thr * 255.0) < KNIFE
    if "rotate_image" in seen and seen["rotate_image"][1][0] % 90 != 0:
        x, (deg, _bg) = seen["rotate_image"]
        th, tw = x.shape[:2]
        c, s_ = np.cos(np.radians(deg % 360)), np.sin(np.radians(deg % 360))
        yo, xo = np.mgrid[0:out_shape[0], 0:out_shape[1]].astype(np.float64)
        dx, dy = xo - (out_shape[1] - 1) / 2, yo - (out_shape[0] - 1) / 2
        xs = c * dx + s_ * dy + (tw - 1) / 2
        ys = -s_ * dx + c * dy + (th - 1) / 2
        margin = np.minimum(np.minimum(xs + 0.5, tw - 0.5 - xs),
                            np.minimum(ys + 0.5, th - 0.5 - ys))
        knife |= (np.abs(margin) < KNIFE)[..., None]
    return knife


@pytest.mark.parametrize("opts,stage", STAGE_CASES)
def test_stage_matches_jax(opts, stage, monkeypatch):
    """Each stage after the resample through the whole program: within 1 u8
    level on at most a 1e-4 share of values, except at knife-edge values
    (JAX-side value within KNIFE of a dither threshold, an unsharp threshold
    or the fill edge), which are counted and stay under 1e-3 of values."""
    img = image(240, 320, len(opts))
    tplan = tbuild_plan(TOptionsBag(opts), 320, 240)
    jplan = jbuild_plan(JOptionsBag(opts), 320, 240)
    got = tcompose.run_plan(img, tplan, device="cpu")
    ref = jcompose.run_plan(img, jplan)
    assert got.shape == ref.shape
    knife = _knife_edges(_jax_stage_inputs(img, jplan, monkeypatch), ref.shape)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff[~knife].max() <= 1
    assert (diff[~knife] > 0).mean() <= 1e-4
    assert knife.mean() <= 1e-3


@pytest.mark.parametrize("opts,stage", [
    ("w_100,fb_1", "face-blur"), ("w_100,h_100,c_1,fc_1", "face-crop"),
])
def test_face_stage_raises_naming_it(opts, stage, monkeypatch, tmp_path):
    """The face post-passes are ported: run_plan and the batcher run the
    plan's program (the face pass follows in the handler), a face
    detection that fails raises an error naming the stage (never an image
    with the faces left in), and ``check_ported`` still refuses, by name
    and before any device work, a stage on its list of unported ones."""
    from PIL import Image

    from flyimg_tpu_torch.appconfig import AppParameters
    from flyimg_tpu_torch.exceptions import ExecFailedException
    from flyimg_tpu_torch.service.handler import ImageHandler

    plan = tbuild_plan(TOptionsBag(opts), 320, 240)
    assert plan.face_blur or plan.face_crop
    assert tcompose.unported_stages(plan) == []
    src = image(240, 320, 0)
    out = tcompose.run_plan(src, plan, device="cpu")
    batcher = BatchController(device="cpu")
    try:
        np.testing.assert_array_equal(batcher.submit(src, plan).result(), out)
    finally:
        batcher.close()

    class Broken:
        def detect_faces(self, rgb):
            raise RuntimeError("detector down")

    path = tmp_path / "src.png"
    Image.fromarray(src).save(path)
    handler = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "u"),
                                          "tmp_dir": str(tmp_path / "t")}),
                           device="cpu", face_backend=Broken())
    with pytest.raises(ExecFailedException, match=f"{stage} failed"):
        handler.process_image(opts, str(path))

    monkeypatch.setattr(tcompose, "UNPORTED", (("face_blur", "face-blur"),
                                              ("face_crop", "face-crop")))
    with pytest.raises(NotPortedException, match=stage):
        tcompose.run_plan(src, plan, device="cpu")
    batcher = BatchController(device="cpu")
    try:
        with pytest.raises(NotPortedException, match=stage):
            batcher.submit(src, plan)
    finally:
        batcher.close()
    assert list(batcher.launch_log) == []


def test_out_of_memory_is_never_poison():
    assert classify_batch_error(torch.OutOfMemoryError("CUDA out of memory")) == OVERSIZE
    assert classify_batch_error(ValueError("bad member")) == POISON
