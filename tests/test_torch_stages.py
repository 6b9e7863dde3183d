"""The PyTorch package's program stages after the resample — extent pad,
grayscale, monochrome dither, rotate, unsharp/sharpen/blur — against the
JAX package's functions on the same numpy-seeded f32 inputs, then the
batcher's rotate grouping against the JAX batcher's policy.

On a CPU tensor each wrapper (K6 ``pixel_pass``, K4 ``rotate_sampled``, K5
``separable_filter``, K1's ``resample_banded_f32``) runs its plain version,
so these tests hold the plain versions; the kernels are held against the
plain versions on the card by chip_smoke.py and the ``cuda``-marked test.

Bounds, each stated where it is checked:
- extent_pad: exactly equal;
- to_grayscale: within 1e-5 (the luma's sum order);
- monochrome_dither: equal except where |luma - threshold| < 1e-3 (a knife-
  edge: an ulp there flips the pixel by 255 levels);
- rotate: within 1e-3 except where the source position lies within 1e-3 of
  the fill edge (the `inside` test switches sample <-> background);
- blur/unsharp/sharpen: within 1e-4 (the convolution's sum order), unsharp
  masks equal except where ||x - blur| - thr * 255| < 1e-3;
- K1's f32-store form: within 1e-3 (tests/test_torch_resample.py's f32
  bound), every row and column, those past out_true included;
- batched rotate vs the single-image path: the JAX test's bound, at most 1
  u8 level on under 1e-4 of values.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyimg_tpu.ops import color as jcolor
from flyimg_tpu.ops import compose as jcompose
from flyimg_tpu.ops import filters as jfilters
from flyimg_tpu.ops import pad as jpad
from flyimg_tpu.ops import resample as jresample
from flyimg_tpu.ops import rotate as jrotate
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu.spec.plan import rotated_bounds as jrotated_bounds
from flyimg_tpu_torch.ops import color as tcolor
from flyimg_tpu_torch.ops import compose as tcompose
from flyimg_tpu_torch.ops import filters as tfilters
from flyimg_tpu_torch.ops import pad as tpad
from flyimg_tpu_torch.ops import resample as tresample
from flyimg_tpu_torch.ops import rotate as trotate
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.spec.options import OptionsBag as TOptionsBag
from flyimg_tpu_torch.spec.plan import build_plan as tbuild_plan
from flyimg_tpu_torch.spec.plan import rotated_bounds

torch.set_num_threads(1)

GRAY_TOL = 1e-5
KNIFE = 1e-3
ROTATE_TOL = 1e-3
FILTER_TOL = 1e-4
F32_TOL = 1e-3


def smooth(n, h, w, seed):
    """[n, h, w, 3] f32 in [0, 255]: gradients and waves plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        for c in range(3):
            f = rng.uniform(5.0, 40.0, 2)
            out[i, ..., c] = 128 + 90 * np.sin(yy / f[0] + c + i) * np.cos(xx / f[1] - c)
    out += rng.normal(0, 6, out.shape).astype(np.float32)
    return np.clip(out, 0, 255).astype(np.float32)


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(yy * 3) % 256, (xx * 2) % 256, (xx + yy) % 256], -1)
    noise = rng.integers(0, 40, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def luma709(x):
    return (x.astype(np.float64) * np.array(jcolor.LUMA_WEIGHTS)).sum(-1)


def dither_knife(pre):
    """[..., h, w] bool: the dither's threshold lies within KNIFE of the
    luma of ``pre`` [..., h, w, 3] (the JAX side's dither input)."""
    luma = luma709(pre)
    h, w = luma.shape[-2:]
    tile = np.tile(jcolor._BAYER8, (h // 8 + 1, w // 8 + 1))[:h, :w]
    thr = (tile.astype(np.float64) + 0.5) * (255.0 / 64.0)
    return np.abs(luma - thr) < KNIFE


def inside_margin(true_hw, rot_hw, degrees, out_hw):
    """[out_h, out_w] f64 distance of each output pixel's source position
    inside (+) / outside (-) the valid region: rotate's fill edge."""
    th, tw = map(float, true_hw)
    theta = math.radians(degrees % 360.0)
    c, s = math.cos(theta), math.sin(theta)
    yo, xo = np.mgrid[0:out_hw[0], 0:out_hw[1]].astype(np.float64)
    dx = xo - (rot_hw[1] - 1.0) / 2.0
    dy = yo - (rot_hw[0] - 1.0) / 2.0
    xs = c * dx + s * dy + (tw - 1.0) / 2.0
    ys = -s * dx + c * dy + (th - 1.0) / 2.0
    return np.minimum(np.minimum(xs + 0.5, tw - 0.5 - xs),
                      np.minimum(ys + 0.5, th - 0.5 - ys))


# ---------------------------------------------------------------------------
# (a) each plain op against its JAX function on identical f32 inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("canvas,offset,bg", [
    ((400, 320), (50, 35), None),
    ((150, 100), (-20, -7), (12, 200, 77)),
    ((70, 50), (-10, -12), None),
    ((120, 90), (0, 0), (0, 0, 0)),
    ((60, 40), (200, 300), (51, 102, 153)),
    ((60, 40), (-500, -3), None),
])
def test_extent_pad_matches_jax(canvas, offset, bg):
    """Bound: exactly equal (a copy and a fill)."""
    x = smooth(2, 90, 120, 1)
    got = tpad.extent_pad(torch.from_numpy(x), canvas, offset, bg).numpy()
    for i in range(2):
        ref = np.asarray(jpad.extent_pad(jnp.asarray(x[i]), canvas, offset, bg))
        assert got[i].shape == ref.shape == (canvas[1], canvas[0], 3)
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("weights", ["709", "601"])
def test_to_grayscale_matches_jax(weights):
    """Bound: within GRAY_TOL (1e-5) — the luma's sum order."""
    w = jcolor.LUMA_WEIGHTS if weights == "709" else jcolor.LUMA_WEIGHTS_601
    assert tcolor.LUMA_WEIGHTS == jcolor.LUMA_WEIGHTS
    assert tcolor.LUMA_WEIGHTS_601 == jcolor.LUMA_WEIGHTS_601
    x = smooth(2, 70, 90, 2)
    got = tcolor.to_grayscale(torch.from_numpy(x), w).numpy()
    ref = np.asarray(jcolor.to_grayscale(jnp.asarray(x), w))
    np.testing.assert_allclose(got, ref, rtol=0, atol=GRAY_TOL)
    assert (got[..., 0] == got[..., 2]).all()


def test_monochrome_dither_matches_jax():
    """Bound: equal except where |luma - threshold| < KNIFE (1e-3); those
    values are counted and stay under 1e-3 of the pixels."""
    np.testing.assert_array_equal(tcolor._BAYER8, jcolor._BAYER8)
    x = smooth(3, 75, 93, 3)
    got = tcolor.monochrome_dither(torch.from_numpy(x)).numpy()
    for i in range(3):
        ref = np.asarray(jcolor.monochrome_dither(jnp.asarray(x[i])))
        knife = dither_knife(x[i])
        differ = (got[i] != ref).any(-1)
        assert not (differ & ~knife).any()
        assert knife.mean() < 1e-3
        assert set(np.unique(got[i])) <= {0.0, 255.0}


def test_pixel_pass_matches_the_jax_chain():
    """K6's wrapper on the CPU (its plain version) against extent_pad ->
    to_grayscale(601) -> monochrome_dither -> round/clip of the JAX package:
    equal except at dither knife-edges (|luma - thr| < KNIFE)."""
    x = smooth(2, 60, 80, 4)
    canvas, offset, bg = (100, 70), (-5, 9), (200, 30, 30)
    for dither in (False, True):
        got = tcolor.pixel_pass(torch.from_numpy(x), canvas, offset, bg,
                                tcolor.LUMA_WEIGHTS_601, dither, out_u8=True)
        assert got.dtype == torch.uint8
        for i in range(2):
            pre = jpad.extent_pad(jnp.asarray(x[i]), canvas, offset, bg)
            pre = jcolor.to_grayscale(pre, jcolor.LUMA_WEIGHTS_601)
            ref = jcolor.monochrome_dither(pre) if dither else pre
            ref = np.asarray(jnp.clip(jnp.round(ref), 0, 255)).astype(np.uint8)
            diff = np.abs(got[i].numpy().astype(int) - ref.astype(int))
            if dither:
                assert not ((diff > 0).any(-1) & ~dither_knife(np.asarray(pre))).any()
            else:
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


@pytest.mark.parametrize("degrees", [0, 90, 180, 270, 30, -45, 359.5])
def test_rotate_image_matches_jax(degrees):
    """Bound: quarter turns exactly equal; other angles within ROTATE_TOL
    (1e-3) except where the source position lies within KNIFE of the fill
    edge."""
    x = smooth(2, 41, 64, 5)
    bg = (20, 40, 250)
    got = trotate.rotate_image(torch.from_numpy(x), degrees, bg).numpy()
    for i in range(2):
        ref = np.asarray(jrotate.rotate_image(jnp.asarray(x[i]), degrees, bg))
        assert got[i].shape == ref.shape
        if degrees % 90 == 0:
            np.testing.assert_array_equal(got[i], ref)
            continue
        out_w, out_h = jrotated_bounds(64, 41, degrees)
        edge = np.abs(inside_margin((41, 64), (out_h, out_w), degrees,
                                    ref.shape[:2])) < KNIFE
        diff = np.abs(got[i] - ref).max(-1)
        assert diff[~edge].max() <= ROTATE_TOL


@pytest.mark.parametrize("degrees", [30, -45, 90, 359.5])
def test_rotate_image_dynamic_matches_jax(degrees):
    """A padded frame whose valid region differs per member: each member
    against the JAX dynamic rotate with its own true/rotated sizes. Bound:
    ROTATE_TOL off the fill edge (KNIFE)."""
    x = smooth(3, 96, 128, 6)
    valid = [(96, 128), (77, 101), (5, 9)]
    rows = [(h, w) + tuple(reversed(rotated_bounds(w, h, degrees))) for h, w in valid]
    true_hw = torch.tensor([r[:2] for r in rows], dtype=torch.float32)
    rot_hw = torch.tensor([r[2:] for r in rows], dtype=torch.float32)
    got = trotate.rotate_image_dynamic(torch.from_numpy(x), degrees, None,
                                       true_hw, rot_hw).numpy()
    for i, (th, tw, rh, rw) in enumerate(rows):
        ref = np.asarray(jrotate.rotate_image_dynamic(
            jnp.asarray(x[i]), degrees, None,
            jnp.array((th, tw), jnp.float32), jnp.array((rh, rw), jnp.float32)))
        assert got[i].shape == ref.shape
        edge = np.abs(inside_margin((th, tw), (rh, rw), degrees, ref.shape[:2])) < KNIFE
        diff = np.abs(got[i] - ref).max(-1)
        assert diff[~edge].max() <= ROTATE_TOL
        # the valid rotated content sits top-left; the rest is background
        assert (got[i][rh:] == 255.0).all() and (got[i][:, rw:] == 255.0).all()


@pytest.mark.parametrize("radius,sigma", [(0, 1.0), (0, 0.5), (0, 0.25), (1, 0.5),
                                          (2, 1.0), (5, 2.0)])
def test_gaussian_kernel_matches_jax(radius, sigma):
    """The host taps against the JAX package's traced ones: same count,
    within 1e-7 (exp's last ulp)."""
    got = tfilters.gaussian_kernel(radius, sigma)
    ref = np.asarray(jfilters._gaussian_kernel(radius, sigma))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 40, 56), (2, 23, 1), (1, 1, 30)])
@pytest.mark.parametrize("radius,sigma", [(0, 1.0), (2, 1.0), (0, 2.0)])
def test_gaussian_blur_matches_jax(shape, radius, sigma):
    """Radius 0 (support from sigma) and radius >= 1, a 1-pixel-wide and a
    1-pixel-tall image (narrower than the taps). Bound: FILTER_TOL (1e-4)."""
    x = smooth(*shape, 7)
    got = tfilters.gaussian_blur(torch.from_numpy(x), radius, sigma).numpy()
    ref = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), radius, sigma))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FILTER_TOL)


@pytest.mark.parametrize("radius,sigma,gain,thr", [
    (0, 0.25, 8.0, 0.065), (2, 1.0, 1.5, 0.02), (0, 1.0, 0.8, 0.0), (1, 0.5, 2.0, 0.1),
])
def test_unsharp_mask_matches_jax(radius, sigma, gain, thr):
    """Bound: FILTER_TOL (1e-4) wherever the threshold mask agrees; masks
    differ only where ||x - blur| - thr * 255| < KNIFE (counted)."""
    x = smooth(2, 50, 66, 8)
    got = tfilters.unsharp_mask(torch.from_numpy(x), radius, sigma, gain, thr).numpy()
    ref = np.asarray(jfilters.unsharp_mask(jnp.asarray(x), radius, sigma, gain, thr))
    blurred = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), radius, sigma))
    knife = np.abs(np.abs(x - blurred) - thr * 255.0) < KNIFE
    diff = np.abs(got - ref)
    assert diff[~knife].max() <= FILTER_TOL
    assert knife.mean() < 1e-3


@pytest.mark.parametrize("radius,sigma", [(2, 1.0), (0, 0.5)])
def test_sharpen_matches_jax(radius, sigma):
    """Unsharp with gain 1 and threshold 0 (no knife-edge). Bound:
    FILTER_TOL."""
    x = smooth(2, 31, 47, 9)
    got = tfilters.sharpen(torch.from_numpy(x), radius, sigma).numpy()
    ref = np.asarray(jfilters.sharpen(jnp.asarray(x), radius, sigma))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FILTER_TOL)


def test_filter_u8_store_rounds_once():
    """The u8 store of the filter is round-half-even then clip of its f32
    result (the program's single rounding)."""
    x = smooth(1, 20, 30, 10) * 1.2 - 20.0
    f32 = tfilters.unsharp_mask(torch.from_numpy(x), 2, 1.0, 1.5, 0.0)
    u8 = tfilters.unsharp_mask(torch.from_numpy(x), 2, 1.0, 1.5, 0.0, out_u8=True)
    np.testing.assert_array_equal(
        u8.numpy(), np.clip(np.round(f32.numpy()), 0, 255).astype(np.uint8))


def test_resample_banded_f32_matches_jax_every_row():
    """K1's f32-store form on the CPU (its plain version) on a fit-path
    bucket: the whole output, rows past out_true included, within F32_TOL
    of the JAX banded resample, and exactly the plain f32 resample."""
    img = image(120, 160, 11)
    bucket = np.zeros((2, 128, 256, 3), np.uint8)
    bucket[0, :120, :160] = img
    bucket[1, :100, :256] = image(100, 256, 12)
    geo = [((120, 160), (0.0, 120), (0.0, 160), (60, 80)),
           ((100, 256), (0.0, 100), (0.0, 256), (25, 64))]
    cols = [np.array([g[k] for g in geo], np.float32) for k in range(4)]
    in_true, span_y, span_x, out_true = (torch.from_numpy(c) for c in cols)
    out_hw, taps = (64, 128), (16, 16)
    got = tresample.resample_banded_f32(torch.from_numpy(bucket), out_hw, span_y,
                                        span_x, out_true, in_true, taps)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 128, 3)
    plain = tresample.resample_image_banded(torch.from_numpy(bucket).float(), out_hw,
                                            span_y, span_x, out_true, in_true, taps)
    assert torch.equal(got, plain)
    for i in range(2):
        ref = np.asarray(jresample.resample_image_banded(
            jnp.asarray(bucket[i], jnp.float32), out_hw,
            *(jnp.asarray(c[i]) for c in (cols[1], cols[2], cols[3], cols[0])),
            taps))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=0, atol=F32_TOL)


# ---------------------------------------------------------------------------
# (c) the batcher's rotate grouping (tests/test_batcher.py's rotate tests)
# ---------------------------------------------------------------------------


def _plans(opts, w, h):
    return tbuild_plan(TOptionsBag(opts), w, h), jbuild_plan(JOptionsBag(opts), w, h)


def assert_rotate_parity(out, single):
    """tests/test_batcher.py's bound: at most 1 u8 level, on under 1e-4 of
    values."""
    assert out.shape == single.shape
    diff = np.abs(out.astype(np.int16) - single.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 1e-4


def _batched(opts, sizes, seed):
    ctl = BatchController(device="cpu", max_batch=len(sizes),
                          deadline_ms=60_000.0, lone_flush=False)
    try:
        cases = []
        for i, (w, h) in enumerate(sizes):
            img = image(h, w, seed + i)
            tplan, jplan = _plans(opts, w, h)
            cases.append((img, tplan, jplan, ctl.submit(img, tplan)))
        outs = [f.result(timeout=120) for *_, f in cases]
    finally:
        ctl.close()
    return list(ctl.launch_log), [(c[0], c[1], c[2], o) for c, o in zip(cases, outs)]


def test_mixed_size_rotate_shares_one_batch():
    """Two different-sized r_45 requests land in one dynamic group (one
    launch) and match the single-image path, the port's and the JAX
    package's, within the rotate parity bound."""
    log, cases = _batched("r_45", [(300, 200), (260, 180)], 20)
    assert log == [("transform", 2, 2)]
    for img, tplan, jplan, out in cases:
        assert_rotate_parity(out, tcompose.run_plan(img, tplan, device="cpu"))
        assert_rotate_parity(out, jcompose.run_plan(img, jplan))


def test_rotate_90_multiples_batch_match_single():
    """Quarter turns through the dynamic batch (bilinear at integer
    positions) equal the single path's exact flips."""
    for angle in (90, 180, 270):
        log, cases = _batched(f"r_{angle}", [(250, 170)], angle)
        assert log == [("transform", 1, 1)]
        img, tplan, jplan, out = cases[0]
        np.testing.assert_array_equal(out, tcompose.run_plan(img, tplan, device="cpu"))
        np.testing.assert_array_equal(out, jcompose.run_plan(img, jplan))


def test_resize_plus_rotate_mixed_sizes_share_batch():
    """r_-45,w_400,h_400 across mixed sources: fit-resample buckets plus the
    dynamic rotate make one group."""
    log, cases = _batched("r_-45,w_400,h_400", [(640, 480), (600, 400)], 30)
    assert log == [("transform", 2, 2)]
    for img, tplan, jplan, out in cases:
        assert_rotate_parity(out, tcompose.run_plan(img, tplan, device="cpu"))
        assert_rotate_parity(out, jcompose.run_plan(img, jplan))


def test_rotate_with_conv_postop_stays_exact():
    """A filter after the rotate opts out of the dynamic rotate: the exact
    frame, pixel-identical to the single path, and to the JAX package's
    within 1 level."""
    log, cases = _batched("r_45,blr_2", [(300, 200)], 77)
    img, tplan, jplan, out = cases[0]
    np.testing.assert_array_equal(out, tcompose.run_plan(img, tplan, device="cpu"))
    assert_rotate_parity(out, jcompose.run_plan(img, jplan))


def test_rotate_grouping_keys():
    """The JAX grouping policy: dynamic iff rotate without pad or filter;
    the dynamic flag joins the key; geometry rows carry rot_hw."""
    from flyimg_tpu_torch.runtime.batcher import transform_group

    def group(opts, w=300, h=200):
        return transform_group(tbuild_plan(TOptionsBag(opts), w, h), (h, w))

    g, final, sliced = group("r_45")
    assert g.rotate_dynamic and sliced and g.in_shape == (256, 384)
    assert final == tuple(reversed(rotated_bounds(300, 200, 45)))
    assert g.key[5] is True
    g, _, sliced = group("r_45,blr_2")
    assert not g.rotate_dynamic and g.in_shape == (200, 300) and not sliced
    g, _, _ = group("w_200,h_150,ett_400x300,r_45")
    assert not g.rotate_dynamic and g.resample_out == (133, 200)
    g, _, sliced = group("w_150,r_30")
    assert g.rotate_dynamic and sliced and g.resample_out == (128, 192)
    g, _, sliced = group("sh_2x1")
    assert not g.rotate_dynamic and sliced and g.resample_out is None


@pytest.mark.parametrize("opts", ["r_-15,bg_%23336699,blr_0x2", "sh_2x1",
                                  "w_300,h_250,ett_400x320,bg_%23333333,clsp_Gray"])
def test_staged_entry_is_the_batchers_program(opts):
    """entry.staged_entry (the staged batches chip_smoke.py and
    profile_entry time) builds the batcher's program for its sources: each
    member, sliced to its final size, equals run_plan on that member."""
    from flyimg_tpu_torch.entry import STAGED_OPTIONS, staged_entry

    assert opts in STAGED_OPTIONS
    fn, args, group, plan, (fh, fw) = staged_entry(opts, batch=2, device="cpu",
                                                   seed=3, src_wh=(200, 120))
    out = fn(*args).numpy()
    for i in range(2):
        src = args[0][i, :120, :200].numpy()
        np.testing.assert_array_equal(
            out[i, :fh, :fw], tcompose.run_plan(src, plan, device="cpu"))


# ---------------------------------------------------------------------------
# (d) the wrappers' input checks, CPU launches, and the card
# ---------------------------------------------------------------------------


def test_pixel_pass_checks_its_inputs():
    x = torch.zeros((2, 8, 8, 3))
    with pytest.raises(ValueError):
        tcolor.pixel_pass(x.to(torch.uint8), None, (0, 0), None, None, True)
    with pytest.raises(ValueError):
        tcolor.pixel_pass(x[0], None, (0, 0), None, None, True)
    with pytest.raises(ValueError):
        tcolor.pixel_pass(x[..., :2].contiguous(), None, (0, 0), None, None, True)
    with pytest.raises(ValueError):
        tcolor.pixel_pass(x, None, (0, 0), None, (0.5, 0.5), False)
    with pytest.raises(ValueError):
        tcolor.pixel_pass(x, (0, 4), (0, 0), None, None, False)
    with pytest.raises(ValueError):
        tcolor.pixel_pass(x.to("meta"), None, (0, 0), None, None, True)


def test_rotate_checks_its_inputs():
    x = torch.zeros((2, 8, 8, 3))
    geom = torch.tensor([[8.0, 8.0, 11.0, 11.0]] * 2)
    with pytest.raises(ValueError):
        trotate.rotate_sampled(x.double(), 30, None, geom)
    with pytest.raises(ValueError):
        trotate.rotate_sampled(x, 30, None, geom[:1])
    with pytest.raises(ValueError):
        trotate.rotate_sampled(x, 30, None, geom.double())
    with pytest.raises(ValueError):
        trotate.rotate_sampled(x, 30, None, geom.to("meta"))
    with pytest.raises(ValueError):
        trotate.rotate_sampled(x[:, :0], 30, None, geom)


def test_separable_filter_checks_its_inputs():
    x = torch.zeros((2, 8, 8, 3))
    taps = tfilters.gaussian_kernel(1, 0.5)
    with pytest.raises(ValueError):
        tfilters.separable_filter(x.to(torch.uint8), taps)
    with pytest.raises(ValueError):
        tfilters.separable_filter(x, np.ones(4, np.float32) / 4)
    with pytest.raises(ValueError):
        tfilters.separable_filter(x, np.ones((3, 3), np.float32))
    with pytest.raises(ValueError):
        tfilters.separable_filter(x, taps, mode=7)
    with pytest.raises(ValueError):
        tfilters.separable_filter(x[:, :, :0], taps)


def test_resample_banded_f32_checks_its_inputs():
    img = torch.zeros((2, 16, 16, 3), dtype=torch.uint8)
    geo = [torch.ones((2, 2)) for _ in range(4)]
    with pytest.raises(ValueError):
        tresample.resample_banded_f32(img.float(), (8, 8), *geo, (8, 8))
    with pytest.raises(ValueError):
        tresample.resample_banded_f32(img, (8, 8), torch.ones((3, 2)), *geo[1:], (8, 8))
    with pytest.raises(ValueError):
        tresample.resample_banded_f32(img, (8, 8), *geo, (8, 8), method="sinc9")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    wrappers = (tcolor.pixel_pass, trotate.rotate_sampled, tfilters.separable_filter,
                tresample.resample_banded_f32)
    before = [f.launches for f in wrappers]
    x = torch.from_numpy(smooth(1, 16, 16, 13))
    tcolor.pixel_pass(x, (20, 20), (2, 2), None, tcolor.LUMA_WEIGHTS, True)
    trotate.rotate_image(x, 30)
    tfilters.gaussian_blur(x, 0, 1.0, out_u8=True)
    geo = [torch.tensor([v]) for v in ([0.0, 16.0], [0.0, 16.0], [8.0, 8.0],
                                        [16.0, 16.0])]
    tresample.resample_banded_f32(x.to(torch.uint8), (8, 8), *geo, (8, 8))
    assert [f.launches for f in wrappers] == before


@pytest.mark.cuda
def test_k4_k5_k6_k1f32_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    x = torch.from_numpy(smooth(2, 90, 120, 14)).to(dev)
    got = tcolor.pixel_pass(x, (150, 100), (-20, 7), None, tcolor.LUMA_WEIGHTS, False)
    ref = tcolor.pixel_pass_plain(x, (150, 100), (-20, 7), None, tcolor.LUMA_WEIGHTS, False)
    assert torch.equal(got, ref)
    geom = torch.tensor([[90.0, 120.0] + list(reversed(rotated_bounds(120, 90, 30)))] * 2,
                        device=dev)
    got = trotate.rotate_sampled(x, 30, None, geom)
    ref = trotate.rotate_plain(x, 30, None, geom)
    margin = torch.from_numpy(inside_margin((90, 120), tuple(geom[0, 2:].tolist()), 30,
                                            got.shape[1:3])).to(dev)
    assert float((got - ref).abs().max(-1).values[margin.abs() >= KNIFE].max()) <= ROTATE_TOL
    taps = tfilters.gaussian_kernel(2, 1.0)
    got = tfilters.separable_filter(x, taps)
    assert float((got - tfilters.separable_conv_plain(x, taps)).abs().max()) <= FILTER_TOL
    img = torch.from_numpy(image(120, 160, 15)).to(dev)[None]
    rows = [torch.tensor([v], device=dev) for v in
            ([0.0, 120.0], [0.0, 160.0], [64.0, 80.0], [120.0, 160.0])]
    got = tresample.resample_banded_f32(img, (64, 96), *rows, (16, 16))
    ref = tresample.resample_image_banded(img.float(), (64, 96), *rows, (16, 16))
    assert float((got - ref).abs().max()) <= F32_TOL
