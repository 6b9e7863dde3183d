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
from hypothesis import assume, given, settings
from hypothesis import strategies as st

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


# ---------------------------------------------------------------------------
# K5's and K4's launch plans (csrc/separable.cu, csrc/rotate.cu): pure host
# arithmetic, held here so that the kernels' shapes are checked without a card


def _old_k5_limit(k):
    """The shared memory of K5's horizontal pass before the 2-D tile form:
    the wrapper refused a tap count past it."""
    return 4 * (((k + 3) & ~3) + (256 + k - 1) * 3) > tfilters.K5_SMEM_LIMIT


@pytest.mark.parametrize("k", [1, 3, 5, 13, 61, 123, 125, 127, 129, 1001, 14335])
def test_k5_plan_fits_every_accepted_shape_on_the_card(k):
    for halo in sorted({0, k // 4, k // 2}):
        for w in (1, 7, 64, 2134):
            for out_u8 in (False, True):
                plan = tfilters.k5_plan(32, 97, w, k, halo, out_u8)
                assert plan.smem_bytes <= tfilters.K5_SMEM_LIMIT
                if plan.form == "tile":
                    th, tw = plan.tile_h, plan.tile_w
                    assert th in (8, 16, 32) and tw % 8 == 0 and th * tw <= 2048
                    assert plan.smem_bytes == tfilters.k5_smem_bytes(k, th, tw, out_u8)
                else:
                    assert plan.form == "two_pass" and plan.tile_h == plan.tile_w == 0


def test_k5_plan_takes_the_tile_form_up_to_its_switch():
    """Every tap count whose tile window leaves two blocks an SM (the
    staged programs' 3, 5 and 13 among them) takes the 2-D tile form at
    K5_TILE, and every count past it the two-pass form: blr_0x10's 61 too,
    where the tile form read slower on the card."""
    for out_u8 in (False, True):
        forms = []
        for k in range(1, 400, 2):
            plan = tfilters.k5_plan(32, 1540, 2134, k, 0, out_u8)
            smem = tfilters.k5_smem_bytes(k, *tfilters.K5_TILE, out_u8)
            if smem <= tfilters.K5_TILE_SMEM:
                assert (plan.form, plan.tile_h, plan.tile_w) == ("tile",) + tfilters.K5_TILE
                assert plan.smem_bytes == smem
            else:
                assert plan.form == "two_pass", k
            forms.append(plan.form)
        switch = 2 * forms.index("two_pass") - 1  # the last tile-form count
        assert set(forms[:forms.index("two_pass")]) == {"tile"}
        assert switch == 29 and 2 * (tfilters.K5_TILE_SMEM + 1024) <= 228 * 1024
    assert tfilters.k5_plan(32, 300, 400, 61, 0, False).form == "two_pass"


@pytest.mark.parametrize("args", [
    (1, 10, 10, 0, 0), (1, 10, 10, 4, 0), (1, 10, 10, 5, 3), (1, 10, 10, 5, -1),
    (0, 10, 10, 5, 0), (1, 0, 10, 5, 0), (1, 10, 0, 5, 0), (65536, 10, 10, 5, 0),
])
def test_k5_plan_raises_where_the_wrapper_raised(args):
    with pytest.raises(ValueError):
        tfilters.k5_plan(*args)


def test_k5_plan_refuses_tap_counts_the_two_pass_form_cannot_hold():
    last = max(k for k in range(1, 20000, 2) if not _old_k5_limit(k))
    assert tfilters.k5_plan(1, 8, 8, last, 0).form == "two_pass"
    with pytest.raises(ValueError):
        tfilters.k5_plan(1, 8, 8, last + 2, 0)


def _tile_extremes(v, inside, tile):
    """Per (member, tile row, tile column): min and max of ``v`` over the
    tile's inside pixels (a tile with none gives +inf, -inf)."""
    b, h, w = v.shape
    ph, pw = -h % tile, -w % tile
    v = torch.nn.functional.pad(v.double(), (0, pw, 0, ph))
    inside = torch.nn.functional.pad(inside, (0, pw, 0, ph))
    shape = (b, (h + ph) // tile, tile, (w + pw) // tile, tile)
    v, inside = v.reshape(shape), inside.reshape(shape)
    lo = torch.where(inside, v, math.inf).amin(dim=(2, 4))
    hi = torch.where(inside, v, -math.inf).amax(dim=(2, 4))
    return lo, hi


def _check_k4_footprints(h, w, degrees, valid):
    """Every tap rotate_plain reads for an output tile lies in k4_footprint's
    box of that tile, a skipped tile has no pixel inside, and the box fits
    k4_plan's shared memory."""
    out_w, out_h = rotated_bounds(w, h, degrees)
    plan = trotate.k4_plan(len(valid), (h, w), (out_h, out_w), degrees)
    rows = []
    for th, tw in valid:
        rw, rh = rotated_bounds(tw, th, degrees)
        rows.append([th, tw, rh, rw])
    geom = torch.tensor(rows, dtype=torch.float32)
    xs, ys = trotate.source_positions(geom, degrees, (out_h, out_w))
    inside, ya, yb, xa, xb = trotate.rotate_taps(xs, ys, geom)
    tile = trotate.K4_TILE
    x_lo, _ = _tile_extremes(xa, inside, tile)
    _, x_hi = _tile_extremes(xb, inside, tile)
    y_lo, _ = _tile_extremes(ya, inside, tile)
    _, y_hi = _tile_extremes(yb, inside, tile)
    any_inside = _tile_extremes(inside.double(), inside, tile)[1] > 0
    for m, row in enumerate(rows):
        for ty in range(x_lo.shape[1]):
            for tx in range(x_lo.shape[2]):
                skip, bx0, by0, bw, bh = trotate.k4_footprint(
                    plan, degrees, row, (out_h, out_w), ty, tx)
                if skip:
                    assert not any_inside[m, ty, tx], (m, ty, tx)
                    continue
                assert bh <= trotate.K4_MAX_BOX_ROWS
                assert bh * trotate.k4_box_pitch(bw) <= plan.box_cap
                if any_inside[m, ty, tx]:
                    assert bx0 <= x_lo[m, ty, tx] and x_hi[m, ty, tx] < bx0 + bw
                    assert by0 <= y_lo[m, ty, tx] and y_hi[m, ty, tx] < by0 + bh


@pytest.mark.parametrize("h,w,degrees", [
    (1, 1, 0.5), (1, 1, 45), (1, 37, -15), (300, 517, 44.9), (300, 517, 45),
    (97, 141, 359.5), (128, 160, 30), (64, 8192, 0.5), (2, 8192, 359.5),
    (200, 333, -359.9), (333, 200, 133.7), (45, 700, -200.1),
])
def test_k4_footprint_holds_every_tap_at_the_named_angles(h, w, degrees):
    _check_k4_footprints(h, w, degrees, [(h, w), (max(1, h * 2 // 3), max(1, w - 5)),
                                         (1, max(1, w // 3))])


@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_k4_footprint_holds_every_tap(data):
    """Hypothesis: angles in (-360, 360), frames 1 to 8192 wide, valid
    regions smaller than the frame."""
    degrees = data.draw(st.floats(-359.99, 359.99, allow_nan=False)
                        | st.sampled_from([0.5, 44.9, 45.0, 359.5, -15.0, 30.0]))
    w = data.draw(st.integers(1, 8192))
    h = data.draw(st.integers(1, 600))
    out_w, out_h = rotated_bounds(w, h, degrees)
    assume(out_w * out_h <= 1_500_000)
    valid = data.draw(st.lists(st.tuples(st.integers(1, h), st.integers(1, w)),
                               min_size=1, max_size=3))
    _check_k4_footprints(h, w, degrees, valid)


def test_k4_plan_box_holds_any_tile_and_refuses_what_the_kernel_cannot():
    for degrees in (0.5, 15.0, 44.9, 45.0, 90.5, 179.0, -15.0):
        plan = trotate.k4_plan(32, (1080, 1920), (2300, 2300), degrees)
        assert plan.box_w == plan.box_h <= trotate.K4_MAX_BOX_ROWS
        assert plan.smem_bytes <= trotate.K4_SMEM_LIMIT
    small = trotate.k4_plan(1, (3, 2), (4, 4), 45.0)
    assert (small.box_w, small.box_h) == (2, 3)
    for bad in ((0, (5, 5), (5, 5)), (65536, (5, 5), (5, 5)), (1, (1 << 22, 5), (5, 5))):
        with pytest.raises(ValueError):
            trotate.k4_plan(*bad, 10.0)
