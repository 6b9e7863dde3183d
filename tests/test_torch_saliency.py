"""What kernel K2 (flyimg_tpu_torch/csrc/saliency.cu) takes from the host,
held over its whole domain on the CPU.

K2 replaces divisions and comparisons of the plain version
(``batched_weighted_plain``) with tables, integer bounds and a skin
pre-test, and stays bit-exact only if each of them is exact:

- ``k2_quotients`` (which builds the saturation table) and K2's own
  division by 255 (a corrected reciprocal): ``k / 255`` equal to the plain
  version's IEEE division for all 511 sums (max + min) and 256
  differences (max - min, and the floored map levels the merge divides);
- ``k2_saturation_levels``: the floored saturation level of every
  (max, min) pair, which, with the luma window, equals the plain
  saturation map (of this package and of the JAX package) on every pixel;
- ``k2_thresholds``: the integer luma bounds equal the plain version's f32
  comparisons on every luma; the skin pre-test passes every colour of the
  RGB cube whose plain skin level is above 0;
- the fast skin level: a numpy model of it, with its rsqrt results 2 ulp
  off, stays far inside the margin that sends a pixel to the exact path;
- ``k2_plan``: the tiles cover every output pixel exactly once, in groups
  of four columns, within the shared memory the kernel checks.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to max
diff 0 on every colour of the cube and the edge shapes).
"""

import os
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyimg_tpu.models import smartcrop as js
from flyimg_tpu_torch.models import smartcrop as ts

torch.set_num_threads(1)


def _pair_pixels():
    """[6 * P, 3] u8: for every (max, min) pair with min <= max, its six
    extreme colours (the middle channel equal to max or to min, in every
    position); and the pair of each pixel. A colour's luma is monotone in
    its middle channel, so every colour of a pair has a luma between the
    least and the greatest of the pair's six."""
    mx, mn = np.nonzero(np.tri(256, dtype=bool))
    pix = []
    for dup, single in ((mx, mn), (mn, mx)):
        for pos in range(3):
            trio = [dup, dup, dup]
            trio[pos] = single
            pix.append(np.stack(trio, -1))
    return np.concatenate(pix).astype(np.uint8), np.tile(mx, 6), np.tile(mn, 6)


@pytest.mark.parametrize("what,n", [("sums", 511), ("differences", 256)])
def test_k2_quotients_equal_plain_division(what, n):
    k = torch.arange(n, dtype=torch.float32)
    ref = ts._div(k, 255.0).numpy()
    got = ts.k2_quotients()[:n]
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def _round_f32(x):
    """The f32 nearest the exact rational x (ties to even)."""
    c = np.float32(float(x))
    near = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(np.array(y).view(np.uint32)) & 1))


@pytest.mark.parametrize("what,n", [("sums", 511), ("differences", 256)])
def test_k2_corrected_reciprocal_equals_plain_division(what, n):
    """K2 divides by 255 as p = k * fl(1/255), then fma(fma(-p, 255, k),
    fl(1/255), p), each fused step rounded once: the plain version's
    quotient for every whole k it divides."""
    r = np.float32(1.0) / np.float32(255.0)
    ref = ts._div(torch.arange(n, dtype=torch.float32), 255.0).numpy()
    for k in range(n):
        kf = np.float32(k)
        p = _round_f32(Fraction(float(kf)) * Fraction(float(r)))
        e = _round_f32(-Fraction(float(p)) * 255 + Fraction(float(kf)))
        q = _round_f32(Fraction(float(e)) * Fraction(float(r)) + Fraction(float(p)))
        assert q == ref[k], k


@pytest.mark.parametrize("reference", ["torch", "jax"])
def test_k2_saturation_levels_equal_plain_map(reference):
    pix, mx, mn = _pair_pixels()
    img = pix.reshape(1, 6, -1, 3)
    h, w = img.shape[1:3]
    if reference == "torch":
        maps = ts._analyse_features_valid(
            torch.from_numpy(img), torch.tensor([[h, w]], dtype=torch.float32)
        ).numpy()[0]
    else:
        maps = np.asarray(js._analyse_features_valid(
            jnp.asarray(img[0]), jnp.asarray([float(h), float(w)])))
    sat_map = maps[..., 2].reshape(-1)
    r, g, b = (pix[:, c].astype(np.float32) for c in range(3))
    cie = np.floor(np.float32(0.2126) * r + np.float32(0.7152) * g
                   + np.float32(0.0722) * b)
    _skin_lo, sat_lo, sat_hi, _k = ts.k2_thresholds()
    window = (cie >= sat_lo) & (cie <= sat_hi)
    levels = ts.k2_saturation_levels()
    np.testing.assert_array_equal(np.where(window, levels[mx, mn], 0), sat_map)
    # every pair with a colour inside the window is held; the six extremes
    # of any other pair lie on one side of the window, so none of its
    # colours reaches the map
    inside = window.reshape(6, -1).any(axis=0)
    below = (cie < sat_lo).reshape(6, -1).all(axis=0)
    above = (cie > sat_hi).reshape(6, -1).all(axis=0)
    assert np.all(inside | below | above)
    assert inside.mean() > 0.97


def test_k2_table_bytes_layout():
    sat = np.frombuffer(ts.k2_table_bytes(), np.uint8)
    assert sat.size == ts.K2_TABLE_BYTES and ts.K2_TABLE_BYTES % 16 == 0
    levels = ts.k2_saturation_levels()
    mx, mn = np.nonzero(np.tri(256, dtype=bool))
    np.testing.assert_array_equal(sat[mx * (mx + 1) // 2 + mn], levels[mx, mn])
    assert np.all(levels[np.triu_indices(256, 1)] == 0)


def test_k2_thresholds_equal_plain_comparisons():
    cie = torch.arange(256, dtype=torch.float32)
    skin_lo, sat_lo, sat_hi, _k = ts.k2_thresholds()
    c = cie.numpy().astype(int)
    skin = ((cie >= ts.SKIN_BRIGHTNESS_MIN * 255.0)
            & (cie <= ts.SKIN_BRIGHTNESS_MAX * 255.0)).numpy()
    sat = ((cie >= ts.SATURATION_BRIGHTNESS_MIN * 255.0)
           & (cie <= ts.SATURATION_BRIGHTNESS_MAX * 255.0)).numpy()
    np.testing.assert_array_equal(skin, c >= skin_lo)
    np.testing.assert_array_equal(sat, (c >= sat_lo) & (c <= sat_hi))
    assert (skin_lo, sat_lo, sat_hi) == (51, 13, 229)
    # the constants they come from are the JAX package's
    assert ts.SKIN_BRIGHTNESS_MIN * 255.0 == js.SKIN_BRIGHTNESS_MIN * 255.0
    assert ts.SATURATION_BRIGHTNESS_MIN * 255.0 == js.SATURATION_BRIGHTNESS_MIN * 255.0
    assert ts.SATURATION_BRIGHTNESS_MAX * 255.0 == js.SATURATION_BRIGHTNESS_MAX * 255.0


def test_k2_skin_pretest_is_conservative_over_the_rgb_cube():
    """Every colour whose plain skin level is above 0 passes the luma bound
    and the integer pre-test, so skipping the exact path elsewhere changes
    nothing; and the pre-test rejects most colours."""
    assert ts.K2_SKIN_DOT_WEIGHTS == tuple(round(100 * c) for c in ts.SKIN_COLOR)
    wr, wg, wb = (np.uint32(v) for v in ts.K2_SKIN_DOT_WEIGHTS)
    skin_lo, _lo, _hi, k = ts.k2_thresholds()
    g, b = (v.reshape(-1).astype(np.uint32) for v in np.mgrid[0:256, 0:256])
    passed = skin = 0
    for r0 in range(0, 256, 32):
        r = np.repeat(np.arange(r0, r0 + 32, dtype=np.uint32), g.size)
        gg, bb = np.tile(g, 32), np.tile(b, 32)
        img = np.stack([r, gg, bb], -1).astype(np.uint8).reshape(1, 32 * 256, 256, 3)
        level = ts._analyse_features_valid(
            torch.from_numpy(img), torch.tensor([[32 * 256.0, 256.0]])
        ).numpy()[0, ..., 0].reshape(-1)
        cie = np.floor(np.float32(0.2126) * r.astype(np.float32)
                       + np.float32(0.7152) * gg.astype(np.float32)
                       + np.float32(0.0722) * bb.astype(np.float32))
        dot = wr * r + wg * gg + wb * bb
        pre = (cie >= skin_lo) & (dot * dot > np.uint32(k) * (r * r + gg * gg + bb * bb))
        assert not np.any((level > 0) & ~pre), f"pre-test misses skin at red {r0}..{r0 + 31}"
        passed += int(pre.sum())
        skin += int((level > 0).sum())
    assert skin > 0.05 * 2 ** 24
    assert passed < 0.15 * 2 ** 24


def test_k2_fast_skin_level_margin_covers_its_error():
    """A numpy model of K2's fast skin level (u = rgb rsqrt(|rgb|^2), the
    distance d2 rsqrt(d2), fused operations), with each rsqrt result moved
    2 ulp either way (the hardware's bound), stays far inside the margin
    around whole levels over every pre-test candidate of the RGB cube, and
    leaves few pixels to the exact path."""
    src = open(os.path.join(os.path.dirname(ts.__file__), "..", "csrc",
                            "saliency.cu")).read()
    m = re.search(r"SKIN_LEVEL_MARGIN = 1\.0f / ([0-9.]+)f;", src)
    assert m and 1.0 / float(m.group(1)) == ts.K2_SKIN_LEVEL_MARGIN
    f32 = np.float32
    skin_lo, _lo, _hi, k = ts.k2_thresholds()

    def fma(a, b, c):
        return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(f32)

    def rsqrt(x, ulps):
        y = (1.0 / np.sqrt(x.astype(np.float64))).astype(f32)
        for _ in range(abs(ulps)):
            y = np.nextafter(y, f32(np.inf) if ulps > 0 else f32(0))
        return y

    wr, wg, wb = (np.uint32(v) for v in ts.K2_SKIN_DOT_WEIGHTS)
    g, b = (v.reshape(-1).astype(np.uint32) for v in np.mgrid[0:256, 0:256])
    worst = 0.0
    uncertain = candidates = 0
    for r0 in range(256):
        r = np.full(g.size, r0, np.uint32)
        cie = np.floor(f32(0.2126) * r.astype(f32) + f32(0.7152) * g.astype(f32)
                       + f32(0.0722) * b.astype(f32))
        mag2 = r * r + g * g + b * b
        dot = wr * r + wg * g + wb * b
        pre = (cie >= skin_lo) & (dot * dot > np.uint32(k) * mag2)
        if not pre.any():
            continue
        rf, gf, bf = (x[pre].astype(f32) for x in (r, g, b))
        # the plain version's f32 arithmetic
        mag = np.sqrt(rf * rf + gf * gf + bf * bf)
        rd, gd, bd = rf / mag - f32(0.78), gf / mag - f32(0.57), bf / mag - f32(0.44)
        exact = (f32(1) - np.sqrt(rd * rd + gd * gd + bd * bd) - f32(0.8)) * f32(1275.0)
        inside = (exact > 0.5) & (exact < 256)
        for ulps in (-2, 0, 2):
            inv = rsqrt(mag2[pre].astype(f32), ulps)
            rd, gd, bd = (fma(c, inv, -f32(s)) for c, s in zip((rf, gf, bf), ts.SKIN_COLOR))
            d2 = fma(rd, rd, fma(gd, gd, bd * bd))
            fast = fma(d2 * rsqrt(d2, ulps), f32(-1275.0), f32(255.0))
            if inside.any():
                worst = max(worst, float(np.abs(fast - exact)[inside].max()))
            if ulps == 0:
                frac = fast - np.floor(fast)
                near = (frac <= ts.K2_SKIN_LEVEL_MARGIN) | (frac >= 1 - ts.K2_SKIN_LEVEL_MARGIN)
                uncertain += int((near & (fast >= 1 - ts.K2_SKIN_LEVEL_MARGIN)
                                  & (fast <= 255 + ts.K2_SKIN_LEVEL_MARGIN)).sum())
                candidates += int(pre.sum())
    assert worst < ts.K2_SKIN_LEVEL_MARGIN / 3
    assert uncertain < 0.02 * candidates


def _k2_covers(plan, b, h, w):
    """The tile walk of csrc/saliency.cu: every output pixel exactly once,
    each tile's stage and luma rows within the shared memory the kernel
    checks, every row staged at any 16-byte phase within its pitch."""
    assert plan.chunk_w % 4 == 0 and plan.chunk_w <= ts.K2_MAX_CHUNK_W
    assert plan.stage_pitch % 16 == 0
    assert plan.stage_pitch >= -(-(15 + 3 * (plan.chunk_w + 2)) // 16) * 16 + 16
    assert plan.luma_pitch >= plan.chunk_w // 4 + 2
    assert plan.smem_bytes == ts.K2_TABLE_BYTES + (plan.tile_h + 2) * (
        2 * plan.stage_pitch + 4 * plan.luma_pitch)
    assert plan.smem_bytes <= ts.K2_SMEM_CAP
    n_rt = -(-h // plan.tile_h)
    n_ct = -(-w // plan.chunk_w)
    assert (plan.n_row_tiles, plan.n_col_chunks) == (n_rt, n_ct)
    assert 1 <= plan.blocks <= b * n_rt * n_ct
    seen = np.zeros((b, h, w), np.int32)
    for t in range(b * n_rt * n_ct):
        m, rem = divmod(t, n_rt * n_ct)
        rt, ct = divmod(rem, n_ct)
        y0, x0 = rt * plan.tile_h, ct * plan.chunk_w
        rows, cols = min(plan.tile_h, h - y0), min(plan.chunk_w, w - x0)
        assert rows >= 1 and cols >= 1
        for g in range(-(-cols // 4)):
            n = min(4, cols - 4 * g)
            seen[m, y0:y0 + rows, x0 + 4 * g: x0 + 4 * g + n] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("shape", [
    (256, 250, 300),     # the flagship
    (16, 128, 160),      # a serving bucket
    (1, 4096, 4096),     # the RGB cube
    (2, 128, 8192),      # the widest bucket chip_smoke.py runs
    (1, 1, 1), (2, 1, 37), (2, 45, 1), (4, 33, 3), (2, 50, 301),
    (4, 64, 96), (3, 128, 160), (1, 128, 160), (5, 513, 517), (3, 97, 1025),
])
def test_k2_plan_covers_every_pixel_once(shape):
    _k2_covers(ts.k2_plan(*shape), *shape)


@pytest.mark.parametrize("seed", range(4))
def test_k2_plan_takes_every_score_bucket_shape(seed, monkeypatch):
    """Seeded images of many sizes go through score_bucket (on the CPU);
    every field it forms maps to a K2 launch that covers it."""
    rng = np.random.default_rng(700 + seed)
    seen = []
    plain = ts._batched_weighted

    def spy(images, in_true):
        seen.append(tuple(images.shape[:3]))
        return plain(images, in_true)

    monkeypatch.setattr(ts, "_batched_weighted", spy)
    items = []
    for _ in range(3):
        h, w = (int(v) for v in rng.integers(24, 420, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        items.append(ts.prepare_work(img, 100, 100))
    by_bucket = {}
    for item in items:
        by_bucket.setdefault(item.bucket, []).append(item)
    for bucket, group in by_bucket.items():
        ts.score_bucket(group, bucket, 8, torch.device("cpu"))
    assert seen
    for b, h, w in seen:
        _k2_covers(ts.k2_plan(b, h, w), b, h, w)


def test_k2_plan_refuses_empty_shapes():
    for shape in ((0, 8, 8), (1, 0, 8), (1, 8, 0)):
        with pytest.raises(ValueError):
            ts.k2_plan(*shape)


@pytest.mark.cuda
def test_k2_exact_on_card_at_edge_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for (b, h, w), valid in [((1, 1, 1), [[1, 1]]), ((4, 33, 3), [[33, 3], [17, 2], [1, 1], [0, 0]]),
                             ((2, 50, 301), [[50, 301], [49, 297]])]:
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
        vt = torch.tensor(valid, dtype=torch.float32, device=dev)
        got = ts._batched_weighted(img, vt)
        assert torch.equal(got, ts.batched_weighted_plain(img, vt))
