"""The PyTorch package's smart crop (flyimg_tpu_torch/models/smartcrop.py)
against the JAX package's, on the same numpy-seeded inputs.

Bounds:
- constants and ``importance_kernel``: exactly equal;
- ``_analyse_features_valid`` maps: exactly equal (they are floored
  integers), on padded and unpadded inputs;
- ``weighted_field``/``_batched_weighted``: within 1e-6 of the JAX
  function's own operation order. The jitted JAX ``_batched_weighted``
  strays from that order: XLA rewrites ``x / 255.0`` as
  ``x * (1 / 255.0)`` in the saturation map and fuses the luma sum, which
  moves a map by one level at a few pixels. The port keeps IEEE division
  and the written order, so against the jitted function the only
  differences allowed are single one-level steps of one map;
- ``_batched_scores``: within 1e-5 relative (max |a - b| / max |b|);
- the prescale thumbnail: byte-equal to Pillow's LANCZOS;
- ``find_best_crops_batched``: the same crop dicts on seeded images,
  where a top-two tie within 1e-5 may go either way (stated per case).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.models import smartcrop as js
from flyimg_tpu_torch.models import smartcrop as ts
from flyimg_tpu_torch.models.thumbnail import lanczos_resize

torch.set_num_threads(1)

CONSTANTS = [
    "DETAIL_WEIGHT", "EDGE_RADIUS", "EDGE_WEIGHT", "OUTSIDE_IMPORTANCE",
    "RULE_OF_THIRDS", "SATURATION_BIAS", "SATURATION_BRIGHTNESS_MAX",
    "SATURATION_BRIGHTNESS_MIN", "SATURATION_THRESHOLD", "SATURATION_WEIGHT",
    "SKIN_BIAS", "SKIN_BRIGHTNESS_MAX", "SKIN_BRIGHTNESS_MIN", "SKIN_COLOR",
    "SKIN_THRESHOLD", "SKIN_WEIGHT",
]


def smooth_image(h, w, seed):
    """Smooth seeded colour field with soft skin-toned blobs and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(3):
            fy, fx = rng.uniform(0.005, 0.05, 2)
            img[..., c] += 45 * np.sin(fy * yy + fx * xx + rng.uniform(0, 6))
    img += 128
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 40)
        m = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
        img = img * (1 - m) + np.array([200.0, 146.0, 112.0]) * m
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _batch(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    imgs[1] = smooth_image(64, 96, seed)
    imgs[3] = 0  # black: the skin map's mag < 1e-6 branch
    in_true = np.array([[64, 96], [50, 70], [64, 80], [33, 41]], np.float32)
    return imgs, in_true


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_match(name):
    assert getattr(ts, name) == getattr(js, name)


@pytest.mark.parametrize("crop", [(100.0, 100.0), (111.0, 111.0),
                                  (99.9, 90.0), (150.0, 150.0), (7.2, 3.3)])
def test_importance_kernel_exactly_equal(crop):
    np.testing.assert_array_equal(ts.importance_kernel(*crop),
                                  js.importance_kernel(*crop))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_maps_exactly_equal(seed):
    imgs, in_true = _batch(seed)
    got = ts._analyse_features_valid(torch.from_numpy(imgs),
                                     torch.from_numpy(in_true)).numpy()
    for i in range(len(imgs)):
        ref = np.asarray(js._analyse_features_valid(jnp.asarray(imgs[i]),
                                                    jnp.asarray(in_true[i])))
        np.testing.assert_array_equal(got[i], ref)
        # unpadded: the whole array is the valid region
        whole = ts.analyse_features(torch.from_numpy(imgs[i])).numpy()
        np.testing.assert_array_equal(whole, np.asarray(
            js._analyse_features_valid(jnp.asarray(imgs[i]),
                                       jnp.asarray([64.0, 96.0]))
        ))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_field_within_1e6(seed):
    imgs, in_true = _batch(seed)
    got = ts._batched_weighted(torch.from_numpy(imgs),
                               torch.from_numpy(in_true)).numpy()
    for i in range(len(imgs)):
        feats = js._analyse_features_valid(jnp.asarray(imgs[i]),
                                           jnp.asarray(in_true[i]))
        ref = np.array(js.weighted_field(feats))
        h, w = int(in_true[i, 0]), int(in_true[i, 1])
        ref[h:] = 0
        ref[:, w:] = 0
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=1e-6)
        # weighted_field on the same maps
        tw = ts.weighted_field(torch.from_numpy(np.array(feats))).numpy()
        np.testing.assert_allclose(tw, np.asarray(js.weighted_field(feats)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_weighted_against_jitted_jax(seed):
    imgs, in_true = _batch(seed)
    got = ts._batched_weighted(torch.from_numpy(imgs),
                               torch.from_numpy(in_true)).numpy()
    ref = np.asarray(js._batched_weighted(jnp.asarray(imgs),
                                          jnp.asarray(in_true)))
    diff = np.abs(got - ref)
    off = diff > 1e-6
    # what a one-level step of each map moves the field by at each pixel
    maps = ts._analyse_features_valid(
        torch.from_numpy(imgs), torch.from_numpy(in_true)
    ).numpy() / 255.0
    skin, detail, sat = maps[..., 0], maps[..., 1], maps[..., 2]
    steps = np.stack([
        (js.DETAIL_WEIGHT + skin * js.SKIN_WEIGHT + sat * js.SATURATION_WEIGHT),
        (detail + js.SKIN_BIAS) * js.SKIN_WEIGHT,
        (detail + js.SATURATION_BIAS) * js.SATURATION_WEIGHT,
    ], -1) / 255.0
    one_step = np.any(np.abs(diff[..., None] - steps) <= 1e-6, axis=-1)
    assert np.all(one_step[off])
    assert off.mean() < 0.05


@pytest.mark.parametrize("c", [1, 4])
def test_batched_scores_within_1e5_relative(c):
    rng = np.random.default_rng(c)
    field = rng.uniform(0, 0.3, (3, 72, 104)).astype(np.float32)
    kernels = rng.normal(0, 1, (3, 40, 48, 1, c)).astype(np.float32)
    tg, tt = ts._batched_scores(torch.from_numpy(field),
                                torch.from_numpy(kernels), 8)
    jg, jt = js._batched_scores(jnp.asarray(field), jnp.asarray(kernels),
                                stride=8)
    jg, jt = np.asarray(jg), np.asarray(jt)
    assert tg.shape == jg.shape
    assert np.abs(tg.numpy() - jg).max() / np.abs(jg).max() <= 1e-5
    assert np.abs(tt.numpy() - jt).max() / np.abs(jt).max() <= 1e-5


def test_shared_kernel_stack_scores_every_member():
    rng = np.random.default_rng(5)
    field = rng.uniform(0, 0.3, (4, 64, 64)).astype(np.float32)
    ker = rng.normal(0, 1, (1, 24, 24, 1, 2)).astype(np.float32)
    shared, _ = ts._batched_scores(torch.from_numpy(field), torch.from_numpy(ker), 8)
    full, _ = ts._batched_scores(torch.from_numpy(field),
                                 torch.from_numpy(np.repeat(ker, 4, axis=0)), 8)
    np.testing.assert_array_equal(shared.numpy(), full.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_host_thumbnail_byte_equal_to_pillow(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(40, 420, 2))
    img = smooth_image(h, w, seed) if seed % 2 else rng.integers(
        0, 256, (h, w, 3)).astype(np.uint8)
    for ow, oh in ((int(w * 0.444), int(h * 0.444)), (w // 3 + 1, h),
                   (w, h // 2 + 1), (w + 17, h + 5)):
        ref = np.asarray(Image.fromarray(img).resize((ow, oh), Image.LANCZOS))
        np.testing.assert_array_equal(lanczos_resize(img, ow, oh), ref)
        np.testing.assert_array_equal(ts._host_thumbnail(img, ow, oh),
                                      js._host_thumbnail(img, ow, oh))


def _crop_tied(item, crop_a, crop_b):
    """Whether two crops' scores tie within 1e-5 (either is acceptable)."""
    grids, totals, geoms, n_scales = ts.score_bucket(
        [item], item.bucket, item.step, torch.device("cpu"))
    scores = []
    for crop in (crop_a, crop_b):
        ps = item.prescale_size
        found = None
        for si, geom in enumerate(geoms[0]):
            if geom is None:
                continue
            cw, ch, mx, my = geom
            if int(cw / ps) != crop["width"]:
                continue
            y, x = int(np.ceil(crop["y"] * ps)), int(np.ceil(crop["x"] * ps))
            y, x = y - y % item.step, x - x % item.step
            inside = grids[0, y // item.step, x // item.step, si]
            box = grids[0, y // item.step, x // item.step, n_scales + si]
            found = (inside + ts.OUTSIDE_IMPORTANCE * (totals[0] - box)) / (cw * ch)
        scores.append(found)
    return None not in scores and abs(scores[0] - scores[1]) <= 1e-5 * max(
        abs(scores[0]), abs(scores[1]), 1e-12)


def test_crops_match_jax_on_seeded_images():
    sizes = [(250, 300), (300, 250), (333, 500), (128, 96), (480, 640),
             (250, 300), (77, 401)]
    items_t, items_j = [], []
    for seed, (h, w) in enumerate(sizes):
        img = smooth_image(h, w, 40 + seed)
        items_t.append(ts.prepare_work(img))
        items_j.append(js.prepare_work(img))
    got = ts.find_best_crops_batched(items_t, device="cpu")
    ref = js.find_best_crops_batched(items_j)
    ties = []
    for i, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            assert _crop_tied(items_t[i], a, b), (i, a, b)
            ties.append(i)
    assert len(ties) <= 1, f"more than one near-tie accepted: {ties}"


def test_single_image_paths_match():
    img = smooth_image(250, 300, 77)
    crop = ts.find_best_crop(img, device="cpu")
    assert crop == js.find_best_crop(img)
    np.testing.assert_array_equal(ts.smart_crop_image(img, device="cpu"),
                                  js.smart_crop_image(img))
    np.testing.assert_array_equal(ts.apply_crop(img, crop), js.apply_crop(img, crop))


@pytest.mark.cuda
def test_k2_k3_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    imgs, in_true = _batch(0)
    gi, gt = torch.from_numpy(imgs).to(dev), torch.from_numpy(in_true).to(dev)
    field = ts._batched_weighted(gi, gt)
    assert float((field - ts.batched_weighted_plain(gi, gt)).abs().max()) == 0.0
    ker = torch.randn((4, 24, 32, 1, 4), device=dev)
    g, t = ts._batched_scores(field, ker, 8)
    pg, pt = ts.batched_scores_plain(field, ker, 8)
    assert float((g - pg).abs().max() / pg.abs().max()) <= 1e-5
    assert float((t - pt).abs().max() / pt.abs().max()) <= 1e-5
