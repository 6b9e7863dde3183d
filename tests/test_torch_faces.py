"""The PyTorch package's face post-passes against the JAX package's, on the
CPU: pixelation (K7's plain version), the facefind skin masks (K8's plain
version) and boxes, Pillow's BILINEAR in numpy, the Haar copy, the backend
registry and the handler's face pass, on numpy-seeded inputs and seeded
images with skin-toned ellipses (so that boxes exist).

Bounds, each stated where it is checked:
- pixelate_regions / blur_faces: u8 equal (the block mean is the exact
  integer sum times f32(1/100), as XLA computes the JAX package's jitted
  mean);
- the skin probability: within 2e-6 (XLA's exp and torch's differ by a few
  ulps; every other step is the JAX package's to the bit);
- the morphology fed the JAX thresholded mask: equal to the JAX mask;
- full masks: equal except within 8 px of a pixel whose JAX probability
  lies within 1e-6 of the threshold (the knife-edge: an ulp of exp flips it,
  and four 5x5 passes spread it 8 px); boxes equal where no such pixel is;
- BILINEAR network inputs: byte-equal to Pillow's, every view kind;
- Haar boxes: equal (numpy both sides, the same resizes byte for byte);
- the handler: the same size and within 1 u8 level (the resample's bound).
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from flyimg_tpu.models import blazeface as jblazeface
from flyimg_tpu.models import facefind as jfacefind
from flyimg_tpu.models import faces as jfaces
from flyimg_tpu.models import haar as jhaar
from flyimg_tpu.ops import pixelate as jpixelate
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.entry import skin_ellipse_image
from flyimg_tpu_torch.exceptions import ExecFailedException
from flyimg_tpu_torch.models import blazeface as tblazeface
from flyimg_tpu_torch.models import facefind as tfacefind
from flyimg_tpu_torch.models import faces as tfaces
from flyimg_tpu_torch.models import haar as thaar
from flyimg_tpu_torch.models.thumbnail import bilinear_resize
from flyimg_tpu_torch.ops import pixelate as tpixelate
from flyimg_tpu_torch.service.handler import ImageHandler

torch.set_num_threads(1)

PROB_TOL = 2e-6
KNIFE = 1e-6
RADIUS = 8


def noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def jax_pixelate_u8(img, boxes, factor=jpixelate.PIXELATE_FACTOR):
    out = jpixelate.pixelate_regions(jnp.asarray(img, jnp.float32), jnp.asarray(boxes),
                                     factor)
    return np.asarray(jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8))


def test_block_mean_matches_jax_on_every_block_sum():
    """Every 10x10 block sum 0..25500 once: the mean is sum * f32(1/100)."""
    sums = np.arange(0, 25501)
    n = sums.size
    vals = np.repeat((sums // 100)[:, None], 100, axis=1).astype(np.float32)
    vals += np.arange(100)[None, :] < (sums % 100)[:, None]
    img = vals.reshape(n, 10, 10).transpose(1, 0, 2).reshape(10, 10 * n)[..., None]
    ref = np.asarray(jpixelate._block_pixelate(jnp.asarray(img), 10))
    got = tpixelate._block_pixelate(torch.from_numpy(np.ascontiguousarray(img)), 10)
    np.testing.assert_array_equal(got.numpy(), ref)


EDGE_SHAPES = [(240, 320), (237, 311), (7, 13), (1, 1), (10, 20)]


def edge_boxes(h, w):
    """Zero-area, overlapping, negative and past-the-edge boxes."""
    return np.array([[3, 5, 57, 41], [100, 100, 0, 10], [w - 20, h - 15, 100, 100],
                     [10, 10, 30, 30], [0, 0, w, h / 2], [2, 3, 0, 0],
                     [-5, -5, 12, 12]], np.float32)


@pytest.mark.parametrize("h,w,factor", [
    *[pytest.param(h, w, 10, id=f"{h}-{w}") for h, w in EDGE_SHAPES],
    *[pytest.param(h, w, f, id=f"{h}-{w}-factor{f}") for f in (1, 32)
      for h, w in EDGE_SHAPES + [(75, 97)]],
])
def test_pixelate_regions_matches_jax(h, w, factor):
    """Sides that are not multiples of the factor (10, and 1-pixel and
    32-pixel blocks); zero-area, overlapping, negative and past-the-edge
    boxes; u8 equal."""
    img = noise(h, w, h * 7 + w)
    boxes = edge_boxes(h, w)
    got = tpixelate.pixelate_regions_u8(torch.from_numpy(img), torch.from_numpy(boxes),
                                        factor)
    np.testing.assert_array_equal(got.numpy(), jax_pixelate_u8(img, boxes, factor))


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [10, 1, 32])
def test_k7_matches_plain_on_card(factor):
    """K7 against its plain version on the card, exact: the edge shapes and
    boxes, no boxes, 256 boxes, and an image off 16-byte alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(factor)
    cases = [(noise(h, w, h + w), edge_boxes(h, w)) for h, w in EDGE_SHAPES + [(1080, 1920)]]
    cases.append((noise(300, 400, 1), np.zeros((0, 4), np.float32)))
    cases.append((noise(300, 400, 2), np.concatenate(
        [rng.uniform(-50, 400, (256, 2)), rng.uniform(0, 60, (256, 2))], axis=1
    ).astype(np.float32)))
    for img, boxes in cases:
        src = torch.from_numpy(img).to(dev)
        dboxes = torch.from_numpy(boxes).to(dev)
        got = tpixelate.pixelate_regions_u8(src, dboxes, factor)
        ref = tpixelate.quantize_u8(tpixelate.pixelate_regions(src.float(), dboxes, factor))
        assert torch.equal(got, ref), (img.shape, boxes.shape)
    flat = torch.from_numpy(noise(1, 1 + 200 * 301, 3)[0]).to(dev)
    view = flat[1:].view(200, 301, 3)
    boxes = torch.tensor([[20, 30, 100, 80]], dtype=torch.float32, device=dev)
    ref = tpixelate.quantize_u8(tpixelate.pixelate_regions(view.float(), boxes, factor))
    assert torch.equal(tpixelate.pixelate_regions_u8(view, boxes, factor), ref)


def test_pixelate_launches_nothing_on_cpu():
    before = tpixelate.pixelate_regions_u8.launches
    tpixelate.pixelate_regions_u8(torch.zeros((4, 4, 3), dtype=torch.uint8),
                                  torch.zeros((1, 4)))
    assert tpixelate.pixelate_regions_u8.launches == before
    with pytest.raises(ValueError, match="u8"):
        tpixelate.pixelate_regions_u8(torch.zeros((4, 4, 3)), torch.zeros((1, 4)))


def ellipses(h, w, seed, faces=3):
    return skin_ellipse_image(np.random.default_rng(seed), h, w, faces)


@pytest.mark.parametrize("seed", [0, 1])
def test_blur_faces_matches_jax(seed):
    img = ellipses(300, 400, seed)
    boxes = jfacefind.detect_faces(img)
    assert boxes
    np.testing.assert_array_equal(
        tfacefind.blur_faces(img, boxes, device="cpu"), jfacefind.blur_faces(img, boxes))
    assert tfacefind.blur_faces(img, [], device="cpu") is img


def test_skin_probability_matches_jax():
    rng = np.random.default_rng(3)
    colours = rng.integers(0, 256, (400, 500, 3), dtype=np.uint8)
    skin = ellipses(200, 500, 4)
    for img in (colours, skin):
        ref = np.asarray(jfacefind._skin_probability(jnp.asarray(img)))
        got = tfacefind._skin_probability(torch.from_numpy(img)).numpy()
        assert np.abs(got - ref).max() <= PROB_TOL


def bucket(seed):
    """A padded bucket of 4: three skin-ellipse members with valid regions
    smaller than the bucket (sides not multiples of 32), then a copy of the
    last, as detect_faces_batched pads."""
    imgs = np.zeros((4, 256, 320, 3), np.uint8)
    valid = np.array([[256, 320], [237, 311], [201, 65], [201, 65]], np.float32)
    for i in range(3):
        h, w = valid[i].astype(int)
        imgs[i, :h, :w] = ellipses(h, w, seed + i, faces=1 + i)
    imgs[3] = imgs[2]
    return imgs, valid, np.full((4,), 0.35, np.float32)


def jax_prob_and_valid(imgs, valid):
    prob = np.asarray(jfacefind._skin_probability(jnp.asarray(imgs)))
    ys = np.arange(imgs.shape[1])[None, :, None]
    xs = np.arange(imgs.shape[2])[None, None, :]
    return prob, (ys < valid[:, 0, None, None]) & (xs < valid[:, 1, None, None])


def knife(prob, thresholds, valid):
    near = torch.from_numpy((np.abs(prob - thresholds[:, None, None]) < KNIFE) & valid)
    k = 2 * RADIUS + 1
    return (F.max_pool2d(near.float()[:, None], k, 1, RADIUS)[:, 0] > 0).numpy()


def test_morphology_fed_the_jax_mask_matches_jax():
    imgs, valid, thr = bucket(10)
    ref = np.asarray(jfacefind._batched_face_masks(
        jnp.asarray(imgs), jnp.asarray(valid), jnp.asarray(thr)))
    prob, vmask = jax_prob_and_valid(imgs, valid)
    got = tfacefind.clean_masks(torch.from_numpy(prob > thr[:, None, None]),
                                torch.from_numpy(vmask))
    assert ref.any()
    np.testing.assert_array_equal(got.numpy(), ref)
    # the unbatched form (SAME borders on the whole frame)
    mask = np.random.default_rng(11).uniform(size=(61, 47)) > 0.4
    np.testing.assert_array_equal(
        tfacefind._morph_clean(torch.from_numpy(mask)).numpy(),
        np.asarray(jfacefind._morph_clean(jnp.asarray(mask))))


@pytest.mark.parametrize("seed", [20, 30, 40])
def test_face_masks_match_jax_off_the_knife_edge(seed):
    imgs, valid, thr = bucket(seed)
    ref = np.asarray(jfacefind._batched_face_masks(
        jnp.asarray(imgs), jnp.asarray(valid), jnp.asarray(thr)))
    got = tfacefind._batched_face_masks(
        torch.from_numpy(imgs), torch.from_numpy(valid), torch.from_numpy(thr)).numpy()
    prob, vmask = jax_prob_and_valid(imgs, valid)
    edge = knife(prob, thr, vmask)
    assert not ((got != ref) & ~edge).any()
    assert edge.mean() < 1e-3


def _k8_valid_count(v, size):
    """Rows (or columns) i of [0, size) with f32(i) < v, as K8 counts them."""
    return 0 if not v > 0 else min(size, int(np.ceil(v)))


def _pack_words(bits):
    """[rows, 32 k] bool -> [rows, k] uint64 words, bit i of word j the
    pixel 32 j + i (K8's layout)."""
    rows, cols = bits.shape
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(rows, cols // 32, 32).astype(np.uint64) * weights).sum(axis=2)


def _unpack_words(words):
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)
    return bits.reshape(words.shape[0], -1).astype(bool)


def k8_tile_walk(mask, valid, plan):
    """A numpy emulation of K8's tile walk, driven by ``plan``: each tile's
    window of 32-pixel words (8 halo rows, ``halo_x`` halo columns), the
    thresholded mask ``& valid``, then erode, dilate, dilate, erode, each a
    5-tap row pass of shifted words (the neighbours' bits across word
    edges, the identity past the window) and a 5-tap column pass, the
    pixels outside the valid region holding the pass's identity before it
    and 0 after it; only each tile's core is kept."""
    full = np.uint64(0xFFFFFFFF)
    halo = tfacefind.K8_HALO
    b, h, w = mask.shape
    rows, cols = plan.tile_rows + 2 * halo, 32 * plan.words
    out = np.zeros_like(mask)
    written = np.zeros(mask.shape, np.int64)
    for bi in range(b):
        vh = _k8_valid_count(valid[bi, 0], h)
        vw = _k8_valid_count(valid[bi, 1], w)
        for ty in range(plan.tiles_y):
            for tx in range(plan.tiles_x):
                y0, x0 = ty * plan.tile_rows, tx * plan.tile_cols
                ys, xs = y0 - halo, x0 - plan.halo_x
                yy = ys + np.arange(rows)[:, None]
                xx = xs + np.arange(cols)[None, :]
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                vbits = (yy >= 0) & (yy < vh) & (xx >= 0) & (xx < vw)
                bits = np.zeros((rows, cols), bool)
                bits[inside] = mask[bi][np.broadcast_to(yy, bits.shape)[inside],
                                        np.broadcast_to(xx, bits.shape)[inside]]
                m, vw_words = _pack_words(bits & vbits), _pack_words(vbits)
                for dilate in (False, True, True, False):
                    ident = np.uint64(0) if dilate else full
                    t = m if dilate else m | (~vw_words & full)
                    edge = np.full((rows, 1), ident, np.uint64)
                    left = np.concatenate([edge, t[:, :-1]], axis=1)
                    right = np.concatenate([t[:, 1:], edge], axis=1)
                    taps = [t]
                    for s in (1, 2):
                        s = np.uint64(s)
                        taps.append(((t >> s) | (right << (np.uint64(32) - s))) & full)
                        taps.append(((t << s) | (left >> (np.uint64(32) - s))) & full)
                    op = np.bitwise_or if dilate else np.bitwise_and
                    rp = op.reduce(taps)
                    pad = np.full((2, rp.shape[1]), ident, np.uint64)
                    col = np.concatenate([pad, rp, pad])
                    m = op.reduce([col[d:d + rows] for d in range(5)]) & vw_words
                core = _unpack_words(m)
                r1 = min(plan.tile_rows, h - y0)
                c1 = min(plan.tile_cols, w - x0)
                out[bi, y0:y0 + r1, x0:x0 + c1] = core[halo:halo + r1,
                                                        plan.halo_x:plan.halo_x + c1]
                written[bi, y0:y0 + r1, x0:x0 + c1] += 1
    assert (written == 1).all()  # the cores tile the bucket, each pixel once
    return out


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    y:x."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _lanes_gt(a, b, width):
    """CUDA's __vcmpgtu4 (width 8) / __vcmpgtu2 (width 16): all ones in
    each lane where a > b, unsigned."""
    mask = (1 << width) - 1
    out = np.zeros_like(a)
    for i in range(0, 32, width):
        out |= np.where(((a >> i) & mask) > ((b >> i) & mask), np.uint32(mask << i), 0)
    return out


def k8_gate_bits(w0, w1, w2):
    """K8's gates of 4 pixels from their 12 bytes in three little-endian
    words, as the kernel forms them (byte permutes, byte- and 16-bit-lane
    compares): bit j for pixel j."""
    r4 = _byte_perm(_byte_perm(w0, w1, 0x0630), w2, 0x5210)
    g4 = _byte_perm(_byte_perm(w0, w1, 0x0741), w2, 0x6210)
    b4 = _byte_perm(_byte_perm(w0, w1, 0x0052), w2, 0x7410)
    u = np.uint32
    r_even, r_odd = r4 & u(0x00FF00FF), (r4 >> u(8)) & u(0x00FF00FF)
    g_even, g_odd = g4 & u(0x00FF00FF), (g4 >> u(8)) & u(0x00FF00FF)
    tint = ((_lanes_gt(r_even * u(10), g_even * u(9), 16) & u(0x00FF00FF))
            | ((_lanes_gt(r_odd * u(10), g_odd * u(9), 16) & u(0x00FF00FF)) << u(8)))
    diff = np.zeros_like(r4)
    for i in range(0, 32, 8):
        ri, gi = (r4 >> u(i)) & u(255), (g4 >> u(i)) & u(255)
        diff |= np.where(ri > gi, ri - gi, gi - ri) << u(i)
    gates = (_lanes_gt(r4, u(0x3C3C3C3C) + 0 * r4, 8) & _lanes_gt(r4, b4, 8)
             & _lanes_gt(diff, u(0x0A0A0A0A) + 0 * r4, 8) & tint)
    return (((gates & u(0x01010101)) * u(0x01020408)) >> u(24)) & u(15)


def test_k8_integer_gates_equal_the_float_gates_on_every_colour():
    """K8 tests the skin gates on bytes, 4 pixels at once; over every one of
    the 2^24 colours (packed 4 to a lane as an image row packs them) its
    bits equal the gates ``_skin_probability`` forms in f32 (r > 60,
    r > b, r > g * 0.9, |r - g| > 10)."""
    c = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], axis=1).astype(np.uint8)
    words = rgb.reshape(-1, 12).view("<u4")
    bits = k8_gate_bits(words[:, 0], words[:, 1], words[:, 2])
    got = ((bits[:, None] >> np.arange(4, dtype=np.uint32)) & 1).reshape(-1).astype(bool)
    f = torch.from_numpy(rgb).to(torch.float32)
    r, g, b = f[:, 0], f[:, 1], f[:, 2]
    want = ((r > 60.0) & (r > b) & (r > g * torch.tensor(np.float32(0.9)))
            & ((r - g).abs() > 10.0)).numpy()
    np.testing.assert_array_equal(got, want)


def blotch_images(b, h, w, seed):
    """[b, h, w, 3] u8 of two colours, skin (probability ~1) and blue
    (probability 0), in random 3x3 blotches with single-pixel noise: masks
    far from the threshold, with edges and holes for the morphology."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(size=(b, -(-h // 3), -(-w // 3))) < 0.55
    skin = np.repeat(np.repeat(coarse, 3, axis=1), 3, axis=2)[:, :h, :w]
    skin ^= rng.uniform(size=(b, h, w)) < 0.08
    return np.where(skin[..., None], np.uint8([200, 140, 110]),
                    np.uint8([50, 90, 160])).astype(np.uint8)


K8_WALK_CASES = [
    # random masks, the whole bucket valid
    (2, 64, 96, [[64, 96], [64, 96]]),
    # valid sizes from 1 to the whole bucket, sides off the tile
    (4, 33, 33, [[1, 33], [33, 1], [17, 20], [33, 33]]),
    (3, 75, 130, [[75, 130], [40, 77], [0, 130]]),
    # rows cut into tiles in x: valid sides straddling tile edges both ways
    (1, 40, 2100, [[37, 2050]]),
    (2, 70, 2200, [[70, 2200], [33, 1009]]),
    # a 1x1 valid region, in a bucket and alone
    (2, 20, 50, [[1, 1], [20, 50]]),
    (1, 1, 1, [[1, 1]]),
]


@pytest.mark.parametrize("case", range(len(K8_WALK_CASES)))
def test_k8_tile_walk_matches_jax(case):
    """K8's tile walk (numpy, from ``k8_plan``) fed the JAX thresholded
    mask equals the JAX package's ``_batched_face_masks``."""
    b, h, w, valid = K8_WALK_CASES[case]
    imgs = blotch_images(b, h, w, 60 + case)
    valid = np.array(valid, np.float32)
    thr = np.full((b,), 0.35, np.float32)
    ref = np.asarray(jfacefind._batched_face_masks(
        jnp.asarray(imgs), jnp.asarray(valid), jnp.asarray(thr)))
    prob, vmask = jax_prob_and_valid(imgs, valid)
    assert (np.abs(prob - 0.35) > 0.1).all()  # no knife-edge pixel
    plan = tfacefind.k8_plan(b, h, w)
    got = k8_tile_walk(prob > thr[:, None, None], valid, plan)
    np.testing.assert_array_equal(got, ref)
    if h * w > 100:
        assert ref.any() and not ref[vmask].all()


@pytest.mark.parametrize("shape", [(16, 480, 640), (1, 480, 640), (4, 480, 640), (8, 480, 640),
                                   (64, 480, 640), (1, 1, 1), (3, 75, 130), (1, 40, 2100),
                                   (2, 4000, 4500), (1, 33, 2048), (1, 33, 2049),
                                   (1, 8192, 2048)])
def test_k8_plan_covers_the_bucket(shape):
    """Cores tile every row and column once, a core and its halos fit the
    staged words, the rows of a tile are whole or cut with the 8-pixel
    halo, and the staged words fit 48 KB of shared memory."""
    b, h, w = shape
    plan = tfacefind.k8_plan(b, h, w)
    assert plan.blocks == b * plan.tiles_y * plan.tiles_x
    assert (plan.tiles_y - 1) * plan.tile_rows < h <= plan.tiles_y * plan.tile_rows
    assert (plan.tiles_x - 1) * plan.tile_cols < w <= plan.tiles_x * plan.tile_cols
    assert plan.tile_cols + 2 * plan.halo_x <= 32 * plan.words
    if plan.halo_x == 0:
        assert plan.tiles_x == 1 and 32 * plan.words >= w
    else:
        assert plan.halo_x == tfacefind.K8_HALO and plan.tiles_x > 1
    # the mask words and the row passes' words fit 48 KB; a thread of the
    # 1,024 a block takes a column in the morphology
    assert 2 * (plan.tile_rows + 2 * tfacefind.K8_HALO) * plan.words * 4 <= 48 * 1024
    assert plan.words <= 1024
    # the fewest rows whose blocks fit one an SM, else the most
    fits = [r for r in tfacefind.K8_TILE_ROWS
            if b * -(-h // min(r, h)) * plan.tiles_x <= 132]
    if h <= plan.tile_rows:
        assert plan.tile_rows == h
    elif fits:
        assert plan.tile_rows == min(fits[0], h)
    else:
        assert plan.tile_rows == min(tfacefind.K8_TILE_ROWS[-1],
                                     48 * 1024 // (8 * plan.words) - 16)


def test_detect_faces_batched_matches_jax():
    """Two buckets, one padded from 3 to 4; boxes equal for every member
    with no knife-edge pixel."""
    items = [ellipses(h, w, 50 + i, faces=1 + i % 3) for i, (h, w) in
             enumerate([(237, 311), (240, 320), (250, 300), (120, 90), (100, 80)])]
    ref = jfacefind.detect_faces_batched([jfacefind.prepare_face_work(x) for x in items])
    work = [tfacefind.prepare_face_work(x) for x in items]
    assert [w.bucket for w in work] == [jfacefind.prepare_face_work(x).bucket for x in items]
    got = tfacefind.detect_faces_batched(work, device="cpu")
    compared = 0
    for img, g, r in zip(items, got, ref):
        prob = np.asarray(jfacefind._skin_probability(jnp.asarray(img)))
        if (np.abs(prob - 0.35) < KNIFE).any():
            continue
        assert g == r
        compared += 1
    assert compared >= 4 and sum(map(len, ref)) >= 5


def test_detect_faces_and_crop_match_jax():
    img = ellipses(300, 420, 60, faces=3)
    boxes = tfacefind.detect_faces(img, device="cpu")
    assert boxes == jfacefind.detect_faces(img) and len(boxes) == 3
    for pos in (-1, 0, 2, 7):
        np.testing.assert_array_equal(tfacefind.crop_face(img, boxes, pos),
                                      jfacefind.crop_face(img, boxes, pos))
    assert tfacefind.crop_face(img, [], 0) is img


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (300, 7), (480, 640), (37, 53)])
def test_bilinear_resize_matches_pillow(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    for rgb in (True, False):
        img = rng.integers(0, 256, shape + ((3,) if rgb else ()), dtype=np.uint8)
        for ow, oh in ((128, 128), (1, 1), (shape[1], max(shape[0] // 3, 1)),
                       (shape[1] * 2 + 1, shape[0]), (64, 97)):
            ref = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
            np.testing.assert_array_equal(bilinear_resize(img, ow, oh), ref)


@pytest.mark.parametrize("h,w", [(100, 80), (300, 420), (481, 641)])
def test_view_inputs_byte_equal_to_pillow(h, w):
    """The full frame, the padded zoom-out canvas and (for large frames) the
    corner tiles: the network inputs equal the JAX package's, which resizes
    with Pillow."""
    img = ellipses(h, w, h + w)
    views = tblazeface._views(img)
    assert views == jblazeface._views(img)
    assert len(views) == (6 if min(h, w) >= 256 else 2)
    for view in views:
        np.testing.assert_array_equal(tblazeface._view_input(img, *view),
                                      jblazeface._view_input(img, *view))


def drawn_face(h, w, r, seed):
    """A gray frame with a drawn face (bright oval, dark eyes, brows and
    mouth, a bright nose ridge) that the frontal cascade detects."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w), 90, np.float32)
    cx, cy = w / 2, h / 2
    img[((xx - cx) / 0.8) ** 2 + (yy - cy) ** 2 < r * r] = 190
    for ex in (-0.35, 0.35):
        img[((xx - cx - ex * r) / 1.6) ** 2 + ((yy - cy + 0.25 * r) / 0.9) ** 2
            < (0.12 * r) ** 2] = 40
        img[(np.abs(xx - cx - ex * r) < 0.22 * r) & (np.abs(yy - cy + 0.45 * r) < 0.04 * r)] = 60
    img[(np.abs(xx - cx) < 0.3 * r) & (np.abs(yy - cy - 0.45 * r) < 0.05 * r)] = 60
    img[(np.abs(xx - cx) < 0.06 * r) & (yy > cy - 0.1 * r) & (yy < cy + 0.2 * r)] = 150
    img += np.random.default_rng(seed).normal(0, 3, img.shape)
    return np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, axis=2)


@pytest.mark.parametrize("h,w,r,neighbours", [(240, 320, 60, 2), (720, 960, 150, 2),
                                               (300, 260, 45, 0)])
def test_haar_copy_matches_jax(h, w, r, neighbours):
    """Boxes equal on a drawn face (the 720x960 frame takes the prescale to
    640 first)."""
    if not jhaar.available():
        pytest.skip("no haar cascade XML installed on this host")
    assert thaar.find_cascade() == jhaar.find_cascade()
    img = drawn_face(h, w, r, h + w)
    got = thaar.detect_faces(img, min_neighbors=neighbours)
    assert got == jhaar.detect_faces(img, min_neighbors=neighbours)
    assert got


def backend_names(monkeypatch, haar_ok, packaged):
    for mod in (jhaar, thaar):
        monkeypatch.setattr(mod, "available", lambda: haar_ok)
    if not packaged:
        monkeypatch.setattr(jfaces, "PACKAGED_BLAZEFACE", "/nonexistent")
        monkeypatch.setattr(tfaces, "PACKAGED_BLAZEFACE", "/nonexistent")
    names = []
    for name in ("blazeface", "haar", "facefind", "none", "auto"):
        if name == "haar" and jhaar.find_cascade() is None:
            continue
        if name == "blazeface" and not packaged:
            continue
        j = jfaces.make_face_backend(name)
        t = tfaces.make_face_backend(name, device="cpu")
        names.append((type(j).__name__, type(t).__name__))
    return names


@pytest.mark.parametrize("haar_ok,packaged", [(True, True), (False, True), (False, False)])
def test_make_face_backend_resolves_as_jax(monkeypatch, haar_ok, packaged):
    if haar_ok and jhaar.find_cascade() is None:
        pytest.skip("no haar cascade XML installed on this host")
    names = backend_names(monkeypatch, haar_ok, packaged)
    assert all(j == t for j, t in names), names
    assert names[-1][1] == ("HaarBackend" if haar_ok else
                            "BlazeFaceBackend" if packaged else "NullBackend")
    with pytest.raises(ValueError):
        tfaces.make_face_backend("bogus", device="cpu")


def test_blazeface_checkpoint_is_an_npz():
    with pytest.raises(ValueError, match="export_blazeface_npz"):
        tfaces.make_face_backend("blazeface", jfaces.PACKAGED_BLAZEFACE, device="cpu")
    with pytest.raises(RuntimeError, match="export_blazeface_npz"):
        tfaces.make_face_backend("blazeface", "/nonexistent.npz", device="cpu")


@pytest.fixture(scope="module")
def face_png(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_faces")
    path = root / "faces.png"
    Image.fromarray(ellipses(480, 640, 80, faces=3)).save(path)
    return root, str(path)


@pytest.mark.parametrize("backend,opts", [
    ("facefind", "w_400,fb_1"), ("blazeface", "w_400,fc_1,fcp_1"),
    ("facefind", "w_300,h_250,c_1,fb_1,fc_1,fcp_2"),
])
def test_handler_face_pass_matches_jax(face_png, backend, opts):
    from flyimg_tpu.appconfig import AppParameters as JAppParameters
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    root, src = face_png
    sub = root / f"{backend}-{opts}"

    def params(cls, side):
        return cls({"upload_dir": str(sub / side / "u"), "tmp_dir": str(sub / side / "t"),
                    "face_backend": backend})

    jp = params(JAppParameters, "jax")
    ref = JImageHandler(make_storage(jp), jp).process_image(opts + ",o_png", src)
    handler = ImageHandler(params(AppParameters, "torch"), device="cpu")
    got = handler.process_image(opts + ",o_png", src)
    a = np.asarray(Image.open(io.BytesIO(got.content)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(ref.content)).convert("RGB"))
    assert a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert "faces" in got.timings
    plain = handler.process_image(opts.split(",f")[0] + ",o_png", src)
    assert plain.content != got.content  # the face pass did something


def test_handler_face_detection_failure_fails_the_request(face_png, tmp_path):
    class Broken(tfaces.FacefindBackend):
        def detect_faces_batched(self, items):
            raise RuntimeError("detector down")

    _root, src = face_png
    handler = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "u"),
                                          "tmp_dir": str(tmp_path / "t")}),
                           device="cpu", face_backend=Broken("cpu"))
    with pytest.raises(ExecFailedException, match="face-blur failed: detector down"):
        handler.process_image("w_200,fb_1", src)
    stored = tmp_path / "u"
    assert not stored.exists() or not os.listdir(stored)


def test_face_entry_runs_on_cpu():
    """entry.face_entry's batch, cut to 2 views and 2 images: the shapes the
    card runs, boxes in every image, and a face found in every view."""
    from flyimg_tpu_torch.entry import FACE_HW, face_entry

    fn, args = face_entry("cpu", views=2, images=2)
    probs, boxes, masks = fn(*args)
    assert probs.shape == (2, 896) and boxes.shape == (2, 896, 4)
    assert masks.shape == (2,) + FACE_HW and masks.dtype == torch.bool
    assert all(tfacefind._boxes_from_mask(m) for m in masks.numpy())
    assert bool((probs.max(dim=1).values > 0.8).all())
