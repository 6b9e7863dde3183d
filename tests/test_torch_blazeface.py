"""The PyTorch package's BlazeFace forward against the JAX package's flax
model, on the CPU: the exported weights, a small-depth network (stem, three
BlazeBlocks, one at stride 2, and a head) with seeded random weights, the
full packaged network, the anchor decode and the batched detection path
(views, chunks of at most 64 views on the power-of-two ladder, NMS).

On a CPU tensor K9 (``conv5x5``), K10 (``pointwise``) and K10's head form
(``head_decode``) run their plain versions (``F.conv2d``, ``F.max_pool2d``),
so these tests hold the plain versions; the kernels are held against the
plain versions on the card by chip_smoke.py and the ``cuda``-marked test.

Bounds, each stated where it is checked:
- the weights: array by array equal to the orbax checkpoint;
- probabilities within 1e-5, raw offsets and logits within 1e-4 (the
  convolutions' sums run in another order than XLA's), decoded boxes
  within 1e-5;
- detection boxes: equal (no anchor lies near the 0.8 threshold or an IoU
  of 0.3 on these images, which the test checks).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyimg_tpu.models import blazeface as jbf
from flyimg_tpu.models.faces import PACKAGED_BLAZEFACE
from flyimg_tpu.runtime import batcher as jbatcher
from flyimg_tpu_torch.entry import skin_ellipse_image
from flyimg_tpu_torch.models import blazeface as tbf
from flyimg_tpu_torch.runtime import batcher as tbatcher

torch.set_num_threads(2)

PROB_TOL = 1e-5
RAW_TOL = 1e-4
BOX_TOL = 1e-5


@pytest.fixture(scope="module")
def jparams():
    return jbf.load_checkpoint(PACKAGED_BLAZEFACE)


@pytest.fixture(scope="module")
def model():
    return tbf.load_weights(device="cpu")


def test_npz_equals_the_orbax_checkpoint(jparams):
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    with np.load(tbf.PACKAGED_WEIGHTS) as z:
        assert len(z.files) == len(flat) == 58
        for path, value in flat:
            key = "/".join(p.key for p in path)
            np.testing.assert_array_equal(z[key], np.asarray(value))
            assert z[key].dtype == np.float32
    assert sum(np.asarray(v).size for _p, v in flat) == 106940


def test_params_from_flax_takes_nested_trees_and_refuses_others(jparams):
    nested = jax.tree.map(np.asarray, jparams)
    state = tbf.params_from_flax(nested)
    with np.load(tbf.PACKAGED_WEIGHTS) as z:
        flat = tbf.params_from_flax({k: z[k] for k in z.files})
    assert state.keys() == flat.keys()
    for key in state:
        assert torch.equal(state[key], flat[key])
    assert state["stem.kernel"].shape == (5, 5, 3, 24)
    assert state["blocks.2.dw_kernel"].shape == (5, 5, 1, 28)
    assert state["reg8.kernel"].shape == (1, 1, 96, 24)
    with pytest.raises(ValueError, match="missing"):
        tbf.params_from_flax({"params": {"Conv_0": {"kernel": np.zeros(1)}}})


def test_load_weights_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(ValueError, match="export_blazeface_npz.py"):
        tbf.load_weights(str(tmp_path), device="cpu")


@pytest.mark.parametrize("size,stride", [(128, 2), (64, 2), (32, 1), (17, 2), (9, 1)])
def test_same_pads_match_xla(size, stride):
    """SAME padding at stride 2 on an even size pads 1 before, 2 after."""
    x = np.random.default_rng(size).normal(size=(1, size, size, 2)).astype(np.float32)
    k = np.random.default_rng(size + 1).normal(size=(5, 5, 2, 3)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tbf.conv5x5(torch.from_numpy(x), torch.from_numpy(k), None, stride, relu=False)
    assert got.shape == ref.shape
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) <= RAW_TOL
    if size % 2 == 0 and stride == 2:
        assert tbf.same_pads(size, stride)[:2] == (1, 2)


class SmallNet(nn.Module):
    """Stem, three BlazeBlocks (the third at stride 2) and one anchor head,
    from the JAX package's own BlazeBlock."""

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(24, (5, 5), strides=(2, 2), padding="SAME")(x))
        x = jbf.BlazeBlock(24)(x)
        x = jbf.BlazeBlock(28)(x)
        x = jbf.BlazeBlock(32, stride=2)(x)
        cls = nn.Conv(2, (1, 1))(x)
        reg = nn.Conv(8, (1, 1))(x)
        return cls.reshape(x.shape[0], -1), reg.reshape(x.shape[0], -1, 4)


def test_small_network_matches_flax():
    images = np.random.default_rng(7).uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    params = SmallNet().init(jax.random.PRNGKey(7), jnp.asarray(images))
    # nonzero biases, so every bias path is compared
    params = jax.tree.map(
        lambda a: a + 0.05 * np.random.default_rng(a.size).normal(size=a.shape).astype(np.float32),
        params)
    cls_j, raw_j = SmallNet().apply(params, jnp.asarray(images))
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), params["params"])
    x = tbf.conv5x5(torch.from_numpy(images), p["Conv_0"]["kernel"], p["Conv_0"]["bias"],
                    2, relu=True)
    for i, (c, f, s) in enumerate([(24, 24, 1), (24, 28, 1), (28, 32, 2)]):
        block = tbf.BlazeBlock(c, f, s)
        q = p[f"BlazeBlock_{i}"]
        block.dw_kernel.copy_(q["Conv_0"]["kernel"])
        block.pw.kernel.copy_(q["Conv_1"]["kernel"])
        block.pw.bias.copy_(q["Conv_1"]["bias"])
        x = block(x)
    cls_t, raw_t = tbf.head_plain(x, p["Conv_1"]["kernel"], p["Conv_1"]["bias"],
                                  p["Conv_2"]["kernel"], p["Conv_2"]["bias"])
    probs = torch.sigmoid(cls_t).numpy()
    assert np.abs(probs - np.asarray(jax.nn.sigmoid(cls_j))).max() <= PROB_TOL
    assert np.abs(raw_t.numpy() - np.asarray(raw_j)).max() <= RAW_TOL
    assert raw_t.shape == (3, 16 * 16 * 2, 4)


def test_anchors_and_decode_match_jax():
    np.testing.assert_array_equal(tbf.anchor_centers(), jbf.anchor_centers())
    raw = np.random.default_rng(9).normal(0, 8, (2, tbf.NUM_ANCHORS, 4)).astype(np.float32)
    ref = np.asarray(jbf.decode_boxes(jnp.asarray(raw)))
    got = tbf.decode_boxes(torch.from_numpy(raw), torch.from_numpy(tbf.anchor_centers()))
    assert np.abs(got.numpy() - ref).max() <= BOX_TOL


def views(n, seed):
    rng = np.random.default_rng(seed)
    u8 = np.stack([skin_ellipse_image(rng, 128, 128, 1) for _ in range(n)])
    return u8.astype(np.float32) / 127.5 - 1.0


@pytest.mark.parametrize("n", [1, 3])
def test_full_network_matches_flax(jparams, model, n):
    """The packaged network at full width: logits and raw offsets against
    ``BlazeFace().apply``, then the forward (sigmoid, decode) against the
    jitted ``_forward``."""
    x = views(n, 11 + n)
    scores_j, raw_j = jbf.BlazeFace().apply(jparams, jnp.asarray(x))
    scores_t, raw_t = model.forward_plain(torch.from_numpy(x))
    assert scores_t.shape == (n, 896) and raw_t.shape == (n, 896, 4)
    assert np.abs(raw_t.numpy() - np.asarray(raw_j)).max() <= RAW_TOL
    assert np.abs(scores_t.numpy() - np.asarray(scores_j)).max() <= RAW_TOL
    probs_j, boxes_j = jbf._forward(jparams, jnp.asarray(x))
    probs_t, boxes_t = tbf._forward(model, torch.from_numpy(x))
    assert np.abs(probs_t.numpy() - np.asarray(probs_j)).max() <= PROB_TOL
    assert np.abs(boxes_t.numpy() - np.asarray(boxes_j)).max() <= RAW_TOL
    assert float(probs_t.max()) > 0.8  # the ellipses are found


def test_forward_launches_nothing_on_cpu(model):
    counters = (tbf.conv5x5, tbf.pointwise, tbf.head_decode)
    before = [f.launches for f in counters]
    tbf._forward(model, torch.from_numpy(views(1, 3)))
    assert [f.launches for f in counters] == before


def test_detection_chunks_on_the_runtime_ladder(monkeypatch, model):
    """12 large images carry 72 views: two forwards, of 64 and 8 views."""
    assert tbf.MAX_BATCH_BUCKET == jbatcher.MAX_BATCH_BUCKET == 64
    for n in (1, 3, 5, 64, 65):
        assert tbatcher._round_batch(n) == jbatcher._round_batch(n)
    seen = []
    real = tbf._forward

    def spy(m, images):
        seen.append(images.shape[0])
        return real(m, images)

    monkeypatch.setattr(tbf, "_forward", spy)
    rng = np.random.default_rng(4)
    imgs = [skin_ellipse_image(rng, 256, 320, 2) for _ in range(12)]
    out = tbf.detect_faces_batch(model, imgs, score_threshold=0.8)
    assert seen == [64, 8] and len(out) == 12


def test_detect_faces_batch_matches_jax(jparams, model):
    """Small (2 views) and large (6 views) images in one call, at the
    serving threshold 0.8: the same boxes as the JAX package, on images
    where no anchor probability lies within 1e-4 of the threshold."""
    rng = np.random.default_rng(5)
    imgs = [skin_ellipse_image(rng, h, w, k) for h, w, k in
            ((120, 160, 1), (300, 400, 2), (480, 640, 3), (200, 150, 1), (256, 256, 2))]
    ref = jbf.detect_faces_batch(jparams, imgs, score_threshold=0.8)
    got = tbf.detect_faces_batch(model, imgs, score_threshold=0.8)
    flat = np.concatenate([tbf._view_input(img, *v)[None] for img in imgs
                           for v in tbf._views(img)])
    probs, _ = tbf._forward(model, torch.from_numpy(flat))
    assert not (np.abs(probs.numpy() - 0.8) < 1e-4).any()
    assert got == ref
    assert sum(map(len, got)) >= 4
    assert tbf.detect_faces(model, imgs[2], score_threshold=0.8) == got[2]


def block_layers():
    """(h, w, C_in, C_out, C_res, stride) of each BlazeBlock's K10 call,
    the output's h and w, at the network's 128x128 input."""
    size, cin = tbf.INPUT_SIZE // 2, tbf.STEM_FEATURES
    for features, stride in tbf.BLOCKS:
        size //= stride
        yield size, size, cin, features, cin, stride
        cin = features


@pytest.mark.parametrize("batch", [1, 3, 16, 64])
@pytest.mark.parametrize("layer", range(len(tbf.BLOCKS)))
def test_k10_plan_covers_every_pixel_once(layer, batch):
    """K10's launch plan at every layer: the persistent blocks' walk puts
    every pixel in exactly one tile and every (pixel, output channel) in
    exactly one thread item; tiles are whole 16-byte spans (whole output
    rows at stride 2, whose residual is the input rows under them); two
    stages fit the 227 KB a block may have."""
    h, w, cin, cout, res_c, stride = list(block_layers())[layer]
    plan = tbf.k10_plan(batch, h, w, cin, cout, res_c, stride)
    pixels = batch * h * w
    tiles = -(-pixels // plan.tile_px)
    assert 1 <= plan.blocks <= min(tiles, 132 * 8)
    assert plan.smem_bytes == tbf.k10_smem_bytes(cin, cout, res_c, stride, plan.tile_px,
                                                 plan.stage_out)
    assert plan.smem_bytes <= tbf.SMEM_BLOCK_MAX
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= tbf.K10_MAX_THREADS
    assert plan.tile_px % 4 == 0 and (stride == 1 or plan.tile_px % w == 0)
    k = 4 if stride == 2 else 1
    for c, per_px in ((cin, 1), (cout, 1), (res_c, k)):
        assert plan.tile_px * per_px * c * 4 % 16 == 0
    seen = np.zeros(pixels, np.int64)
    for b in range(plan.blocks):
        for t in range(b, tiles, plan.blocks):
            seen[t * plan.tile_px:(t + 1) * plan.tile_px] += 1
    assert (seen == 1).all()
    # a tile's items: pixels pg + k npg (k < 4) by channels cg co + j
    co = tbf.K10_CO
    npg = plan.tile_px // 4
    cpad = -(-cout // co) * co
    items = np.arange(cpad // co * npg)
    assert items.size <= plan.threads or plan.threads == tbf.K10_MAX_THREADS
    cg, pg = items // npg, items % npg
    px = (pg[:, None, None] + npg * np.arange(4)[None, :, None]).repeat(co, 2)
    ch = (cg[:, None, None] * co + np.arange(co)[None, None, :]).repeat(4, 1)
    cover = np.zeros((plan.tile_px, cpad), np.int64)
    np.add.at(cover, (px.ravel(), ch.ravel()), 1)
    assert (cover == 1).all()
    if stride == 2:
        # output pixel p of the tile at p0 pools input pixels (2y + dy, 2x + dx)
        # of its image: all within the tile's residual span [4 p0, 4 (p0 + np))
        p = np.arange(pixels)
        b_, y, x = p // (h * w), p // w % h, p % w
        for dy in (0, 1):
            for dx in (0, 1):
                q = (b_ * 2 * h + 2 * y + dy) * 2 * w + 2 * x + dx
                p0 = p // plan.tile_px * plan.tile_px
                assert ((q >= 4 * p0) & (q < 4 * np.minimum(p0 + plan.tile_px, pixels))).all()


def test_k10_plan_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="shared memory"):
        tbf.k10_plan(1, 4, 4096, 96, 96, 96, 2)


@pytest.mark.cuda
def test_k9_k10_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    net = tbf.load_weights(device=dev)
    x = torch.from_numpy(views(3, 21)).to(dev)
    probs, boxes = tbf._forward(net, x)
    logits, raw = net.forward_plain(x)
    assert float((probs - torch.sigmoid(logits)).abs().max()) <= PROB_TOL
    assert float((boxes - tbf.decode_boxes(raw, net.anchors)).abs().max()) <= RAW_TOL
    # K10 alone where no tile divides the pixels, channels no multiple of 4,
    # stride-2 widths that set the tile, no residual (within 1e-5 relative)
    rng = np.random.default_rng(5)
    for n, h, w, cin, cout, res_c, stride in (
        (3, 7, 5, 42, 42, 36, 1), (2, 5, 7, 28, 44, 28, 2), (3, 9, 3, 30, 30, 30, 2),
        (5, 11, 13, 96, 96, 96, 1), (1, 6, 6, 17, 20, 0, 1), (7, 19, 23, 24, 24, 24, 1),
    ):
        y, res = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
                  for s in ((n, h, w, cin), (n, stride * h, stride * w, res_c)))
        kern = torch.from_numpy(rng.standard_normal((1, 1, cin, cout)).astype(np.float32))
        bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
        kern, bias = kern.to(dev), bias.to(dev)
        got = tbf.pointwise(y, kern, bias, res, stride)
        ref = tbf.pointwise_plain(y, kern, bias, res, stride)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    # K9 alone on the ragged shapes its plan is walked on (within 1e-5
    # relative), the full form with bias and ReLU
    for n, h, w, cin, cout, stride, dw in K9_RAGGED:
        x = torch.from_numpy(rng.standard_normal((n, h, w, cin)).astype(np.float32)).to(dev)
        kshape = (5, 5, 1, cin) if dw else (5, 5, cin, cout)
        kern = torch.from_numpy(rng.standard_normal(kshape).astype(np.float32)).to(dev)
        bias = None if dw else torch.from_numpy(
            rng.standard_normal(cout).astype(np.float32)).to(dev)
        got = tbf.conv5x5(x, kern, bias, stride, not dw)
        ref = tbf.conv5x5_plain(x, kern, bias, stride, not dw)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-5
    # the head form: one launch for both maps, each map's anchors as the
    # plain head, sigmoid and decode give them
    maps = [(fmap.contiguous(), cls.kernel, cls.bias, reg.kernel, reg.bias, off)
            for fmap, (cls, reg, off) in zip(
                (torch.randn(3, 16, 16, 88, device=dev), torch.randn(3, 8, 8, 96, device=dev)),
                net._heads())]
    probs = torch.full((3, tbf.NUM_ANCHORS), float("nan"), device=dev)
    boxes = torch.full((3, tbf.NUM_ANCHORS, 4), float("nan"), device=dev)
    before = tbf.head_decode.launches
    tbf.head_decode(maps, net.anchors, probs, boxes)
    assert tbf.head_decode.launches == before + 1
    for x, ck, cb, rk, rb, off in maps:
        cls, raw = tbf.head_plain(x, ck, cb, rk, rb)
        end = off + cls.shape[1]
        assert float((probs[:, off:end] - torch.sigmoid(cls)).abs().max()) <= PROB_TOL
        ref = tbf.decode_boxes(raw, net.anchors[off:end])
        assert float((boxes[:, off:end] - ref).abs().max()) <= RAW_TOL


def k9_layers():
    """(h, w, C_in, C_out, stride, depthwise) of the forward's 17 K9 calls at
    the network's 128x128 input: the stem, then each block's depthwise."""
    yield tbf.INPUT_SIZE, tbf.INPUT_SIZE, 3, tbf.STEM_FEATURES, 2, False
    size, c = tbf.INPUT_SIZE // 2, tbf.STEM_FEATURES
    for features, stride in tbf.BLOCKS:
        yield size, size, c, c, stride, True
        size //= stride
        c = features


K9_RAGGED = (  # n, h, w, C_in, C_out, stride, depthwise
    (1, 17, 17, 3, 24, 2, False), (3, 9, 13, 3, 24, 2, False), (2, 7, 5, 3, 24, 1, False),
    (2, 11, 13, 3, 3, 2, True), (1, 7, 9, 3, 3, 1, True), (3, 13, 11, 42, 42, 2, True),
    (2, 9, 19, 42, 42, 1, True), (1, 5, 3, 96, 96, 1, True), (2, 15, 15, 96, 96, 2, True),
    (1, 1, 1, 24, 24, 1, True), (5, 1, 37, 28, 28, 2, True), (7, 33, 31, 36, 36, 2, True),
    (1, 12, 12, 5, 12, 1, False), (2, 13, 11, 5, 12, 2, False),
)


def walk_k9(n, h, w, cin, cout, stride, depthwise, sm_count=132):
    """Walk K9's plan as the kernel does (csrc dw5x5_kernel, full5x5_kernel):
    persistent blocks over tiles of `th` output rows of one image, items of
    (channel group, row, run); check that every output is computed exactly
    once, that each tap of each output reads the staged (row, column) that
    holds its input (a copied value inside the image, a zero of the halo or
    of a zeroed row outside it, as SAME padding pads), that the staged row
    holds every column read and that the plan's shared memory fits."""
    plan = tbf.k9_plan(n, h, w, cin, cout, stride, depthwise, sm_count)
    pt, _, oh = tbf.same_pads(h, stride)
    pl, _, ow = tbf.same_pads(w, stride)
    pc, span, per_row = tbf.k9_geometry(ow, cin, cout, stride, depthwise, plan.run)
    th, run = plan.th, plan.run
    # the kernel's instances: runs of 8 only in the depthwise form at stride 1
    assert run == (8 if depthwise and stride == 1 and ow >= 16 else 4)
    sh = (th - 1) * stride + 5
    bands = -(-oh // th)
    tiles = n * bands
    stages = 2 if tiles > plan.blocks else 1
    assert 1 <= plan.blocks <= tiles
    assert plan.smem_bytes == tbf.k9_smem_bytes(cin, cout, stride, depthwise, th, plan.rp,
                                                stages) <= tbf.SMEM_BLOCK_MAX
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= tbf.K9_MAX_THREADS
    # the full form's rows start up to 3 floats in (csrc: the lead)
    assert plan.rp % 4 == 0 and plan.rp >= span * pc + (0 if depthwise else 3)
    # a staged row holds the halo, the copied image row (from column pl),
    # and the halo again: the copy stays inside the row
    assert pl + w <= span
    seen_tiles = np.zeros(tiles, np.int64)
    for b in range(plan.blocks):
        seen_tiles[b::plan.blocks] += 1
    assert (seen_tiles == 1).all()
    # items of a tile, as the kernel unflattens them
    it = np.arange(th * per_row)
    if depthwise:
        groups = pc // 4
        rest, g = it // groups, it % groups
        k, ty = rest // th, rest % th
        px = k[:, None] * run + np.arange(run)[None, :]           # [items, run]
        ch = g
    else:
        groups = -(-cout // 8)
        cols = -(-ow // run)
        rest, g = it // groups, it % groups
        ty, k = rest // cols, rest % cols
        px = k[:, None] + cols * np.arange(run)[None, :]
        ch = g
    ty2 = np.broadcast_to(ty[:, None], px.shape)
    ch2 = np.broadcast_to(ch[:, None], px.shape)
    count = np.zeros((n, oh, ow, groups), np.int64)
    for t in range(tiles):
        b, oy0 = t // bands, (t % bands) * th
        keep = (ty2 < min(th, oh - oy0)) & (px < ow)
        np.add.at(count, (b, oy0 + ty2[keep], px[keep], ch2[keep]), 1)
        # the staged window: row r = ty s + ky holds input row oy0 s - pt + r,
        # column c = x s + kx input column c - pl
        oy = oy0 + ty2[keep]
        x = px[keep]
        for ky in range(5):
            r = ty2[keep] * stride + ky
            assert (r < sh).all()
            iy_staged = oy0 * stride - pt + r
            assert (iy_staged == oy * stride - pt + ky).all()
            for kx in range(5):
                c = x * stride + kx
                assert (c < span).all()
                ix = c - pl
                assert (ix == x * stride - pl + kx).all()
                inside = (iy_staged >= 0) & (iy_staged < h) & (ix >= 0) & (ix < w)
                halo_col = (c < pl) | (c >= pl + w)
                zero_row = (iy_staged < 0) | (iy_staged >= h)
                assert (inside == ~(halo_col | zero_row)).all()
    assert (count == 1).all()
    return plan


@pytest.mark.parametrize("batch", [1, 3, 16, 64])
@pytest.mark.parametrize("layer", range(len(tbf.BLOCKS) + 1))
def test_k9_plan_covers_every_output_once(layer, batch):
    """K9's plan at every layer of the 1-, 3-, 16- and 64-view forwards."""
    h, w, cin, cout, stride, dw = list(k9_layers())[layer]
    plan = walk_k9(batch, h, w, cin, cout, stride, dw)
    if batch == 64:   # at least half as many tiles as the card has SMs
        assert 2 * batch * -(-tbf.same_pads(h, stride)[2] // plan.th) >= 132


@pytest.mark.parametrize("case", K9_RAGGED)
@pytest.mark.parametrize("sm_count", [2, 132])
def test_k9_plan_on_ragged_shapes(case, sm_count):
    """Odd sizes at stride 2, widths no run divides, C = 3, 42, 96, N = 1,
    and few SMs, so blocks walk several tiles in two stages."""
    walk_k9(*case, sm_count=sm_count)


def test_k9_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="stride"):
        tbf.k9_plan(1, 8, 8, 24, 24, 3, True)
    with pytest.raises(ValueError, match="shared memory"):
        tbf.k9_plan(1, 8, 4096, 96, 96, 1, True)


def test_head_decode_takes_both_maps():
    """The head form is one launch over both anchor maps; a call with one
    map is refused before anything is written."""
    net = tbf.BlazeFace()
    (cls, reg, off), _ = net._heads()
    one = [(torch.zeros(1, 16, 16, cls.kernel.shape[2]), cls.kernel, cls.bias,
            reg.kernel, reg.bias, off)]
    probs = torch.zeros(1, tbf.NUM_ANCHORS)
    boxes = torch.zeros(1, tbf.NUM_ANCHORS, 4)
    with pytest.raises(ValueError, match="two anchor maps"):
        tbf.head_decode(one, net.anchors, probs, boxes)
    assert not probs.any() and not boxes.any()


@pytest.mark.parametrize("batch", [1, 3, 16, 64])
def test_head_plan_covers_every_anchor_once(batch):
    """The head form's one launch: the first blocks take the 16x16 map, the
    rest the 8x8 map; every (view, anchor) of both maps, at the anchor
    offsets of ``BlazeFace._heads()``, is decoded by exactly one (block,
    pixel, anchor) item, and a block's staging fits its shared memory."""
    net = tbf.BlazeFace()
    heads = net._heads()
    maps = ((16 * 16, tbf.BLOCKS[tbf.X16_BLOCK][0], tbf.ANCHORS_16),
            (8 * 8, tbf.BLOCKS[-1][0], tbf.ANCHORS_8))
    plan = tbf.head_plan(batch, maps)
    assert plan.smem_bytes <= tbf.SMEM_BLOCK_MAX
    assert plan.threads % 32 == 0 and plan.threads <= 512
    count = np.zeros((batch, tbf.NUM_ANCHORS), np.int64)
    for block in range(sum(plan.tiles)):
        m = 0 if block < plan.tiles[0] else 1
        t = block - (0 if m == 0 else plan.tiles[0])
        hw, cin, na = maps[m]
        tile = plan.tile_px[m]
        assert tbf.head_smem_bytes(cin, na, tile) <= plan.smem_bytes
        p0 = t * tile
        npx = min(tile, batch * hw - p0)
        assert npx > 0
        it = np.arange(npx * na)
        q = p0 + it // na
        k = heads[m][2] + (q % hw) * na + it % na
        np.add.at(count, (q // hw, k), 1)
    assert (count == 1).all()
    assert heads[1][2] == 16 * 16 * tbf.ANCHORS_16
