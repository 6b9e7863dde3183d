"""The PyTorch package's resample (flyimg_tpu_torch/ops/resample.py) against
the JAX package's, on the same numpy-seeded inputs: K selection, dense
weights, band weights, and dense/banded outputs for every filter, with
bucket-padded inputs (in_true < bucket), crop spans and upscales.

Bounds (those of tests/test_resample_banded.py): f32 within atol 1e-3,
and at most 1 u8 level after quantising. Kernel K1 itself is held against
its plain version on the card by chip_smoke.py and by the cuda-marked test
below."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flyimg_tpu.ops import resample as jr
from flyimg_tpu_torch.ops import resample as tr

torch.set_num_threads(1)

FILTERS = sorted(jr.FILTER_SUPPORT)

# (in bucket (h, w), out (h, w), span_y, span_x, out_true, in_true)
GEOMETRIES = {
    # downscale of a bucket-padded source
    "downscale": ((128, 256), (40, 64), (0.0, 100.0), (0.0, 230.0),
                  (40, 64), (100, 230)),
    # crop-fill span inside the source
    "crop": ((128, 128), (30, 40), (12.5, 60.0), (3.0, 80.0),
             (30, 40), (120, 110)),
    # upscale: output larger than the span
    "upscale": ((128, 128), (90, 70), (0.0, 37.0), (5.0, 29.0),
                (90, 70), (37, 40)),
    # static output larger than its valid region (bucketed fit path)
    "padded_out": ((128, 128), (64, 64), (0.0, 90.0), (0.0, 100.0),
                   (45, 50), (90, 100)),
}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _geo(g, batch=2):
    _inb, _out, sy, sx, ot, it = g
    rows = lambda v: np.tile(np.asarray(v, np.float32)[None], (batch, 1))  # noqa: E731
    return rows(sy), rows(sx), rows(ot), rows(it)


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(np.float32)


@pytest.mark.parametrize("method", FILTERS)
@pytest.mark.parametrize("scale", [0.3, 1.0, 1.7, 4.0, 13.0])
def test_k_selection_matches(method, scale):
    assert tr.band_taps(method, scale) == jr.band_taps(method, scale)
    assert tr.bucket_taps(tr.band_taps(method, scale)) == \
        jr.bucket_taps(jr.band_taps(method, scale))
    for mode in tr.KERNEL_MODES:
        args = (mode, method, (512, 384), (3.0, 300.0 * scale),
                (0.0, 380.0), (300.0, 200.0))
        assert tr.select_band_taps(*args) == jr.select_band_taps(*args)


@pytest.mark.parametrize("method", FILTERS)
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_dense_weights_match(method, name):
    g = GEOMETRIES[name]
    (in_h, _), (out_h, _), sy, _sx, ot, it = g
    tw = tr.resample_matrix(in_h, out_h, _t(sy[0]), _t(sy[1]), _t(ot[0]),
                            _t(it[0]), method).numpy()
    jw = np.asarray(jr.resample_matrix(in_h, out_h, sy[0], sy[1], ot[0],
                                       it[0], method))
    np.testing.assert_allclose(tw, jw, atol=1e-3)


@pytest.mark.parametrize("method", FILTERS)
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_band_weights_match(method, name):
    g = GEOMETRIES[name]
    (in_h, in_w), (out_h, out_w), sy, sx, ot, it = g
    for axis, (n_in, n_out, span) in enumerate(
        ((in_h, out_h, sy), (in_w, out_w, sx))
    ):
        taps = tr.select_band_taps("banded", method, (in_h, in_w), sy, sx, ot)[axis]
        ti, tw = tr._band_axis(n_in, n_out, taps, _t(span[0]), _t(span[1]),
                               _t(ot[axis]), _t(it[axis]), method)
        ji, jw = jr._band_axis(n_in, n_out, taps, span[0], span[1], ot[axis],
                               it[axis], method)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-3)


def _jax_batch(fn, img, *geo, **kw):
    sy, sx, ot, it = geo
    return np.stack([
        np.asarray(fn(jnp.asarray(img[i]), kw["out"], sy[i], sx[i], ot[i],
                      it[i], *kw.get("extra", ()), method=kw["method"]))
        for i in range(img.shape[0])
    ])


@pytest.mark.parametrize("method", FILTERS)
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_resample_outputs_match(method, name):
    g = GEOMETRIES[name]
    (in_h, in_w), out, sy, sx, ot, it = g
    img = _image((2, in_h, in_w, 3), seed=len(name) + len(method))
    geo = _geo(g)
    tgeo = [_t(a) for a in geo]
    band = tr.select_band_taps("banded", method, (in_h, in_w), sy, sx, ot)

    dense_t = tr.resample_image(_t(img), out, *tgeo, method=method).numpy()
    dense_j = _jax_batch(jr.resample_image, img, *geo, out=out, method=method)
    np.testing.assert_allclose(dense_t, dense_j, atol=1e-3)

    band_t = tr.resample_image_banded(_t(img), out, *tgeo, band, method).numpy()
    band_j = _jax_batch(jr.resample_image_banded, img, *geo, out=out,
                        extra=(band,), method=method)
    np.testing.assert_allclose(band_t, band_j, atol=1e-3)

    # the u8 wrapper (kernel K1's plain twin on the CPU) against the JAX
    # banded path quantised the program's way
    u8 = tr.resample_banded_u8(torch.from_numpy(img.astype(np.uint8)), out,
                               *tgeo, band, method).numpy()
    ref = np.clip(np.round(band_j), 0, 255)
    assert np.abs(u8.astype(np.int64) - ref).max() <= 1


def test_banded_wrapper_checks_its_inputs():
    img = torch.zeros((2, 16, 16, 3), dtype=torch.uint8)
    geo = [torch.ones((2, 2)) for _ in range(4)]
    with pytest.raises(ValueError):
        tr.resample_banded_u8(img.float(), (8, 8), *geo, (8, 8))
    with pytest.raises(ValueError):
        tr.resample_banded_u8(img, (8, 8), torch.ones((3, 2)), *geo[1:], (8, 8))
    with pytest.raises(ValueError):
        tr.resample_banded_u8(img, (8, 8), *geo, (8, 8), method="sinc9")


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    before = tr.resample_banded_u8.launches
    img = torch.from_numpy(_image((1, 32, 32, 3), 3).astype(np.uint8))
    geo = [torch.tensor([v]) for v in ([0.0, 32.0], [0.0, 32.0], [16.0, 16.0],
                                        [32.0, 32.0])]
    tr.resample_banded_u8(img, (16, 16), *geo, (8, 8))
    assert tr.resample_banded_u8.launches == before


@pytest.mark.cuda
def test_k1_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py on the H100)")
    dev = torch.device("cuda")
    img = torch.from_numpy(_image((4, 256, 256, 3), 9).astype(np.uint8)).to(dev)
    rows = lambda v: torch.tensor([v], device=dev).repeat(4, 1)  # noqa: E731
    geo = (rows([3.0, 200.0]), rows([0.0, 256.0]), rows([100.0, 120.0]),
           rows([240.0, 256.0]))
    got = tr.resample_banded_u8(img, (100, 120), *geo, (16, 16))
    ref = tr.quantize_u8(tr.resample_image_banded(img.float(), (100, 120),
                                                  *geo, (16, 16)))
    assert int((got.int() - ref.int()).abs().max()) <= 1


# ---------------------------------------------------------------------------
# kernel K1's host-side launch plan, over seeded random geometries
# ---------------------------------------------------------------------------


def _random_k1_case(seed):
    """(in bucket, out, per-member geometry rows, taps, method) of one
    seeded geometry; the kinds cycle through downscale, upscale, spans
    clamped at both edges, in_true < bucket, K = 32 and K >= 128."""
    rng = np.random.default_rng(1000 + seed)
    kind = seed % 6
    method = FILTERS[seed % len(FILTERS)]
    in_h = int(rng.integers(16, 700))
    in_w = 4 * int(rng.integers(4, 200))
    out_h, out_w = int(rng.integers(8, 260)), int(rng.integers(8, 310))
    if kind == 1:  # upscale
        in_h, in_w = int(rng.integers(8, 64)), 4 * int(rng.integers(2, 16))
    if kind == 5:  # a large downscale: K >= 128 on both axes
        in_h, in_w = int(rng.integers(1500, 2600)), 4 * int(rng.integers(400, 640))
        out_h, out_w = int(rng.integers(8, 24)), int(rng.integers(8, 24))
    rows = []
    for _ in range(2):
        th = float(in_h if kind != 3 else rng.integers(in_h // 2, in_h + 1))
        tw = float(in_w if kind != 3 else rng.integers(in_w // 2, in_w + 1))
        if kind == 2:  # spans reaching past both edges: sample points clamp
            sy = (float(rng.uniform(-20, 0)), th + float(rng.uniform(0, 40)))
            sx = (float(rng.uniform(-20, 0)), tw + float(rng.uniform(0, 40)))
        else:
            fy, fx = rng.uniform(0.5, 1.0, 2)
            sy = (float(rng.uniform(0, th * (1 - fy))), float(th * fy))
            sx = (float(rng.uniform(0, tw * (1 - fx))), float(tw * fx))
        ot = (float(rng.integers(out_h // 2, out_h + 1)),
              float(rng.integers(out_w // 2, out_w + 1)))
        rows.append((sy, sx, ot, (th, tw)))
    scale_y = max(r[0][1] / max(r[2][0], 1.0) for r in rows)
    scale_x = max(r[1][1] / max(r[2][1], 1.0) for r in rows)
    ky = tr.bucket_taps(tr.band_taps(method, scale_y))
    kx = tr.bucket_taps(tr.band_taps(method, scale_x))
    if kind == 4:
        ky, kx = 32, 32
    taps = (min(ky, in_h), min(kx, in_w))
    return (in_h, in_w), (out_h, out_w), rows, taps, method


@pytest.mark.parametrize("seed", range(12))
def test_k1_plan_windows_hold_every_band_row(seed):
    """Every source row and column that carries a nonzero band weight in the
    JAX package's _band_axis lies inside the window K1's block finds for its
    tile, the band starts K1 computes agree with the JAX bands, and the
    plan is one the kernel takes."""
    in_hw, out_hw, rows, taps, method = _random_k1_case(seed)
    plan = tr.k1_plan(in_hw, out_hw, taps, len(rows))
    assert plan.tile_h % tr.K1_SUB == 0 and plan.tile_h in tr.K1_TILE_HEIGHTS
    assert 1 <= plan.tile_w <= out_hw[1] and plan.chunk_w >= 4
    assert 1 <= plan.row_chunk <= tr.K1_ROW_CHUNK_MAX
    assert plan.smem_bytes == tr.k1_smem_bytes(
        plan.tile_h, plan.tile_w, plan.chunk_w, plan.row_chunk, taps[0],
        taps[1], plan.stage_wx, plan.stage_wy, plan.tiles_per_block)
    assert plan.smem_bytes <= tr.K1_SMEM_LIMIT
    assert plan.kx_static == (taps[1] if taps[1] in tr.K1_STATIC_KX else 0)
    n_rt = -(-out_hw[0] // plan.tile_h)
    assert 1 <= plan.tiles_per_block <= n_rt
    assert plan.tiles_per_block * plan.tile_h <= tr.K1_RUN_ROWS_MAX
    assert plan.grid == (-(-n_rt // plan.tiles_per_block)
                         * -(-out_hw[1] // plan.tile_w), len(rows))

    starts = []
    for axis in (0, 1):
        j0 = []
        for sy, sx, ot, it in rows:
            span = (sy, sx)[axis]
            ji, jw = jr._band_axis(in_hw[axis], out_hw[axis], taps[axis],
                                   span[0], span[1], ot[axis], it[axis], method)
            s = tr.band_starts(in_hw[axis], out_hw[axis], taps[axis],
                               _t(span[0]), _t(span[1]), _t(ot[axis]),
                               _t(it[axis])).numpy()
            # K1's band is the JAX band: tap k gathers clip(j0 + k)
            k = np.arange(taps[axis])
            np.testing.assert_array_equal(
                np.clip(s[:, None] + k, 0, in_hw[axis] - 1), np.asarray(ji))
            j0.append((s, np.asarray(ji), np.asarray(jw)))
        starts.append(j0)
    jy = torch.from_numpy(np.stack([s for s, _, _ in starts[0]]))
    jx = torch.from_numpy(np.stack([s for s, _, _ in starts[1]]))
    windows = tr.k1_tile_windows(plan, jy, jx, in_hw, taps)
    n_ct = -(-out_hw[1] // plan.tile_w)
    for b in range(len(rows)):
        _, iy, wy = starts[0][b]
        _, ix, wx = starts[1][b]
        for ti, ((rlo, rhi), (plo, phi), n_rc, n_cc) in enumerate(windows[b]):
            assert n_rc >= 1 and n_cc >= 1
            oy0 = (ti // n_ct) * plan.tile_h
            ox0 = (ti % n_ct) * plan.tile_w
            ry = iy[oy0: oy0 + plan.tile_h][wy[oy0: oy0 + plan.tile_h] != 0]
            cx = ix[ox0: ox0 + plan.tile_w][wx[ox0: ox0 + plan.tile_w] != 0]
            assert ((ry >= rlo) & (ry < rhi)).all(), (ti, ry.min(), ry.max(), rlo, rhi)
            assert ((cx >= plo) & (cx < phi)).all(), (ti, cx.min(), cx.max(), plo, phi)


@pytest.mark.parametrize("shape", [
    ((512, 512), (250, 300), (16, 16), 256),      # the flagship
    ((1152, 1920), (250, 300), (32, 32), 16),     # a serving bucket
    ((4096, 4096), (250, 300), (128, 128), 4),    # run-time K
    ((256, 20480), (250, 300), (16, 512), 2),     # wider than one chunk
    ((128, 128), (250, 300), (8, 8), 16),         # upscale
    ((1, 4), (3, 5), (1, 4), 1),                  # a one-row source
])
def test_k1_plan_fits_the_card(shape):
    plan = tr.k1_plan(*shape)
    assert plan.smem_bytes <= tr.K1_SMEM_LIMIT
    (in_h, in_w), (out_h, out_w), (ky, kx), _b = shape
    # a wide source is cut into column chunks rather than refused
    cols = tr._k1_window(plan.tile_w, in_w / out_w, kx, in_w)
    assert plan.chunk_w <= cols
    assert plan.kx_static == (kx if kx in tr.K1_STATIC_KX else 0)


def test_k1_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        tr.k1_plan((0, 4), (3, 5), (1, 4), 1)


@pytest.mark.parametrize("name", ["downscale", "crop", "upscale"])
def test_fold2d_bf16_form_matches_jax(name):
    """The dense resample's bf16-operand form (FLYIMG_RESAMPLE_FORM=
    fold2d_bf16): against JAX's _apply_fold2d_bf16 on the same weights
    within 1e-3 (f32 sums in another order), and against the f32 form
    within one u8 level (tests/test_ops.py's bound)."""
    g = GEOMETRIES[name]
    (in_h, in_w), out, sy, sx, ot, it = g
    img = _image((2, in_h, in_w, 3), seed=len(name))
    geo = [_t(a) for a in _geo(g)]
    wy = tr.resample_matrix(in_h, out[0], geo[0][:, 0], geo[0][:, 1], geo[2][:, 0],
                            geo[3][:, 0])
    wx = tr.resample_matrix(in_w, out[1], geo[1][:, 0], geo[1][:, 1], geo[2][:, 1],
                            geo[3][:, 1])
    got = tr._apply_fold2d_bf16(_t(img), wy, wx).numpy()
    want = np.stack([
        np.asarray(jr._apply_fold2d_bf16(jnp.asarray(img[i]), jnp.asarray(wy[i].numpy()),
                                         jnp.asarray(wx[i].numpy()), *out))
        for i in range(2)
    ])
    assert got.shape == want.shape == (2,) + tuple(out) + (3,)
    np.testing.assert_allclose(got, want, atol=1e-3)
    if name == "upscale":
        # the bf16 intermediate keeps 8 bits (steps of 1.0 above 128) and an
        # upscale's lanczos lobes add two such roundings of noise: the
        # reference's form is 2 levels off its f32 form here too (the one-
        # level bound of tests/test_ops.py is a downscale's)
        return
    f32 = tr.resample_image(_t(img), out, *geo).numpy()
    q = lambda a: np.clip(np.round(a), 0, 255).astype(np.int32)  # noqa: E731
    assert np.abs(q(got) - q(f32)).max() <= 1
