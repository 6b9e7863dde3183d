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
