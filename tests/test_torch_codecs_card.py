"""The PyTorch package's JPEG codecs on the card (skips without one).

The kernels run only on a CUDA device, and the card machine has neither JAX
nor the JAX package's codecs, so these tests hold the port's codecs and
nvJPEG (the library yardstick) against the JAX package's answers written
beforehand into tests/data/jpeg by ``tools/make_jpeg_fixtures.py``
(``tests/test_torch_codecs.py`` checks on the CPU that the fixtures are
still those answers):

- the port's own decoder (K18 and K19) against the native-route decodes
  (``<name>.native.s<k>.png``): exact;

- nvJPEG's decode of q90 JPEGs (4:2:0, 4:4:4, progressive, EXIF orientation 6,
  grayscale, Adobe CMYK and YCCK, whole and with subsampled components,
  RGB-coded; and the 4:2:0 one at the DCT scales 1, 2 and 4 of 8 its hints
  pick) against
  the JAX package's libjpeg-turbo decode: the same size, at most
  ``chip_smoke.NVJPEG_LEVELS`` levels apart, at most
  ``NVJPEG_SHARE_OVER_1`` of values more than 1 level apart (nvJPEG's IDCT
  is not libjpeg's islow, and the prescale is a box mean where libjpeg
  scales in the DCT domain);
- the JPEG encodes of the port's own encoder on the card (kernels K16 and
  K17) against the JAX package's native bytes in tests/data/jpeg_enc
  (``tools/make_jpeg_encode_fixtures.py``), and the two kernels' coefficients
  against their plain versions.

Run on the card: ``python3 -m pytest -m cuda tests/test_torch_codecs_card.py``
(``chip_smoke.py`` phase 10 runs the same checks).
"""

import json
import os

import numpy as np
import pytest

import chip_smoke
from flyimg_tpu_torch import codecs
from flyimg_tpu_torch.codecs import png

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (nvJPEG; chip_smoke.py phase 10 runs these on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale", [("q90_420", 8), ("q90_444", 8),
                                        ("q90_420_progressive", 8), ("q90_420_orient6", 8),
                                        ("q90_420", 1), ("q90_420", 2), ("q90_420", 4),
                                        ("q90_gray", 8), ("q90_cmyk", 8), ("q90_ycck", 8),
                                        ("q90_cmyk_h2v1", 8), ("q90_cmyk_h2v2", 8),
                                        ("q90_ycck_h2v2", 8), ("q90_rgb_adobe0", 8)])
def test_nvjpeg_decode_against_the_jax_package(card, name, scale):
    """nvJPEG's own decode (the library yardstick since the port decodes
    with its own decoder; the test keeps its name), turned upright."""
    from flyimg_tpu_torch.codecs.exif import apply_orientation, jpeg_orientation
    from flyimg_tpu_torch.codecs.native_codec import nvjpeg_decode

    data = _read(name + ".jpg")
    got = apply_orientation(nvjpeg_decode(data, scale, device=card), jpeg_orientation(data))
    want, _ = png.decode(_read(f"{name}.s{scale}.png"))
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    key = name if scale == 8 else f"{name}.s{scale}"
    assert diff.max() <= chip_smoke.NVJPEG_LEVELS[key]
    assert (diff > 1).mean() <= chip_smoke.NVJPEG_SHARE_OVER_1


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 4, 8])
def test_jpeg_decoder_on_the_card_is_the_native_route(card, scale):
    """The port's decoder on the card (K18 and K19, each held to its plain
    version) gives every tests/data/jpeg file's native-route decode at
    every DCT scale (chip_smoke.py phase 3 runs the same)."""
    names = sorted(f for f in os.listdir(DATA) if f.endswith(".jpg"))
    got, _, _ = chip_smoke.decode_held(__import__("torch"), card, f"1/{8 // scale}",
                                       [(_read(f), scale, None) for f in names])
    for f, out in zip(names, got):
        want, _ = png.decode(_read(f"{f[:-4]}.native.s{scale}.png"))
        np.testing.assert_array_equal(out.rgb, want)


@pytest.mark.cuda
def test_nvjpeg_refuses_a_decompression_bomb(card):
    """A header that declares 30000 x 30000 pixels is refused before any
    device memory is taken (by the port's decoder since it replaced
    nvJPEG's; the test keeps its name)."""
    from flyimg_tpu_torch.exceptions import ExecFailedException

    with pytest.raises(ExecFailedException, match="decode limit"):
        codecs.decode(chip_smoke.bomb_header(_read("q90_444.jpg")), device=card)


ENC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg_enc")


@pytest.mark.cuda
@pytest.mark.parametrize("moz", [0, 1])
def test_nvjpeg_encode_against_the_jax_package(card, moz):
    """The JPEG encode on the card (the port's own encoder since nvJPEG's
    encode stopped serving; the test keeps its name) gives the JAX
    package's native bytes (tests/data/jpeg_enc): moz_1 at 4:4:4, moz_0 at
    2x4."""
    with open(os.path.join(ENC, "source.png"), "rb") as fh:
        src, _ = png.decode(fh.read())
    sampling, name = ("1x1", "trellis_q90_1x1.jpg") if moz else ("2x4", "plain_q90_2x4.jpg")
    blob = codecs.encode(src, "jpg", quality=90, mozjpeg=bool(moz), sampling_factor=sampling,
                         device=card)
    with open(os.path.join(ENC, name), "rb") as fh:
        assert blob == fh.read()


@pytest.mark.cuda
def test_jpeg_kernels_against_their_plain_versions(card):
    """K16 and K17 give their plain versions' coefficients exactly, and every
    encode of tests/data/jpeg_enc is its file (chip_smoke.py phases 3 and
    10 run the same)."""
    import torch

    from flyimg_tpu_torch.codecs import jpeg_enc, jpeg_plain, jpeg_tables

    with open(os.path.join(ENC, "source.png"), "rb") as fh:
        src, _ = png.decode(fh.read())
    rgb = torch.from_numpy(src)
    for sampling in ((1, 1), (2, 2), (1, 3), (4, 2)):
        got = jpeg_enc.trellis_coefficients(rgb.to(card), 90, sampling).cpu()
        assert torch.equal(got, jpeg_plain.trellis_plain(rgb, 90, sampling))
        planes = jpeg_plain.grid_planes(rgb, sampling)
        tables = jpeg_tables.qtables(90)
        got = jpeg_enc.fdct_coefficients([p.to(card) for p in planes], tables, (0, 1, 1))
        assert torch.equal(got.cpu(), jpeg_enc.fdct_coefficients(planes, tables, (0, 1, 1)))
    with open(os.path.join(ENC, "reference.json")) as fh:
        ref = json.load(fh)
    for name, entry in ref["files"].items():
        assert chip_smoke.jpeg_fixture_encode(entry, src, card) == _read_enc(name), name


def _read_enc(name):
    with open(os.path.join(ENC, name), "rb") as fh:
        return fh.read()
