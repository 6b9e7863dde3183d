"""The PyTorch package's nvJPEG codec on the card (skips without one).

nvJPEG runs only on a CUDA device, and the card machine has neither JAX nor
the JAX package's codecs, so these tests hold nvJPEG against the JAX
package's answers written beforehand into tests/data/jpeg by
``tools/make_jpeg_fixtures.py`` (``tests/test_torch_codecs.py`` checks on
the CPU that the fixtures are still those answers):

- decode of q90 JPEGs (4:2:0, 4:4:4, progressive, EXIF orientation 6,
  grayscale, Adobe CMYK and YCCK; and the 4:2:0 one at the DCT scales 1,
  2 and 4 of 8 its hints pick) against
  the JAX package's libjpeg-turbo decode: the same size, at most
  ``chip_smoke.NVJPEG_LEVELS`` levels apart, at most
  ``NVJPEG_SHARE_OVER_1`` of values more than 1 level apart (nvJPEG's IDCT
  is not libjpeg's islow, and the prescale is a box mean where libjpeg
  scales in the DCT domain);
- q90 4:4:4 encodes (moz_0, moz_1) of the fixture source: PSNR at least the
  JAX package's less 0.5 dB, at most 1.05x its bytes.

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
                                        ("q90_gray", 8), ("q90_cmyk", 8), ("q90_ycck", 8)])
def test_nvjpeg_decode_against_the_jax_package(card, name, scale):
    with open(os.path.join(DATA, "reference.json")) as fh:
        hints = json.load(fh)["scale_hints"]
    hint = tuple(hints[str(scale)]) if scale < 8 else None
    got = codecs.decode(_read(name + ".jpg"), target_hint=hint, device=card).rgb
    want, _ = png.decode(_read(f"{name}.s{scale}.png"))
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    key = name if scale == 8 else f"{name}.s{scale}"
    assert diff.max() <= chip_smoke.NVJPEG_LEVELS[key]
    assert (diff > 1).mean() <= chip_smoke.NVJPEG_SHARE_OVER_1


@pytest.mark.cuda
def test_nvjpeg_refuses_a_decompression_bomb(card):
    """A header that declares 30000 x 30000 pixels is refused before any
    device memory is taken."""
    from flyimg_tpu_torch.exceptions import ExecFailedException

    with pytest.raises(ExecFailedException, match="decode limit"):
        codecs.decode(chip_smoke.bomb_header(_read("q90_444.jpg")), device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("moz", [0, 1])
def test_nvjpeg_encode_against_the_jax_package(card, moz):
    with open(os.path.join(DATA, "reference.json")) as fh:
        jax = json.load(fh)["encode_q90_444"][f"moz_{moz}"]
    src, _ = png.decode(_read("source.png"))
    blob = codecs.encode(src, "jpg", quality=90, mozjpeg=bool(moz), sampling_factor="1x1",
                         device=card)
    # both encodes decoded by nvJPEG: one decoder's error on both sides
    back = codecs.decode(blob, device=card).rgb
    jax_back = codecs.decode(_read(jax["file"]), device=card).rgb
    assert chip_smoke.psnr(back, src) >= chip_smoke.psnr(jax_back, src) - 0.5
    assert len(blob) <= 1.05 * jax["bytes"]
