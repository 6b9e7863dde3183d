"""A stand-in for the PyTorch package's nvJPEG calls on a host without a
card, for the CPU tests of what surrounds them (orientation, prescale
selection, option routing in the handler).

The port decodes and encodes JPEG with nvJPEG on a CUDA device only
(``flyimg_tpu_torch/codecs/native_codec.py``); this host has no card. The
stand-in keeps those functions' contract with Pillow's libjpeg: decode at
scale_num/8 (libjpeg's DCT scaling, the size ceil(size * scale_num / 8)),
encode with a quality, optimized Huffman tables and progressive scans on or
off, and luma sampling factors. It records each call's arguments. It is
never part of the package: the card's own tests hold nvJPEG itself.
"""

import io

import numpy as np
from PIL import Image

from flyimg_tpu_torch.codecs import native_codec

#: luma (h, v) factors -> Pillow's subsampling preset (as the JAX package's
#: Pillow path maps them)
_PIL_SUBSAMPLING = {(1, 1): 0, (2, 1): 1, (1, 2): 1}


def decode(data, scale_num=8, device="cuda"):
    decode.calls.append({"scale_num": scale_num, "device": str(device)})
    img = Image.open(io.BytesIO(data))
    if 1 <= scale_num < 8:
        # Pillow takes the largest reduction r with size // request >= r
        w, h, r = *img.size, 8 // scale_num
        img.draft("RGB", (max(1, w // r), max(1, h // r)))
        assert img.size == (-(-w // r), -(-h // r)), "Pillow chose another scale"
    return np.asarray(img.convert("RGB")).copy()


def encode(rgb, quality=90, *, optimize=True, progressive=True, sampling=(1, 1),
           device="cuda"):
    encode.calls.append({"quality": quality, "optimize": optimize,
                         "progressive": progressive, "sampling": tuple(sampling),
                         "device": str(device)})
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality, optimize=optimize,
                              progressive=progressive,
                              subsampling=_PIL_SUBSAMPLING.get(tuple(sampling), 2))
    return buf.getvalue()


def install(monkeypatch):
    """Put the stand-in in place of the nvJPEG calls for one test."""
    decode.calls, encode.calls = [], []
    monkeypatch.setattr(native_codec, "jpeg_decode", decode)
    monkeypatch.setattr(native_codec, "jpeg_encode", encode)
