"""A stand-in for the PyTorch package's nvJPEG decode on a host without a
card, and a recorder of its JPEG encodes, for the CPU tests of what
surrounds them (orientation, prescale selection, option routing in the
handler).

The port decodes JPEG with nvJPEG on a CUDA device only
(``flyimg_tpu_torch/codecs/native_codec.py``); this host has no card. The
stand-in keeps that function's contract with Pillow's libjpeg: decode at
scale_num/8 (libjpeg's DCT scaling, the size ceil(size * scale_num / 8)).
The port encodes JPEG with its own encoder (``codecs/jpeg_enc.py``), whose
kernels run on a card and whose plain versions run here: the recorder
notes each call's arguments (the device asked for among them) and runs
the encoder on the CPU. It is never part of the package: the card's own
tests hold nvJPEG and the kernels themselves.
"""

import inspect
import io

import numpy as np
from PIL import Image

from flyimg_tpu_torch.codecs import jpeg_enc, native_codec


def decode(data, scale_num=8, device="cuda"):
    decode.calls.append({"scale_num": scale_num, "device": str(device)})
    img = Image.open(io.BytesIO(data))
    if 1 <= scale_num < 8:
        # Pillow takes the largest reduction r with size // request >= r
        w, h, r = *img.size, 8 // scale_num
        img.draft("RGB", (max(1, w // r), max(1, h // r)))
        assert img.size == (-(-w // r), -(-h // r)), "Pillow chose another scale"
    return np.asarray(img.convert("RGB")).copy()


def _recorder(name, real):
    signature = inspect.signature(real)

    def call(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        record = {"encoder": name}
        record.update((k, v) for k, v in list(bound.arguments.items())[1:] if k != "device")
        record["device"] = str(bound.arguments["device"])
        if "sampling" in record:
            record["sampling"] = tuple(record["sampling"])
        encode.calls.append(record)
        bound.arguments["device"] = "cpu"
        return real(*bound.args, **bound.kwargs)

    return call


def encode():
    """Holder of the recorded JPEG encodes (``encode.calls``)."""


ENCODERS = ("encode_trellis", "encode_plain", "encode_cmyk")


def install(monkeypatch):
    """Put the stand-in in place of the nvJPEG decode, and the recorder
    around the port's JPEG encodes, for one test."""
    decode.calls, encode.calls = [], []
    monkeypatch.setattr(native_codec, "jpeg_decode", decode)
    for name in ENCODERS:
        monkeypatch.setattr(jpeg_enc, name, _recorder(name, getattr(jpeg_enc, name)))
