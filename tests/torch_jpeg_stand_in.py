"""Recorders of the PyTorch package's JPEG decodes and encodes, for the CPU
tests of what surrounds them (orientation, prescale selection, option
routing in the handler).

The port decodes JPEG with its own decoder (``codecs/jpeg_dec.py``) and
encodes with its own encoder (``codecs/jpeg_enc.py``); their kernels run
on a card and their plain versions here. Each recorder notes a call's
arguments (the device asked for among them) and runs the real function on
the CPU. The card's own tests hold the kernels themselves.
"""

import inspect

from flyimg_tpu_torch.codecs import jpeg_dec, jpeg_enc


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


def decode():
    """Holder of the recorded JPEG decodes (``decode.calls``: scale_num and
    the device asked for)."""


def encode():
    """Holder of the recorded JPEG encodes (``encode.calls``)."""


ENCODERS = ("encode_trellis", "encode_plain", "encode_cmyk")

#: a group encode (the codec batcher's) -> the single encode each member's
#: bytes equal, and that encode's fixed arguments
GROUPS = {"encode_trellis_group": ("encode_trellis", {"progressive": True}),
          "encode_plain_group": ("encode_plain", {"optimize": False, "progressive": False})}


def _group_recorder(real, single, fixed):
    def call(images, quality=90, sampling=(1, 1), *, device="cuda"):
        for _ in images:
            encode.calls.append({"encoder": single, "quality": quality, **fixed,
                                 "sampling": tuple(sampling), "device": str(device)})
        return real(images, quality, sampling, device="cpu")

    return call


def _batch_decode_recorder(real):
    def call(items, device="cuda", *args, **kwargs):
        for _data, scale_num, _roi in items:
            decode.calls.append({"scale_num": scale_num, "device": str(device)})
        return real(items, "cpu", *args, **kwargs)

    return call


def install(monkeypatch):
    """Put the recorders around the port's JPEG decodes (every decode is a
    ``jpeg_dec.decode_batch``, a member a record) and encodes (single and
    grouped, a group recorded as its members' single encodes), for one
    test."""
    decode.calls, encode.calls = [], []
    monkeypatch.setattr(jpeg_dec, "decode_batch", _batch_decode_recorder(jpeg_dec.decode_batch))
    for name in ENCODERS:
        monkeypatch.setattr(jpeg_enc, name, _recorder(name, getattr(jpeg_enc, name)))
    for name, (single, fixed) in GROUPS.items():
        monkeypatch.setattr(jpeg_enc, name,
                            _group_recorder(getattr(jpeg_enc, name), single, fixed))
