"""The JAX package's native JPEG encoders for the CPU tests of the port's.

The JAX package encodes ``moz_1`` and ``moz_0`` JPEGs with its native
library (``flyimg_tpu/codecs/native/fastcodec.cpp``). The library prebuilt
beside that source does not load on every host, and the JAX package then
answers through Pillow, which writes other bytes. So these tests compile
the unmodified source into a temporary directory
(``tools/make_jpeg_encode_fixtures.py build_fastcodec``) and point the
JAX package at it for one test at a time (``use_in_jax``); nothing under
``flyimg_tpu/`` is written. Where g++ or libjpeg's headers are missing the
tests that need it skip, saying which.

Import the ``fastcodec`` fixture into a test module to use it.
"""

import importlib.util
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_jpeg_encode_fixtures", os.path.join(_ROOT, "tools", "make_jpeg_encode_fixtures.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


@pytest.fixture(scope="module")
def fastcodec(tmp_path_factory):
    """The JAX package's JPEG encoders (``tool.FastCodec``), built for this
    module into a temporary directory."""
    reason = tool.missing()
    if reason:
        pytest.skip(f"the JAX package's native codec cannot be built here: {reason}")
    return tool.FastCodec(tool.build_fastcodec(str(tmp_path_factory.mktemp("fastcodec"))))


def use_in_jax(monkeypatch, codec) -> None:
    """The JAX package's ``native_codec`` loads ``codec``'s library for one
    test (restored after it)."""
    tool.jax_native(monkeypatch, codec.path)
