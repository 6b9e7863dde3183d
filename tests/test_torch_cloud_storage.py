"""The PyTorch package's S3 and GCS stores held against the JAX package's,
on the same in-memory stand-in clients (``torch_cloud_stand_ins``): each
scripted sequence of operations gives both packages' stores the same
results, the same exceptions (by class name), the same client calls, the
same public URLs and the same client timeout configuration. Exact
comparison throughout."""

import contextlib
import logging
import sys

import numpy as np
import pytest
import torch
import torch_cloud_stand_ins as stand_in

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.storage import make_storage as jmake_storage
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.storage import make_storage

torch.set_num_threads(1)

PACKAGES = {
    "jax": (JAppParameters, jmake_storage, "flyimg_tpu.storage.s3"),
    "torch": (AppParameters, make_storage, "flyimg_tpu_torch.storage.s3"),
}


def outcome(fn):
    """("ok", value) or ("raise", the exception's class name)."""
    try:
        return ("ok", fn())
    except Exception as exc:
        return ("raise", type(exc).__name__)


@contextlib.contextmanager
def warnings_of(logger_name):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(logger_name)
    handler = Keep(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def both(monkeypatch, script, conf, install):
    """``script(storage, client)``'s result for each package's store, each
    on a fresh stand-in client, and the pair held equal."""
    results = {}
    for name, (params_cls, make, _logger) in PACKAGES.items():
        installed = install(monkeypatch)
        made = outcome(lambda: make(params_cls(dict(conf))))
        if made[0] == "raise":
            results[name] = made
            continue
        client = installed[1][-1] if install is stand_in.install_boto3 else installed[-1]
        results[name] = script(made[1], client)
    assert results["torch"] == results["jax"]
    return results["torch"]


def s3(monkeypatch, script, conf=None):
    return both(monkeypatch, script, conf or stand_in.S3_CONF, stand_in.install_boto3)


def gcs(monkeypatch, script, conf=None):
    return both(monkeypatch, script, conf or stand_in.GCS_CONF, stand_in.install_gcs)


@pytest.mark.parametrize("conf", [
    {"storage_system": "s3", "aws_s3": {"region": "x"}},
    {"storage_system": "s3", "aws_s3": {"access_id": "a", "secret_key": "b", "region": "r"}},
    {"storage_system": "gcs", "gcs": {}},
])
def test_missing_config_raises_alike(monkeypatch, conf):
    stand_in.install_boto3(monkeypatch)
    stand_in.install_gcs(monkeypatch)
    got = {name: outcome(lambda: make(cls(dict(conf))))
           for name, (cls, make, _l) in PACKAGES.items()}
    assert got["torch"] == got["jax"] == ("raise", "MissingParamsException")


@pytest.mark.parametrize("module,conf", [("boto3", stand_in.S3_CONF),
                                         ("google.cloud", stand_in.GCS_CONF)])
def test_missing_client_library_raises_alike(monkeypatch, module, conf):
    for name in ("boto3", "google", "google.cloud", "google.cloud.storage"):
        monkeypatch.setitem(sys.modules, name, None)
    got = {name: outcome(lambda: make(cls(dict(conf))))
           for name, (cls, make, _l) in PACKAGES.items()}
    assert got["torch"] == got["jax"] == ("raise", "MissingParamsException")


def test_public_urls_alike(monkeypatch):
    assert s3(monkeypatch, lambda st, _c: st.public_url("abc.jpg")) == (
        "https://s3.eu-west-1.amazonaws.com/imgs/abc.jpg")
    assert gcs(monkeypatch, lambda st, _c: st.public_url("a.jpg", "http://h")) == (
        "https://storage.googleapis.com/imgs/a.jpg")


def _roundtrip(st, client):
    steps = [outcome(lambda: st.has("k.webp")),
             outcome(lambda: st.fetch("k.webp")),
             outcome(lambda: st.stat("k.webp")),
             outcome(lambda: st.write("k.webp", b"payload")),
             outcome(lambda: st.has("k.webp")),
             outcome(lambda: st.read("k.webp")),
             outcome(lambda: tuple(st.fetch("k.webp"))),
             outcome(lambda: st.stat("k.webp").mtime),
             outcome(lambda: st.delete("k.webp")),
             outcome(lambda: st.has("k.webp")),
             outcome(lambda: st.delete("k.webp")),
             outcome(lambda: st.read("missing.jpg"))]
    steps = [(kind, (value[0], value[1].mtime) if isinstance(value, tuple)
              and len(value) == 2 and hasattr(value[1], "mtime") else value)
             for kind, value in steps]
    return steps, list(client.calls)


def test_s3_roundtrip_alike(monkeypatch):
    steps, calls = s3(monkeypatch, _roundtrip)
    assert steps[3] == ("ok", stand_in.NOW.timestamp())
    assert steps[-1] == ("raise", "S3NotFound")
    assert calls[:3] == ["head", "get", "head"]


def test_gcs_roundtrip_alike(monkeypatch):
    steps, calls = gcs(monkeypatch, _roundtrip)
    assert steps[3] == ("ok", stand_in.NOW.timestamp())
    assert all(kwargs == {} for _op, kwargs in calls)


def test_s3_single_round_trips_alike(monkeypatch):
    """A write is a put and its stamp's head, a hit one get."""
    def script(st, client):
        wrote = st.write("w.webp", b"x")
        after_write = list(client.calls)
        client.calls.clear()
        got = st.fetch("w.webp")
        return wrote, after_write, got[0], got[1].mtime, list(client.calls)

    assert s3(monkeypatch, script) == (stand_in.NOW.timestamp(), ["put", "head"], b"x",
                                       stand_in.NOW.timestamp(), ["get"])


class Throttled(Exception):
    response = {"Error": {"Code": "SlowDown"}}


class Denied(Exception):
    response = {"Error": {"Code": "AccessDenied"}}


def test_s3_errors_discriminated_alike(monkeypatch):
    """Throttling propagates from stat, fetch and has; a 403 reads as a
    miss everywhere, with one warning for the first swallowed GetObject."""
    def script(st, client):
        def throttle(Bucket, Key):  # noqa: N803
            raise Throttled("503")

        def deny(Bucket, Key):  # noqa: N803
            raise Denied("denied")

        client.head_object = client.get_object = throttle
        throttled = [outcome(lambda: st.stat("k")), outcome(lambda: st.fetch("k")),
                     outcome(lambda: st.has("k"))]
        client.head_object = client.get_object = deny
        logger = PACKAGES["jax" if type(st).__module__.startswith("flyimg_tpu.") else
                          "torch"][2]
        with warnings_of(logger) as records:
            denied = [outcome(lambda: st.stat("k")), outcome(lambda: st.has("k")),
                      outcome(lambda: st.fetch("k")), outcome(lambda: st.fetch("k"))]
        return throttled, denied, len(records), all("403" in r for r in records)

    got = s3(monkeypatch, script)
    assert got[0] == [("raise", "Throttled")] * 3
    assert got[1] == [("ok", None), ("ok", False), ("ok", None), ("ok", None)]
    assert got[2:] == (1, True)


def test_s3_write_survives_a_throttled_stamp_alike(monkeypatch):
    def script(st, client):
        def throttle(Bucket, Key):  # noqa: N803
            raise Throttled("503")

        client.head_object = throttle
        wrote = st.write("t.webp", b"x")
        return wrote is not None, client.blobs["t.webp"]

    assert s3(monkeypatch, script) == (True, b"x")


def test_gcs_errors_discriminated_alike(monkeypatch):
    """A GCS 403 and an outage both propagate; only 404 is a miss."""
    class Outage(Exception):
        code = 503

    class Forbidden(Exception):
        code = 403

    def script(st, bucket):
        def boom(name, **_kw):
            raise Outage("503")

        def deny(name, **_kw):
            raise Forbidden("403")

        bucket.get_blob = boom
        out = [outcome(lambda: st.stat("k")), outcome(lambda: st.fetch("k"))]
        bucket.get_blob = deny
        out.append(outcome(lambda: st.stat("k")))
        return out

    assert gcs(monkeypatch, script) == [("raise", "Outage")] * 2 + [("raise", "Forbidden")]


@pytest.mark.parametrize("connect,read", [(0.0, 0.0), (2.5, 9.0), (2.5, 0.0), (0.0, 9.0)])
def test_s3_client_timeouts_alike(monkeypatch, connect, read):
    """The split timeouts reach boto3 as one botocore Config, and with both
    at 0 no Config is built at all."""
    conf = {**stand_in.S3_CONF, "storage_connect_timeout_s": connect,
            "storage_read_timeout_s": read}
    seen = {}
    for name, (cls, make, _l) in PACKAGES.items():
        kwargs, _made = stand_in.install_boto3(monkeypatch)
        make(cls(dict(conf)))
        config = kwargs[-1].get("config")
        seen[name] = (sorted(k for k in kwargs[-1] if k != "config"),
                      None if config is None else config.kwargs)
    assert seen["torch"] == seen["jax"]
    want = {k: v for k, v in (("connect_timeout", connect), ("read_timeout", read)) if v > 0}
    assert seen["torch"][1] == (want or None)


@pytest.mark.parametrize("connect,read", [(0.0, 0.0), (2.0, 8.0), (0.0, 8.0), (2.0, 0.0)])
def test_gcs_call_timeouts_alike(monkeypatch, connect, read):
    conf = {**stand_in.GCS_CONF, "storage_connect_timeout_s": connect,
            "storage_read_timeout_s": read}

    def script(st, bucket):
        st.write("k.webp", b"x")
        st.has("k.webp")
        st.read("k.webp")
        st.stat("k.webp")
        st.delete("k.webp")
        return list(bucket.calls)

    calls = gcs(monkeypatch, script, conf)
    want = ({"timeout": (connect, read)} if connect and read
            else {"timeout": connect or read} if connect or read else {})
    assert calls and all(kwargs == want for _op, kwargs in calls)


def test_handler_round_trips_on_s3_alike(monkeypatch, tmp_path):
    """Through each package's handler on an S3 store: a miss costs a get,
    a put and the stamp's head, a hit one get, and both stamp the answer
    with the object's own LastModified."""
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu_torch.service.handler import ImageHandler

    rng = np.random.default_rng(2)
    src = tmp_path / "s3src.png"
    src.write_bytes(png.encode(rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)))
    seen = {}
    for name, (cls, make, _l) in PACKAGES.items():
        _kw, made = stand_in.install_boto3(monkeypatch)
        store = make(cls(dict(stand_in.S3_CONF)))
        client = made[-1]
        params = cls({"tmp_dir": str(tmp_path / name)})
        handler = (JImageHandler(store, params) if name == "jax"
                   else ImageHandler(params, device="cpu", storage=store))
        miss = handler.process_image("w_40,o_png", str(src))
        miss_calls = list(client.calls)
        client.calls.clear()
        hit = handler.process_image("w_40,o_png", str(src))
        seen[name] = (miss.from_cache, miss_calls, miss.modified_at,
                      hit.from_cache, list(client.calls), hit.modified_at)
    assert seen["torch"] == seen["jax"] == (
        False, ["get", "put", "head"], stand_in.NOW.timestamp(),
        True, ["get"], stand_in.NOW.timestamp())
