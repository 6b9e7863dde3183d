"""Signed URLs and domain restrictions of the PyTorch package, held against
the JAX package: tokens either package mints decrypt in the other and the
port's tokens are the JAX ones string for string; the port's own
AES-256-CBC equals ``cryptography``'s; both SecurityHandlers answer the
same value or raise the same class on the cases of tests/test_security.py;
and both handlers answer signed, unsigned, wrong-token, foreign-domain and
whitelisted requests with the same status, the same error bodies, and the
same pixels (within 1 u8 level, as the port's other handler tests hold
renders) for the 200 answers."""

import functools
import io
import random
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from PIL import Image

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.exceptions import AppException as JAppException
from flyimg_tpu.service import security as jsec
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.exceptions import AppException
from flyimg_tpu_torch.service import aes
from flyimg_tpu_torch.service import security as tsec
from flyimg_tpu_torch.service.app import error_status
from flyimg_tpu_torch.service.handler import ImageHandler

torch.set_num_threads(1)

_ALPHABET = ("abcdefghijklmnopqrstuvwxyz0123456789_,/:.-%"
             "äöüßéèçñ€漢字🙂")


def _payloads():
    """A seeded corpus of 0..300-byte payloads: every length around a
    block boundary and random ones, ASCII and non-ASCII."""
    rng = random.Random(20240)
    out = [""]
    for n in list(range(1, 40)) + [47, 48, 49, 63, 64, 65, 127, 128, 129, 255, 256, 257]:
        out.append("".join(rng.choice(_ALPHABET[:43]) for _ in range(n)))
    while len(out) < 120:
        text = "".join(rng.choice(_ALPHABET) for _ in range(rng.randrange(1, 120)))
        while len(text.encode()) > 300:
            text = text[:-1]
        out.append(text)
    return out


KEYS = [("key", "iv"), ("sekret", "vector"), ("TestKey29", "TestIV042"),
        ("ключ-🔑", "вектор")]


@pytest.mark.parametrize("key,iv", KEYS)
def test_tokens_cross_decrypt_and_match_the_jax_strings(key, iv):
    for plain in _payloads():
        token = jsec.encrypt(plain, key, iv)
        assert tsec.encrypt(plain, key, iv) == token, plain
        assert tsec.decrypt(token, key, iv) == plain
        assert jsec.decrypt(tsec.encrypt(plain, key, iv), key, iv) == plain


@pytest.mark.parametrize("seed", range(8))
def test_aes_cbc_equals_cryptography(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        iv = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        data = rng.integers(0, 256, 16 * int(rng.integers(1, 20)),
                            dtype=np.uint8).tobytes()
        enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
        want = enc.update(data) + enc.finalize()
        assert aes.cbc_encrypt(key, iv, data) == want
        assert aes.cbc_decrypt(key, iv, want) == data


def test_aes_fips197_vector():
    """FIPS-197 appendix C.3 (AES-256, one block: CBC with a zero IV)."""
    got = aes.cbc_encrypt(bytes(range(32)), bytes(16),
                          bytes.fromhex("00112233445566778899aabbccddeeff"))
    assert got.hex() == "8ea2b7ca516745bfeafc49904b496089"


def _both(params, method, *args):
    """(outcome of the JAX handler, outcome of the port's): the answer, or
    the exception class's name and message."""
    outcomes = []
    for mod, app_params, exc_base in ((jsec, JAppParameters, JAppException),
                                      (tsec, AppParameters, AppException)):
        handler = mod.SecurityHandler(app_params(params))
        try:
            outcomes.append(("value", getattr(handler, method)(*args)))
        except exc_base as exc:
            outcomes.append(("raises", type(exc).__name__, str(exc)))
    return outcomes


_TOKEN = jsec.encrypt("w_200,h_100/https://a.b/c.jpg", "k", "v")
SECURITY_CASES = [
    ("disabled_passthrough", {"security_key": "", "security_iv": ""},
     "check_security_hash", ("w_1", "http://x/y.png")),
    ("roundtrip", {"security_key": "k", "security_iv": "v"},
     "check_security_hash", (_TOKEN, "ignored")),
    ("wrong_key", {"security_key": "other", "security_iv": "v"},
     "check_security_hash", (_TOKEN, "ignored")),
    ("missing_iv", {"security_key": "k", "security_iv": ""},
     "check_security_hash", ("whatever", "src")),
    ("garbage_token", {"security_key": "k", "security_iv": "v"},
     "check_security_hash", ("not-a-valid-token!!", "src")),
    ("token_without_source", {"security_key": "k", "security_iv": "v"},
     "check_security_hash", (jsec.encrypt("w_200", "k", "v"), "src")),
    ("partial_block", {"security_key": "k", "security_iv": "v"},
     "check_security_hash", ("QUJDRA==", "src")),
    ("restricted_ok", {"restricted_domains": True, "whitelist_domains": ["ok.com"]},
     "check_restricted_domains", ("https://ok.com/img.png",)),
    ("restricted_foreign", {"restricted_domains": True, "whitelist_domains": ["ok.com"]},
     "check_restricted_domains", ("https://evil.com/img.png",)),
    ("restricted_local_path", {"restricted_domains": True, "whitelist_domains": ["ok.com"]},
     "check_restricted_domains", ("/srv/img.png",)),
    ("restricted_not_a_list", {"restricted_domains": True, "whitelist_domains": "ok.com"},
     "check_restricted_domains", ("https://evil.com/img.png",)),
    ("restricted_disabled", {"restricted_domains": False},
     "check_restricted_domains", ("https://anything.net/x.jpg",)),
    ("encrypt", {"security_key": "sekret", "security_iv": "vector"},
     "encrypt", ("w_1/https://a.b/c.png",)),
    ("decrypt_wrong_iv", {"security_key": "sekret", "security_iv": "other"},
     "decrypt", (jsec.encrypt("w_1/https://a.b/c.png", "sekret", "vector"),)),
    ("encrypt_without_key", {"security_key": "", "security_iv": "v"},
     "encrypt", ("w_1/x",)),
]


@pytest.mark.parametrize("name,params,method,args", SECURITY_CASES,
                         ids=[c[0] for c in SECURITY_CASES])
def test_security_handlers_agree(name, params, method, args):
    jax_out, port_out = _both(params, method, *args)
    assert port_out == jax_out


# -- the repair: the handler checks both before it parses any option ----------


def _png_source(path):
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / 9.0 + c) * np.cos(xx / 13.0 - c)
                    for c in range(3)], -1)
    img += rng.normal(0, 3, img.shape)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, "PNG")
    return str(path)


@pytest.fixture(scope="module")
def origin(tmp_path_factory):
    """A localhost HTTP origin serving the source PNG."""
    root = tmp_path_factory.mktemp("security_origin")
    _png_source(root / "origin.png")
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        functools.partial(SimpleHTTPRequestHandler, directory=str(root)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/origin.png", str(root / "origin.png")
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _answer(handler, options, src, status_of):
    try:
        result = handler.process_image(options, src)
    except Exception as exc:
        return status_of(exc), f"{type(exc).__name__}: {exc}".encode()
    return 200, result.content


def _jax_status(exc):
    from flyimg_tpu.service.app import _ERROR_STATUS

    for cls, code in _ERROR_STATUS.items():
        if isinstance(exc, cls):
            return code
    return 500


def _handlers(tmp_path, tag, extra):
    from flyimg_tpu.service.handler import ImageHandler as JImageHandler
    from flyimg_tpu.storage import make_storage

    base = {"batch_deadline_ms": 1.0}
    base.update(extra)
    jparams = JAppParameters({**base, "upload_dir": str(tmp_path / f"ju_{tag}"),
                              "tmp_dir": str(tmp_path / f"jt_{tag}")})
    tparams = AppParameters({**base, "upload_dir": str(tmp_path / f"tu_{tag}"),
                             "tmp_dir": str(tmp_path / f"tt_{tag}")})
    return (JImageHandler(make_storage(jparams), jparams),
            ImageHandler(tparams, device="cpu"))


SIGNED = {"security_key": "flyimg-key", "security_iv": "flyimg-iv"}
RESTRICTED = {"restricted_domains": True, "whitelist_domains": ["127.0.0.1"]}
OPTS = "w_64,h_48,c_1,o_png"


def _requests(origin_url, local_src):
    token = jsec.encrypt(f"{OPTS}/{local_src}", **{
        "security_key": SIGNED["security_key"], "security_iv": SIGNED["security_iv"]})
    wrong = jsec.encrypt(f"{OPTS}/{local_src}", "another-key", SIGNED["security_iv"])
    foreign_token = jsec.encrypt(f"{OPTS}/http://evil.example/x.png", **{
        "security_key": SIGNED["security_key"], "security_iv": SIGNED["security_iv"]})
    return [
        ("unsigned", {}, OPTS, local_src),
        ("signed", SIGNED, token, "ignored-source"),
        ("signed_plain_options", SIGNED, OPTS, local_src),
        ("wrong_token", SIGNED, wrong, "ignored-source"),
        ("foreign_domain", RESTRICTED, OPTS, "http://evil.example/x.png"),
        ("whitelisted_domain", RESTRICTED, OPTS, origin_url),
        ("signed_foreign_domain", {**SIGNED, **RESTRICTED}, foreign_token, "x"),
    ]


def _decoded(body):
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB")).astype(int)


def test_handlers_answer_security_requests_alike(tmp_path, origin):
    """Status, error bodies and pixels agree for every request; a signed
    answer is byte-equal to the unsigned one of the same package. Before
    the port checked security, its signed request parsed the token as
    options and failed where the JAX handler answered 200, and its foreign
    domain was fetched where the JAX handler answered 403."""
    origin_url, local_src = origin
    answers = {}
    for tag, extra, options, src in _requests(origin_url, local_src):
        jh, th = _handlers(tmp_path, tag, extra)
        jstatus, jbody = _answer(jh, options, src, _jax_status)
        tstatus, tbody = _answer(th, options, src, error_status)
        assert tstatus == jstatus, (tag, tbody[:200], jbody[:200])
        if jstatus == 200:
            a, b = _decoded(tbody), _decoded(jbody)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, tag
        else:
            assert tbody == jbody, tag
        answers[tag] = (jstatus, jbody, tstatus, tbody)
    assert answers["signed"][0] == 200
    assert answers["signed"][1] == answers["unsigned"][1]
    assert answers["signed"][3] == answers["unsigned"][3]
    for tag in ("wrong_token", "foreign_domain", "signed_foreign_domain",
                "signed_plain_options"):
        assert answers[tag][2] == 403, tag
    assert answers["whitelisted_domain"][2] == 200
