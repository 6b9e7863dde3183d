"""The port's split fetch timeouts (flyimg_tpu_torch/service/input_source.py
``FetchPolicy.timeouts``, ``_http_fetch_once``) held against the JAX
policy's (flyimg_tpu/service/input_source.py ``httpx_timeout``):

- on the same parameters and caps, the connect, read, write and pool
  timeouts equal the JAX policy's ``httpx.Timeout`` fields;
- the connection is made under the connect timeout (a patched
  ``socket.create_connection`` records it), and a refused one is a
  transient ``URLError``, retried;
- an origin that accepts the connection and then says nothing fails the
  fetch at the read timeout (a few tenths of a second), not at the connect
  cap; an answer served in time reads whole, and a redirect or a 404 is an
  ``HTTPError`` that is not followed.
"""

import http.server
import socket
import threading
import time
import urllib.error

import pytest

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.service.input_source import FetchPolicy as JFetchPolicy
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.service import input_source
from flyimg_tpu_torch.service.input_source import FetchPolicy, is_transient_fetch_error

PARAMS = [
    {},
    {"fetch_connect_timeout_s": 1.25, "fetch_read_timeout_s": 7.5,
     "fetch_write_timeout_s": 2.0},
    {"fetch_connect_timeout_s": 0.2, "fetch_read_timeout_s": 0.3},
]


@pytest.mark.parametrize("cap", [None, 0.1, 2.5, 60.0])
@pytest.mark.parametrize("params", PARAMS)
def test_policy_timeouts_equal_the_jax_policy(params, cap):
    ours = FetchPolicy.from_params(AppParameters(params)).timeouts(cap)
    theirs = JFetchPolicy.from_params(JAppParameters(params)).httpx_timeout(cap)
    assert ours == {"connect": theirs.connect, "read": theirs.read,
                    "write": theirs.write, "pool": theirs.pool}


def test_defaults_are_the_jax_defaults():
    ours, theirs = FetchPolicy(), JFetchPolicy()
    assert (ours.connect_timeout_s, ours.read_timeout_s, ours.write_timeout_s) == (
        theirs.connect_timeout_s, theirs.read_timeout_s, theirs.write_timeout_s) == (
        3.0, 10.0, 10.0)


def test_connect_runs_under_the_connect_timeout(monkeypatch):
    seen = []

    def refuse(address, timeout=None, source_address=None, **_kw):
        seen.append((address, timeout))
        raise ConnectionRefusedError("refused")

    monkeypatch.setattr(socket, "create_connection", refuse)
    policy = FetchPolicy.from_params(AppParameters({"fetch_connect_timeout_s": 1.25}))
    with pytest.raises(urllib.error.URLError) as err:
        input_source._http_fetch_once("http://127.0.0.1:9/a.png", {}, policy.timeouts())
    assert seen == [(("127.0.0.1", 9), 1.25)]
    assert is_transient_fetch_error(err.value)


class _Silent:
    """A listening socket that accepts connections and never answers."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.held = []
        self._stop = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        self.sock.settimeout(0.05)
        while not self._stop.is_set():
            try:
                self.held.append(self.sock.accept()[0])
            except OSError:
                continue

    def close(self):
        self._stop.set()
        for conn in self.held:
            conn.close()
        self.sock.close()


def test_a_stalled_origin_fails_at_the_read_timeout():
    origin = _Silent()
    policy = FetchPolicy.from_params(AppParameters({
        "fetch_connect_timeout_s": 3.0, "fetch_read_timeout_s": 0.3}))
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError) as err:
            input_source._http_fetch_once(
                f"http://127.0.0.1:{origin.port}/a.png", {}, policy.timeouts())
        took = time.monotonic() - t0
    finally:
        origin.close()
    assert 0.25 <= took < 2.0, took
    assert is_transient_fetch_error(err.value)


class _Origin(http.server.BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def do_GET(self):  # noqa: N802
        if self.path == "/moved":
            self.send_response(302)
            self.send_header("Location", "/body")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if self.path != "/body?x=1":
            self.send_error(404)
            return
        body = b"x" * 70000
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_answers_read_whole_and_redirects_are_not_followed():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Origin)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    timeouts = FetchPolicy().timeouts(5.0)
    try:
        assert input_source._http_fetch_once(f"{base}/body?x=1", {}, timeouts) == b"x" * 70000
        for path, code in (("/moved", 302), ("/nothing", 404)):
            with pytest.raises(urllib.error.HTTPError) as err:
                input_source._http_fetch_once(base + path, {}, timeouts)
            assert err.value.code == code and not is_transient_fetch_error(err.value)
    finally:
        server.shutdown()
        server.server_close()
