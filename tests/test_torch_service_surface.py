"""The PyTorch package's HTTP surface held against the JAX package's aiohttp
app (built as tests/test_http.py builds it), both on the CPU with the same
parameters and the same requests: the homepage, the ``/path`` URL text,
``/readyz`` before and during the drain, ``/metrics`` (family names, label
sets, request and cache counts), the 304 answer, ``traceparent`` echoed,
the span names of an ``/upload`` trace, the debug gates, route overrides
and unknown route names, and the ``encrypt`` and ``prune`` subcommands.

The debug routes of brownout, the device supervisor, telemetry and the
autotuner answer as the JAX app's (200, the same keys; the autotuner's
document equal), and ``/debug/plans`` has the JAX app's keys, the program
caches' among them; the fleet tier's routes (``/debug/tier``,
``/debug/fleet``, ``/debug/fleet/status``) answer the JAX app's documents.
Departures pinned here (ROADMAP Queue C): the families of what the port does
not carry (the codec pools' busy ratio, the boot backend) are absent."""

import asyncio
import io
import json
import os
import re
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.exceptions import InvalidArgumentException as JInvalidArgument
from flyimg_tpu.service.app import make_app
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.exceptions import InvalidArgumentException
from flyimg_tpu_torch.service import app as tapp
from flyimg_tpu_torch.service.app import make_server, serve_in_thread

torch.set_num_threads(1)

INBOUND_TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
INBOUND = f"00-{INBOUND_TRACE}-00f067aa0ba902b7-01"


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = tmp_path_factory.mktemp("surface_src")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / 11.0 + c) * np.cos(xx / 17.0 - c)
                    for c in range(3)], -1) + rng.normal(0, 3, (120, 160, 3))
    path = root / "source.png"
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, "PNG")
    return str(path)


def _params(root, tag, **extra):
    base = {"upload_dir": str(root / f"{tag}_uploads"), "tmp_dir": str(root / f"{tag}_tmp"),
            "batch_deadline_ms": 1.0, "log_access": False}
    base.update(extra)
    return base


def jax_session(params, requests):
    """The requests in order against one JAX app: (status, headers, body)
    each; "drain" runs the app's shutdown signal (readiness flips)."""

    async def go():
        app = make_app(JAppParameters(params))
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            for item in requests:
                if item == "drain":
                    await app.shutdown()
                    continue
                method, path, headers = item
                resp = await client.request(method, path, headers=headers or {},
                                            allow_redirects=False)
                out.append((resp.status, dict(resp.headers), await resp.read()))
        finally:
            await client.close()
        return out

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


def _fetch(base, method, path, headers):
    req = urllib.request.Request(base + path, method=method, headers=headers or {},
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def port_session(params, requests, server_hook=None):
    """The same against one port server ("drain": ``begin_drain``)."""
    server = make_server(AppParameters(params), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = []
    try:
        for item in requests:
            if item == "drain":
                server.begin_drain()
                continue
            out.append(_fetch(base, *item))
        if server_hook is not None:
            server_hook(server, base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return out


def _families(text):
    """{family: set of label sets} of a Prometheus render."""
    fams = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split(" ", 1)[0]
        fam, _, labels = name.partition("{")
        fam = re.sub(r"_(bucket|sum|count)$", "", fam)
        labels = frozenset(p.split("=", 1)[0]
                           for p in re.findall(r'(\w+="(?:[^"\\]|\\.)*")', labels)
                           if not p.startswith("le="))
        fams.setdefault(fam, set()).add(labels)
    return fams


def _shape(doc):
    """A JSON document's keys, nested."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    return type(doc).__name__ if doc is not None else None


def _sample(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split(" ")[1])
    return 0.0


#: families of modules the port does not carry (ROADMAP Queue C)
NOT_PORTED_FAMILIES = re.compile(r"flyimg_(host_pool_busy_ratio|boot_backend)")
#: the fleet tier's debug routes (its modules off here)
FLEET_ROUTES = ("/debug/tier", "/debug/fleet", "/debug/fleet/status")
#: the debug routes of the ported opt-in modules (off here)
MODULE_ROUTES = ("/debug/brownout", "/debug/device", "/debug/telemetry", "/debug/autotune")


def _main_requests(src):
    opts = "w_64,h_48,c_1,o_png"
    return [
        ("GET", "/", None),
        ("GET", "/readyz", None),
        ("GET", f"/upload/{opts}/{src}", {"traceparent": INBOUND}),
        ("GET", f"/upload/{opts}/{src}", None),
        ("GET", f"/path/{opts}/{src}", None),
        ("GET", "/nowhere", None),
        ("GET", f"/upload/w_64,h_48,c_1,smc_1,o_png/{src}", None),
        ("HEAD", f"/upload/{opts}/{src}", None),
        ("GET", "/debug/traces?limit=10", None),
        ("GET", "/debug/plans", None),
        ("GET", "/debug/slo", None),
        ("GET", "/debug/perf", None),
        ("GET", "/debug/flightrecorder", None),
        ("GET", "/debug/memory", None),
        ("GET", "/debug/profile", None),
        ("GET", "/debug/profile/captures/nothing-here", None),
        ("GET", "/debug/traces/0123456789abcdef0123456789abcdef", None),
        ("GET", "/metrics", None),
        ("GET", "/metrics", {"Accept": "application/openmetrics-text"}),
        "drain",
        ("GET", "/readyz", None),
        ("GET", "/healthz", None),
    ] + [("GET", r, None) for r in FLEET_ROUTES + MODULE_ROUTES]


@pytest.fixture(scope="module")
def main_sessions(tmp_path_factory, source):
    root = tmp_path_factory.mktemp("surface_main")
    reqs = _main_requests(source)
    traces = {}

    def hook(server, base):
        # the upload's kept trace, read back through the debug route
        for summary in server.tracer.list(limit=100):
            status, _h, body = _fetch(base, "GET", f"/debug/traces/{summary['trace_id']}", None)
            assert status == 200
            traces[summary["trace_id"]] = json.loads(body)

    # an objective and a slow bar no CPU render reaches: a breach (and its
    # dump) or a "slow" keep would depend on each package's timing
    slo = {"slo_latency_p99_ms": 1e7, "tracing_slow_threshold_s": 1e6}
    jax = jax_session(_params(root, "jax", debug=True, **slo), reqs)
    port = port_session(_params(root, "port", debug=True, **slo), reqs, hook)
    return dict(zip(range(len(jax)), zip(jax, port))), traces


def test_homepage_and_readiness(main_sessions):
    pairs, _ = main_sessions
    (js, jh, jb), (ts, th, tb) = pairs[0]
    assert ts == js == 200
    assert jh["Content-Type"].startswith("text/html") and th["Content-Type"].startswith("text/html")
    assert b"flyimg" in tb and b"PyTorch" in tb
    for idx, want in ((1, 200), (19, 503)):
        (js, jh, jb), (ts, th, tb) = pairs[idx]
        assert ts == js == want
        assert json.loads(tb) == json.loads(jb)
        assert th["Content-Type"] == jh["Content-Type"]
    # liveness stays up while draining
    assert pairs[20][0][0] == pairs[20][1][0] == 200


def test_uploads_path_and_head_answer_alike(main_sessions, source):
    pairs, _ = main_sessions
    for idx in (2, 3, 6):
        (js, jh, jb), (ts, th, tb) = pairs[idx]
        assert ts == js == 200
        assert th["Content-Type"] == jh["Content-Type"] == "image/png"
        got = np.asarray(Image.open(io.BytesIO(tb)).convert("RGB")).astype(int)
        ref = np.asarray(Image.open(io.BytesIO(jb)).convert("RGB")).astype(int)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1
    (js, jh, jb), (ts, th, tb) = pairs[4]
    assert ts == js == 200 and th["Content-Type"] == jh["Content-Type"]
    jurl, turl = jb.decode(), tb.decode()
    assert re.sub(r"^http://[^/]+", "", turl) == re.sub(r"^http://[^/]+", "", jurl)
    assert "/uploads/" in turl and turl.startswith("http://127.0.0.1:")
    (js, jh, jb), (ts, th, tb) = pairs[7]
    assert ts == js == 200 and tb == jb == b""
    assert th["Content-Length"] != "0"
    (js, _jh, _jb), (ts, _th, _tb) = pairs[5]
    assert ts == js == 404


def test_traceparent_is_echoed_and_adopted(main_sessions):
    pairs, traces = main_sessions
    for idx in (2, 3, 4):
        (_js, jh, _jb), (_ts, th, _tb) = pairs[idx]
        for headers in (jh, th):
            m = re.fullmatch(r"00-([0-9a-f]{32})-([0-9a-f]{16})-01", headers["traceparent"])
            assert m is not None
            assert (m.group(1) == INBOUND_TRACE) == (idx == 2)
        # debug on: the stage split rides Server-Timing in both
        assert "total;dur=" in jh["Server-Timing"] and "total;dur=" in th["Server-Timing"]
    (_js, jh, _jb), (_ts, th, _tb) = pairs[0]
    assert "traceparent" not in jh and "traceparent" not in th


def _span_names(tree):
    names = set()
    stack = list(tree["spans"])
    while stack:
        span = stack.pop()
        names.add(span["name"])
        stack.extend(span["children"])
    return names


def test_kept_traces_list_alike(main_sessions):
    """/debug/traces lists the same pipeline requests (routes, statuses,
    span counts) newest first; the miss adopted the inbound trace id and
    holds the shared device span under its batch_wait."""
    pairs, traces = main_sessions
    jax_list = json.loads(pairs[8][0][2])["traces"]
    port_list = json.loads(pairs[8][1][2])["traces"]
    assert len(port_list) == len(jax_list) == 5
    for key in ("route", "http_status", "status", "n_spans", "name"):
        assert [t[key] for t in port_list] == [t[key] for t in jax_list], key
    miss = traces[INBOUND_TRACE]
    assert {"request", "fetch", "storage", "decode", "batch_wait",
            "device_execute", "encode"} <= _span_names(miss)
    stack = list(miss["spans"])
    while stack:
        span = stack.pop()
        if span["name"] == "batch_wait":
            assert [c["name"] for c in span["children"]] == ["device_execute"]
            device = span["children"][0]["attributes"]
            assert device["batch.controller"] == "device" and device["batch.occupancy"] == 1
            assert {"device.h2d_s", "device.dispatch_s", "device.sync_s"} <= set(device)
        stack.extend(span["children"])


def test_upload_span_name_sets_match(tmp_path, source):
    """Span names of each /upload and /path trace, as sets, per request."""
    reqs = [("GET", f"/upload/w_64,h_48,c_1,o_png/{source}", None),
            ("GET", f"/upload/w_64,h_48,c_1,o_png/{source}", None),
            ("GET", f"/upload/w_64,h_48,c_1,smc_1,o_png/{source}", None),
            ("GET", f"/path/w_80,o_png/{source}", None)]
    names = {}

    def collect(fetch):
        out = []
        for status, headers, _body in fetch:
            trace_id = headers["traceparent"].split("-")[1]
            out.append(trace_id)
        return out

    async def jax_names():
        app = make_app(JAppParameters(_params(tmp_path, "jax", debug=True)))
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            results = []
            for method, path, headers in reqs:
                resp = await client.request(method, path)
                await resp.read()
                results.append((resp.status, dict(resp.headers), b""))
            trees = []
            for trace_id in collect(results):
                resp = await client.get(f"/debug/traces/{trace_id}")
                trees.append(_span_names(json.loads(await resp.read())))
            return trees
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        names["jax"] = loop.run_until_complete(jax_names())
    finally:
        loop.close()

    def hook(server, base):
        trees = []
        for trace_id in collect(results):
            _s, _h, body = _fetch(base, "GET", f"/debug/traces/{trace_id}", None)
            trees.append(_span_names(json.loads(body)))
        names["port"] = trees

    results = []
    server = make_server(AppParameters(_params(tmp_path, "port", debug=True)), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for item in reqs:
            results.append(_fetch(base, *item))
        hook(server, base)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert names["port"] == names["jax"]


def test_metrics_families_and_counts(main_sessions):
    pairs, _ = main_sessions
    for idx in (17, 18):
        (js, jh, jb), (ts, th, tb) = pairs[idx]
        assert ts == js == 200
        assert th["Content-Type"] == jh["Content-Type"]
        jtext, ttext = jb.decode(), tb.decode()
        assert ttext.endswith("# EOF\n") == jtext.endswith("# EOF\n") == (idx == 18)
        jfam, tfam = _families(jtext), _families(ttext)
        missing = {f for f in jfam if f not in tfam}
        assert all(NOT_PORTED_FAMILIES.match(f) for f in missing), sorted(missing)
        assert set(tfam) <= set(jfam), sorted(set(tfam) - set(jfam))
        for fam in tfam:
            assert tfam[fam] == jfam[fam], fam
        for name in ('flyimg_requests_total{route="upload",status="200"}',
                     'flyimg_requests_total{route="path",status="200"}',
                     'flyimg_requests_total{route="unmatched",status="404"}',
                     'flyimg_requests_total{route="index",status="200"}',
                     'flyimg_cache_total{result="hit"}',
                     'flyimg_cache_total{result="miss"}',
                     "flyimg_batches_total", "flyimg_images_processed_total",
                     'flyimg_traces_total{kept="sampled"}'):
            assert _sample(ttext, name) == _sample(jtext, name), name
        assert _sample(ttext, 'flyimg_requests_total{route="upload",status="200"}') == 4


def test_debug_routes_with_debug_on(main_sessions):
    pairs, _ = main_sessions
    for idx in range(9, 17):
        (js, _jh, jb), (ts, _th, tb) = pairs[idx]
        assert ts == js, idx
    jplans, tplans = json.loads(pairs[9][0][2]), json.loads(pairs[9][1][2])
    assert set(jplans) == set(tplans)
    assert set(tplans["program_cache"]) == set(jplans["program_cache"]) == {"single", "batched"}
    for kind in ("single", "batched"):
        assert set(tplans["program_cache"][kind]) == set(jplans["program_cache"][kind])
    assert set(json.loads(pairs[10][1][2])) == set(json.loads(pairs[10][0][2]))
    assert set(json.loads(pairs[11][1][2])) == set(json.loads(pairs[11][0][2]))
    jfr, tfr = json.loads(pairs[12][0][2]), json.loads(pairs[12][1][2])
    assert set(tfr) == set(jfr)
    # host_stage rows record queue waits past 5 ms: timing, not launches
    assert [r["kind"] for r in tfr["records"] if r["kind"] != "host_stage"] == \
        [r["kind"] for r in jfr["records"] if r["kind"] != "host_stage"]
    assert set(json.loads(pairs[13][1][2])) == set(json.loads(pairs[13][0][2]))
    assert set(json.loads(pairs[14][1][2])) == set(json.loads(pairs[14][0][2]))
    # the fleet tier's routes answer alike: the same document, but for the
    # age of the tier supervisor's state and the replica's own identity
    for k, route in enumerate(FLEET_ROUTES):
        (js, _jh, jb), (ts, _th, tb) = pairs[21 + k]
        assert js == ts == 200, route
        assert _shape(json.loads(tb)) == _shape(json.loads(jb)), route
        jdoc, tdoc = json.loads(jb), json.loads(tb)
        for doc in (jdoc, tdoc):
            doc.pop("state_age_s", None)
        assert tdoc == jdoc, route
    # the ported modules' routes answer alike
    for k, route in enumerate(MODULE_ROUTES):
        (js, _jh, jb), (ts, _th, tb) = pairs[21 + len(FLEET_ROUTES) + k]
        assert js == ts == 200, route
        assert set(json.loads(tb)) == set(json.loads(jb)), route
        if route == "/debug/autotune":      # off in both: the same document
            assert json.loads(tb) == json.loads(jb)


@pytest.mark.parametrize("debug", [False, True])
def test_debug_gates(tmp_path, debug):
    reqs = [("GET", "/debug/trace?ms=1", None), ("GET", "/debug/traces", None),
            ("GET", "/debug/traces/abc", None), ("GET", "/debug/slo", None),
            ("GET", "/debug/perf", None), ("GET", "/debug/plans", None),
            ("GET", "/debug/flightrecorder", None), ("GET", "/debug/profile", None),
            ("POST", "/debug/profile?batches=0", None),
            ("GET", "/debug/profile/captures/x", None), ("GET", "/debug/memory", None),
            ("GET", "/debug/trace?ms=-1", None), ("GET", "/debug/traces?limit=x", None)]
    if not debug:
        reqs.append(("POST", "/debug/profile?batches=2", None))
    jax = jax_session(_params(tmp_path, "jax", debug=debug), reqs)
    port = port_session(_params(tmp_path, "port", debug=debug), reqs)
    for (js, _jh, jb), (ts, _th, tb), req in zip(jax, port, reqs):
        if debug and req[1].startswith("/debug/trace?ms=1"):
            # the JAX capture runs jax.profiler, the port's torch.profiler
            assert ts == js == 200
            assert set(json.loads(tb)) == set(json.loads(jb))
            continue
        assert ts == js, req
        if ts in (403, 400):
            assert tb == jb, req


def test_profile_arm_and_download(tmp_path, source):
    """POST /debug/profile arms a batch-scoped capture; two renders finish
    it; it is listed and downloads as a tar.gz holding a Chrome trace with
    the batch ranges; a second arm while one is armed answers 409."""
    import tarfile

    def hook(server, base):
        status, _h, body = _fetch(base, "POST", "/debug/profile?batches=1", None)
        assert status == 200 and json.loads(body)["armed"]
        assert _fetch(base, "POST", "/debug/profile?batches=1", None)[0] == 409
        assert _fetch(base, "GET", "/debug/trace?ms=5", None)[0] == 409
        assert _fetch(base, "GET", f"/upload/w_50,o_png/{source}", None)[0] == 200
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            state = json.loads(_fetch(base, "GET", "/debug/profile", None)[2])
            if state["captures"] and not state["active"]:
                break
            time.sleep(0.05)
        assert state["last_error"] is None and state["captures_total"] == 1
        name = state["captures"][0]["name"]
        status, headers, blob = _fetch(base, "GET", f"/debug/profile/captures/{name}", None)
        assert status == 200 and headers["Content-Type"] == "application/gzip"
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            member = tar.extractfile(f"{name}/trace.json")
            doc = json.load(member)
        ids = {e["name"] for e in doc["traceEvents"]
               if str(e.get("name", "")).startswith("flyimg:batch:")}
        recorded = {f"flyimg:batch:{r['batch_id']}" for r in server.flight_recorder.snapshot()["records"]}
        assert ids and ids <= recorded
        assert _fetch(base, "GET", "/debug/profile/captures/..%2F..%2Fetc", None)[0] == 404

    port_session(_params(tmp_path, "port", debug=True), [], hook)


def test_not_modified_answers_alike(tmp_path, source):
    """If-None-Match with each app's own ETag: 304, the same header names
    of NOT_MODIFIED_HEADERS, an empty body."""
    from flyimg_tpu.service.response import NOT_MODIFIED_HEADERS as JNMH
    from flyimg_tpu_torch.service.response import NOT_MODIFIED_HEADERS

    assert NOT_MODIFIED_HEADERS == JNMH
    path = f"/upload/w_40,h_30,c_1,o_png/{source}"
    answers = {}

    async def jax_go():
        app = make_app(JAppParameters(_params(tmp_path, "jax")))
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            first = await client.get(path)
            await first.read()
            again = await client.get(path, headers={"If-None-Match": first.headers["ETag"]})
            return again.status, dict(again.headers), await again.read()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        answers["jax"] = loop.run_until_complete(jax_go())
    finally:
        loop.close()

    def hook(server, base):
        _s, headers, _b = _fetch(base, "GET", path, None)
        answers["port"] = _fetch(base, "GET", path, {"If-None-Match": headers["ETag"]})

    port_session(_params(tmp_path, "port"), [], hook)
    (js, jh, jb), (ts, th, tb) = answers["jax"], answers["port"]
    jh = {k.lower(): v for k, v in jh.items()}
    th = {k.lower(): v for k, v in th.items()}
    assert ts == js == 304 and tb == jb == b""
    assert {k for k in NOT_MODIFIED_HEADERS if k.lower() in th} == \
        {k for k in NOT_MODIFIED_HEADERS if k.lower() in jh} == {
            "ETag", "Cache-Control", "Expires", "Last-Modified"}
    assert th["cache-control"] == jh["cache-control"]
    assert "content-type" not in th and "content-type" not in jh
    # a departure (ROADMAP Queue C 20): the stdlib server states the empty
    # body's length, aiohttp sends none
    assert th["content-length"] == "0" and "content-length" not in jh


def test_readyz_answers_503_during_server_close_drain(tmp_path):
    """server_close flips readiness before it drains the batchers, while
    the listener still answers."""
    seen = []
    server = make_server(AppParameters(_params(tmp_path, "port")), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    assert _fetch(base, "GET", "/readyz", None)[0] == 200
    close = server.batcher.close

    def probing_close(timeout):
        seen.append(_fetch(base, "GET", "/readyz", None)[:1])
        close(timeout)

    server.batcher.close = probing_close
    server.server_close()
    thread.join(timeout=10)
    assert seen == [(503,)]
    assert not thread.is_alive()


@pytest.mark.parametrize("routes,path_ok,path_gone", [
    ({"upload": "/img/{options}/{imageSrc:.+}"}, "/img/w_30,o_png/", "/upload/w_30,o_png/"),
    ({"path": "/where/{options}/{imageSrc:.+}"}, "/where/w_30,o_png/", "/path/w_30,o_png/"),
])
def test_route_overrides(tmp_path, source, routes, path_ok, path_gone):
    reqs = [("GET", path_ok + source, None), ("GET", path_gone + source, None)]
    jax = jax_session(_params(tmp_path, "jax", routes=routes), reqs)
    port = port_session(_params(tmp_path, "port", routes=routes), reqs)
    assert [a[0] for a in port] == [a[0] for a in jax] == [200, 404]
    # the logical name keeps the trace and the metric label
    assert "traceparent" in port[0][1] and "traceparent" in jax[0][1]


@pytest.mark.parametrize("routes", [
    {"thumbnail": "/t/{options}/{imageSrc:.+}"},
    {"upload": "/upload/{imageSrc:.+}"},
    {"path": "/path/{options}"},
])
def test_bad_route_config_raises_when_made(tmp_path, routes):
    with pytest.raises(JInvalidArgument):
        make_app(JAppParameters(_params(tmp_path, "jax", routes=routes)))
    with pytest.raises(InvalidArgumentException):
        make_server(AppParameters(_params(tmp_path, "port", routes=routes)), device="cpu")


@pytest.mark.parametrize("payload", ["w_300,h_250,c_1/https://example.com/a.jpg",
                                     "o_jpg/https://e.x/ä ö.png", "x/y"])
def test_encrypt_subcommand(tmp_path, capsys, payload):
    from flyimg_tpu.service.app import main as jmain

    params = tmp_path / "params.json"
    params.write_text(json.dumps({"security_key": "sk", "security_iv": "si"}))
    assert jmain(["encrypt", payload, "--params", str(params)]) == 0
    jax_out = capsys.readouterr().out
    assert tapp.main(["encrypt", payload, "--params", str(params)]) == 0
    assert capsys.readouterr().out == jax_out


@pytest.mark.parametrize("max_bytes", [0, 3000, 10 ** 9])
def test_prune_subcommand(tmp_path, capsys, max_bytes):
    from flyimg_tpu.service.app import main as jmain

    rng = np.random.default_rng(max_bytes % 97)
    seed_dir = tmp_path / "seed"
    seed_dir.mkdir()
    now = time.time()
    for i in range(12):
        f = seed_dir / f"{i:032x}.png"
        f.write_bytes(rng.integers(0, 255, int(rng.integers(100, 900)), dtype=np.uint8).tobytes())
        os.utime(f, (now - 100 * i, now - 100 * i))
    out = {}
    for tag, main in (("jax", jmain), ("port", tapp.main)):
        root = tmp_path / tag
        shutil.copytree(seed_dir, root)
        for f in seed_dir.iterdir():
            st = f.stat()
            os.utime(root / f.name, (st.st_atime, st.st_mtime))
        params = tmp_path / f"{tag}.json"
        params.write_text(json.dumps({"upload_dir": str(root)}))
        assert main(["prune", "--max-bytes", str(max_bytes), "--params", str(params)]) == 0
        out[tag] = (json.loads(capsys.readouterr().out), sorted(os.listdir(root)))
    assert out["port"] == out["jax"]
