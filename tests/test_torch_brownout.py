"""The PyTorch package's brownout (flyimg_tpu_torch/runtime/brownout.py, the
handler's degraded paths, ``spec.plan.degrade_plan``,
``models/smartcrop.entropy_crop_image`` and the negative origin cache of
``service/input_source.py``) held against the JAX package's on the CPU:

- ``degrade_plan`` gives the JAX plan and modes for each option string, and
  ``entropy_crop_image`` the JAX array exactly, on seeded images;
- ``BrownoutEngine`` walks the same levels, transitions and counters for
  the same injected pressure script on an injected clock, and reads the
  same pressure from the same attached sources; ``NegativeCache`` and
  ``RefreshQueue`` answer the same scripts;
- the handlers, the JAX ``ImageHandler`` against the port's
  ``ImageHandler(device="cpu")`` with the level forced through the
  ``brownout.signal`` fault point: at BROWNOUT the same degraded modes,
  nothing stored, the same answer size and pixels within 1 u8 level (the
  port's resample against the JAX program, PERF.md section 2), and the
  same JPEG quantization tables under the quality clamp; at SHED a miss
  503 with the same Retry-After before any decode and a hit served; at
  DEGRADED a stale hit served with one background refresh for N hits;
- with brownout off under injected overload the answers and launches are
  the ones of a default server;
- the server: a dead origin answers 404 then 502 from the negative cache
  without a second fetch.
"""

import io
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from jax_fastcodec import fastcodec, use_in_jax  # noqa: F401

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.models import smartcrop as jsmartcrop
from flyimg_tpu.runtime import brownout as jbrownout
from flyimg_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from flyimg_tpu.service.handler import ImageHandler as JImageHandler
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu.spec.plan import degrade_plan as jdegrade_plan
from flyimg_tpu.storage.local import LocalStorage as JLocalStorage
from flyimg_tpu.testing import faults as jfaults
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.models import smartcrop
from flyimg_tpu_torch.runtime import brownout
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan, degrade_plan
from flyimg_tpu_torch.testing import faults

torch.set_num_threads(1)

#: u8 levels between the port's answer and the JAX package's (PERF.md 2)
PIXEL_TOL = 1


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()
    jfaults.clear()


class Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _pressure(box):
    """The same pressure script through both packages' injection points."""
    faults.install(faults.FaultInjector()).plan("brownout.signal", lambda **_: box[0])
    jfaults.install(jfaults.FaultInjector()).plan("brownout.signal", lambda **_: box[0])


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(yy / (19.0 + 7 * c)) * np.cos(xx / (31.0 - 5 * c))
                    for c in range(3)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the pure functions


DEGRADE_OPTIONS = [
    "w_300,h_250,c_1", "w_300,h_250,c_1,smc_1", "w_200,unsh_0.25x0.25+8+0.065",
    "w_200,sh_2x1", "w_200,blr_2x1", "w_120,h_90,c_1,sh_1x0.5,unsh_1x1+1+0.05,blr_1x1",
    "w_100,r_30,clsp_Gray,sh_0x1", "fb_1,w_64,unsh_0x2+1+0.1",
]


@pytest.mark.parametrize("opts", DEGRADE_OPTIONS)
def test_degrade_plan_matches_jax(opts):
    ours, our_modes = degrade_plan(build_plan(OptionsBag(opts), 640, 480))
    theirs, their_modes = jdegrade_plan(jbuild_plan(JOptionsBag(opts), 640, 480))
    assert our_modes == their_modes
    assert repr(ours) == repr(theirs)
    assert ours.sharpen is None and ours.unsharp is None
    assert (ours.blur, ours.smart_crop, ours.face_blur) == (
        theirs.blur, theirs.smart_crop, theirs.face_blur)


@pytest.mark.parametrize("h,w,seed,flat", [
    (250, 300, 1, False), (300, 250, 2, False), (250, 251, 3, False),
    (400, 64, 4, False), (64, 400, 5, False), (120, 120, 6, False),
    (250, 300, 7, True), (301, 99, 8, True), (9, 17, 9, False),
])
def test_entropy_crop_matches_jax(h, w, seed, flat):
    img = (np.full((h, w, 3), 77, np.uint8) if flat else _image(h, w, seed))
    ours, theirs = smartcrop.entropy_crop_image(img), jsmartcrop.entropy_crop_image(img)
    assert ours.shape == theirs.shape == (min(h, w), min(h, w), 3)
    assert np.array_equal(ours, theirs)


# ---------------------------------------------------------------------------
# the engine


ENGINE_SCRIPTS = {
    "escalate": [(0.0, 0), (0.7, 0), (0.9, 0), (2.0, 0), (0.0, 0)],
    "dwell_and_gap": [(0.9, 0), (0.0, 0), (0.7, 5.1), (0.1, 0), (0.1, 0), (0.1, 5.1)],
    "idle_walk": [(2.0, 0), (0.0, 3600.0), (0.61, 0), (0.58, 1.0), (0.61, 1.0)],
    "straddle": [(0.61 if i % 2 == 0 else 0.58, 1.0) for i in range(12)],
    "shed_and_back": [(1.2, 0), (1.0, 5.0), (0.5, 5.0), (0.0, 5.0), (0.0, 5.0), (0.3, 5.0)],
}


def _engines(clock, **over):
    kw = dict(enabled=True, degraded_at=0.6, brownout_at=0.85, shed_at=1.1,
              hysteresis=0.75, min_dwell_s=5.0, eval_interval_s=0.0)
    kw.update(over)
    ours = brownout.BrownoutEngine(clock=clock, metrics=MetricsRegistry(), **kw)
    theirs = jbrownout.BrownoutEngine(clock=clock, metrics=JMetricsRegistry(), **kw)
    return ours, theirs


@pytest.mark.parametrize("script", sorted(ENGINE_SCRIPTS))
def test_engine_transitions_match_jax(script):
    clock = Clock()
    ours, theirs = _engines(clock)
    box = [0.0]
    _pressure(box)
    seen = []
    for value, advance in ENGINE_SCRIPTS[script]:
        clock.now += advance
        box[0] = value
        got = (ours.evaluate(), theirs.evaluate())
        seen.append(got)
        assert got[0] == got[1], (script, seen)
        assert (ours.swr_active(), ours.plan_degrade_active(), ours.shed_active()) == (
            theirs.swr_active(), theirs.plan_degrade_active(), theirs.shed_active())
    a, b = ours.snapshot(), theirs.snapshot()
    assert a == b
    transitions = {k: v for k, v in ours._metrics.summary().items()
                   if k.startswith("flyimg_brownout_transitions_total")}
    assert transitions == {k: v for k, v in theirs._metrics.summary().items()
                           if k.startswith("flyimg_brownout_transitions_total")}


def test_engine_off_never_leaves_normal_in_both():
    clock = Clock()
    ours, theirs = _engines(clock, enabled=False)
    _pressure([5.0])
    assert ours.evaluate() == theirs.evaluate() == brownout.NORMAL
    assert not ours.swr_active() and not ours.plan_degrade_active() and not ours.shed_active()


class _Batcher:
    name = "device"

    class admission:
        pending = 32


class _Slo:
    enabled = True
    burn_threshold_fast = 14.4
    burn_threshold_slow = 6.0

    def burn_rate(self, window):
        return 7.2 if window == "fast" else 1.5


class _Pipeline:
    enabled = True

    def pressure(self):
        return 0.875


class _Supervisor:
    def cpu_forced(self):
        return True


@pytest.mark.parametrize("sources", [
    dict(batchers=(_Batcher(),)),
    dict(slo=_Slo()),
    dict(host_pipeline=_Pipeline()),
    dict(device_supervisor=_Supervisor()),
    dict(rss_fn=lambda: 0.93),
    dict(inflight_fn=lambda: 5.0, breaker_open_fn=lambda: 1.0),
    dict(inflight_fn=lambda: (_ for _ in ()).throw(RuntimeError("dead gauge"))),
])
def test_engine_pressure_components_match_jax(sources):
    ours, theirs = _engines(Clock(), queue_ref=64.0, inflight_ref=10.0, breaker_ref=4.0)
    ours.attach(**sources)
    theirs.attach(**sources)
    assert ours._components() == theirs._components()
    assert ours.pressure() == theirs.pressure()


def test_negative_cache_matches_jax():
    clock = Clock()
    ours, theirs = (brownout.NegativeCache(10.0, max_entries=4, clock=clock),
                    jbrownout.NegativeCache(10.0, max_entries=4, clock=clock))
    script = [
        ("add", "http://origin.example.com/img.jpg?v=1", False),
        ("hit", "http://u:p@origin.example.com/img.jpg?v=2", None),
        ("hit", "http://origin.example.com/other.jpg", None),
        ("add", "http://cdn.example.com/render?id=broken", True),
        ("hit", "http://cdn.example.com/render?id=broken", None),
        ("hit", "http://cdn.example.com/render?id=healthy", None),
        ("tick", 10.1, None),
        ("hit", "http://origin.example.com/img.jpg?v=1", None),
    ] + [("add", f"http://h{i}:81/p", False) for i in range(8)] + [
        ("hit", "http://h7:81/p", None), ("hit", "http://h0:81/p", None), ("len", None, None)]
    for op, arg, resource in script:
        if op == "add":
            ours.add(arg, "ConnectError", resource=resource)
            theirs.add(arg, "ConnectError", resource=resource)
            clock.now += 0.01
        elif op == "hit":
            assert ours.hit(arg) == theirs.hit(arg), arg
        elif op == "tick":
            clock.now += arg
        else:
            assert len(ours) == len(theirs)
    off = brownout.NegativeCache(0.0)
    off.add("http://x/y", "e")
    assert off.hit("http://x/y") is None and not off.enabled


def test_refresh_queue_matches_jax():
    answers = []
    for mod in (brownout, jbrownout):
        q = mod.RefreshQueue(max_pending=2)
        gate, ran = threading.Event(), []

        def slow(key, ran=ran, gate=gate):
            def fn():
                gate.wait(timeout=30)
                ran.append(key)
            return fn

        got = [q.submit("a", slow("a")), q.submit("a", slow("a")),
               q.submit("b", slow("b")), q.submit("c", slow("c")), q.stats()]
        gate.set()
        deadline = time.monotonic() + 30
        while q.stats()["pending"] and time.monotonic() < deadline:
            time.sleep(0.01)
        got.append(sorted(ran))
        answers.append(got)
    assert answers[0] == answers[1] == [True, False, True, False,
                                        {"pending": 2, "max_pending": 2}, ["a", "b"]]


# ---------------------------------------------------------------------------
# the handlers under a forced level


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    root = tmp_path_factory.mktemp("brownout_src")
    path = root / "source.png"
    Image.fromarray(_image(330, 420, 11)).save(path, "PNG")
    return str(path)


def _handlers(root, **extra):
    """The port's handler (CPU, no batcher) and the JAX handler, each with
    a brownout engine on an injected clock, over stores of their own."""
    clock = Clock()
    settings = {"brownout_enable": True, "brownout_eval_interval_s": 0.0,
                "brownout_min_dwell_s": 0.0, "shed_retry_after_s": 2.0, **extra}
    metrics = MetricsRegistry()
    params = AppParameters({"upload_dir": str(root / "tu"), "tmp_dir": str(root / "tt"),
                            "brownout_clock": clock, **settings})
    engine = brownout.BrownoutEngine.from_params(params, metrics=metrics)
    ours = ImageHandler(params, device="cpu", metrics=metrics, brownout=engine)
    jmetrics = JMetricsRegistry()
    jparams = JAppParameters({"upload_dir": str(root / "ju"), "tmp_dir": str(root / "jt"),
                              "brownout_clock": clock, **settings})
    jengine = jbrownout.BrownoutEngine.from_params(jparams, metrics=jmetrics)
    theirs = JImageHandler(JLocalStorage(jparams), jparams, metrics=jmetrics, brownout=jengine)
    return ours, theirs


def _force(ours, theirs, pressure):
    box = [pressure]
    _pressure(box)
    levels = (ours.brownout.evaluate(), theirs.brownout.evaluate())
    assert levels[0] == levels[1]
    return levels[0]


def _pixels(content):
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB")).astype(int)


def _degraded_total(metrics, mode):
    return metrics.summary().get(f'flyimg_degraded_total{{mode="{mode}"}}', 0)


BROWNOUT_CASES = [
    ("w_300,h_250,c_1,smc_1,o_png", ("smartcrop",)),
    ("w_200,h_150,c_1,unsh_0.25x0.25+8+0.065,o_png", ("refine",)),
    ("w_200,sh_1x0.5,smc_1,o_png", ("refine", "smartcrop")),
    ("w_160,blr_2x1,o_png", ()),
    ("w_160,o_webp,webpl_1", ()),
]


@pytest.mark.parametrize("opts,modes", BROWNOUT_CASES)
def test_brownout_renders_match_jax(tmp_path, source, opts, modes):
    ours, theirs = _handlers(tmp_path)
    assert _force(ours, theirs, 0.9) == brownout.BROWNOUT
    got, want = ours.process_image(opts, source), theirs.process_image(opts, source)
    assert got.degraded == want.degraded == modes
    assert got.stale is want.stale is False
    a, b = _pixels(got.content), _pixels(want.content)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= PIXEL_TOL
    # a degraded answer is never stored; an undegraded one is
    assert ours.storage.has(got.spec.name) == (not modes)
    assert os.path.exists(os.path.join(theirs.storage.root, want.spec.name)) == (not modes)
    for mode in modes:
        assert _degraded_total(ours.metrics, mode) == _degraded_total(theirs.metrics, mode) == 1
    if "smartcrop" in modes:
        # the entropy crop's square window: the scoring did not run
        assert a.shape[0] == a.shape[1]


def _dqt(content):
    """The JPEG's quantization table segments."""
    out, pos = [], 2
    while pos + 4 <= len(content) and content[pos] == 0xFF:
        marker, length = content[pos + 1], int.from_bytes(content[pos + 2:pos + 4], "big")
        if marker == 0xDB:
            out.append(content[pos:pos + 2 + length])
        if marker == 0xDA:
            break
        pos += 2 + length
    return out


@pytest.mark.parametrize("opts,clamped", [
    ("w_200,h_150,c_1,o_jpg,q_90", True), ("w_200,h_150,c_1,o_jpg,q_30", False),
    ("w_200,h_150,c_1,o_jpg,moz_0,q_75", True),
])
def test_brownout_quality_clamp_matches_jax(tmp_path, source, monkeypatch, fastcodec,
                                            opts, clamped):
    use_in_jax(monkeypatch, fastcodec)
    ours, theirs = _handlers(tmp_path, brownout_quality=40)
    assert _force(ours, theirs, 0.9) == brownout.BROWNOUT
    got, want = ours.process_image(opts, source), theirs.process_image(opts, source)
    assert got.degraded == want.degraded == (("quality",) if clamped else ())
    assert _dqt(got.content) == _dqt(want.content) and _dqt(got.content)
    a, b = _pixels(got.content), _pixels(want.content)
    assert a.shape == b.shape


def test_shed_refuses_misses_and_serves_hits(tmp_path, source):
    ours, theirs = _handlers(tmp_path)
    for handler in (ours, theirs):
        assert handler.process_image("w_64,o_png", source).from_cache is False
    assert _force(ours, theirs, 5.0) == brownout.SHED
    for handler in (ours, theirs):
        assert handler.process_image("w_64,o_png", source).from_cache is True
    # the output is named from the fetched source, so a source that does
    # not exist fails its fetch before the level is consulted, in both
    missing = str(tmp_path / "never-fetched.png")
    errors = []
    for handler in (ours, theirs):
        with pytest.raises(Exception) as info:
            handler.process_image("w_65,o_png", source)
        errors.append((type(info.value).__name__, info.value.retry_after_s, str(info.value)))
        with pytest.raises(Exception) as info:
            handler.process_image("w_66,o_png", missing)
        assert "shedding" not in str(info.value)    # the miss of an unknown source 404s
    assert errors[0] == errors[1]
    assert errors[0][1] == 2
    assert _degraded_total(ours.metrics, "shed") == _degraded_total(theirs.metrics, "shed") == 1


def test_stale_hits_coalesce_into_one_refresh_as_jax(tmp_path, source):
    ours, theirs = _handlers(tmp_path, brownout_stale_ttl_s=60.0)
    n = 6
    counts = []
    for handler, mod in ((ours, faults), (theirs, jfaults)):
        first = handler.process_image("w_80,o_png", source)
        assert not first.stale
        root = handler.storage.root
        old = time.time() - 3600
        os.utime(os.path.join(root, first.spec.name), (old, old))
        gate, fired = threading.Event(), []
        injector = mod.install(mod.FaultInjector())
        injector.plan("brownout.signal", lambda **_: 0.7)
        # the refresh waits until every stale hit is in: one render for n
        injector.plan("brownout.refresh",
                      lambda fired=fired, gate=gate, mod=mod, **_: (
                          fired.append(1), gate.wait(30), mod.PASS)[-1])
        assert handler.brownout.evaluate() == brownout.DEGRADED
        hits = [handler.process_image("w_80,o_png", source) for _ in range(n)]
        assert all(h.stale and h.from_cache and h.content == first.content for h in hits)
        gate.set()
        deadline = time.monotonic() + 60
        while handler.brownout.refresh.stats()["pending"] and time.monotonic() < deadline:
            time.sleep(0.01)
        after = handler.process_image("w_80,o_png", source)
        counts.append((len(fired), after.stale, _degraded_total(handler.metrics, "stale")))
    assert counts[0] == counts[1] == (1, False, n)


def test_brownout_off_under_overload_serves_as_default(tmp_path, source):
    """brownout_enable false and the pressure injected at SHED: the same
    bytes, headers and launches as a default server."""
    _pressure([5.0])
    answers = []
    for tag, extra in (("default", {}), ("off", {"brownout_enable": False})):
        server = make_server(AppParameters({
            "upload_dir": str(tmp_path / tag / "u"), "tmp_dir": str(tmp_path / tag / "t"),
            **extra}), device="cpu")
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            got = [_get(f"{base}/upload/{opts}/{source}")
                   for opts in ("w_300,h_250,c_1,smc_1,o_png", "w_300,h_250,c_1,smc_1,o_png",
                                "w_90,sh_1x1,o_png")]
            answers.append(([(s, sorted(k for k in h if k not in ("Date", "traceparent",
                                                                  "Last-Modified", "Expires",
                                                                  "ETag")), b)
                             for s, h, b in got],
                            list(server.batcher.launch_log)))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    assert answers[0] == answers[1]
    assert all("X-Flyimg-Degraded" not in names for _s, names, _b in answers[0][0])


def _get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def test_negative_cached_origin_answers_502_without_a_fetch(tmp_path):
    import urllib.error

    injector = faults.FaultInjector()
    injector.plan("fetch.http", lambda **_: (_ for _ in ()).throw(
        urllib.error.URLError(ConnectionRefusedError("down"))))
    server = make_server(AppParameters({
        "upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t"),
        "negative_cache_ttl_s": 60.0, "retry_max_attempts": 1,
        "fault_injector": injector}), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        url = f"{base}/upload/w_20,o_png/http://dead.example.com/img.png"
        first = _get(url)
        fired = injector.fired.get("fetch.http", 0)
        second = _get(url)
        again = _get(f"{base}/upload/w_20,o_png/http://dead.example.com/img.png?v=2")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert first[0] == 404
    assert second[0] == again[0] == 502
    assert b"OriginUnavailableException" in second[2]
    assert injector.fired.get("fetch.http", 0) == fired
    summary = server.metrics.summary()
    assert summary["flyimg_negative_cache_entries_total"] == 1
    assert summary["flyimg_negative_cache_hits_total"] == 2

