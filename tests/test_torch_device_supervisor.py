"""The PyTorch package's device supervisor (flyimg_tpu_torch/runtime/
devicesupervisor.py, the batcher's ``pause_launches`` / ``drain_inflight``
/ ``failover_backend`` and its supervisor feed, the handler's
``cpu-fallback`` path and the server's ``/readyz`` and ``/debug/device``)
held against the JAX package's on the CPU, and the refusal of the enable
keys of modules not ported yet:

- the same script of classified launch outcomes and probe verdicts (the
  ``device.backend`` fault point, injected clock) walks both supervisors
  through the same states, failovers, re-promotions and snapshots: a storm
  at the threshold within the window, a success resetting it, a trickle
  past the window, poison never counting, clean probes re-promoting after
  the hysteresis, a failed or raising probe resetting it, flap damping;
- the batcher: paused launches hold queued work, ``failover_backend``
  rebuilds the controller on its new device with the queue kept and a
  runner bound to a device moved with it, ``drain_inflight`` stamps what
  is left, and a transient drain failure and its retries feed the
  supervisor, a resolved launch resets it;
- the handlers, JAX ``ImageHandler`` against the port's
  ``ImageHandler(device="cpu")``, while each supervisor holds a failover:
  the same answer tagged ``cpu-fallback``, never stored;
- the server with the supervisor on: an injected storm of TRANSIENT
  launch failures fails its requests, trips the breaker and the next
  answers are tagged, uncached, with ``/readyz`` saying the device is down
  and ``/debug/device`` the failover; clean probes re-promote and the
  answers are the clean run's bytes, stored; with the supervisor off the
  same storm never serves a CPU answer;
- the fleet tier's enable keys, and a non-empty ``fleet_replicas``, arm
  their modules as the JAX app arms them; warm start and the autotuner
  start a server that answers.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
from functools import partial

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.runtime import devicesupervisor as jsup
from flyimg_tpu.runtime.metrics import MetricsRegistry as JMetricsRegistry
from flyimg_tpu.runtime.resilience import POISON as JPOISON
from flyimg_tpu.runtime.resilience import TRANSIENT as JTRANSIENT
from flyimg_tpu.service.handler import ImageHandler as JImageHandler
from flyimg_tpu.storage.local import LocalStorage as JLocalStorage
from flyimg_tpu.testing import faults as jfaults
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.runtime import devicesupervisor as sup_mod
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.runtime.resilience import POISON, TRANSIENT
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.service.handler import ImageHandler
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
from flyimg_tpu_torch.testing import faults

torch.set_num_threads(1)


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


class FakeBatcher:
    """The controller surface a supervisor drives, recorded."""

    def __init__(self):
        self.calls = []
        self.device = torch.device("cpu")

    def failover_backend(self, target, *, mesh=None, drain_timeout_s, reason):
        self.calls.append(("failover", reason))

    def drain_inflight(self, drain_timeout_s):
        self.calls.append(("drain",))

    def pause_launches(self):
        self.calls.append(("pause",))

    def resume_launches(self):
        self.calls.append(("resume",))


def _pair(clock, threshold=3, window_s=10.0, hysteresis=2):
    """The port's and the JAX supervisor, failover inline, probes driven
    by hand."""
    kw = dict(enabled=True, storm_threshold=threshold, storm_window_s=window_s,
              probe_hysteresis=hysteresis, probe_interval_s=0.05, failover_drain_s=0.2,
              clock=clock)
    ours = sup_mod.DeviceSupervisor(metrics=MetricsRegistry(), **kw)
    theirs = jsup.DeviceSupervisor(metrics=JMetricsRegistry(), **kw)
    batchers = (FakeBatcher(), FakeBatcher())
    for s in (ours, theirs):
        s._spawn = lambda target, name="t": target()
        s._ensure_prober = lambda: None
    ours.attach(batchers=batchers)
    theirs.attach(batcher=FakeBatcher(), mesh_factory=lambda: None)
    return ours, theirs, batchers


SCRIPTS = {
    "storm": ["T", "T", "check", "T", "check"],
    "success_resets": ["T", "S", "T", "S", "T", "T", "check", "S", "check"],
    "trickle": ["T", ("tick", 11.0), "T", ("tick", 11.0), "T", "check", "T", "T", "check"],
    "poison": ["P"] * 6 + ["check", "T", "T", "T", "check"],
    "repromote": ["T", "T", "T", ("probe", False), ("probe", True), "check",
                  ("probe", True), "check", "T", "check"],
    "probe_reset": ["T", "T", "T", ("probe", True), ("probe", False), ("probe", True),
                    "check", ("probe", "raise"), ("probe", True), ("probe", True), "check"],
    "flap": ["T", "T", "T", ("probe", True), ("probe", True), ("tick", 1.0), "T", "T", "T",
             "check", ("probe", True), ("probe", True), "check", ("probe", True), "check",
             ("tick", 1000.0), "T", "T", "T", "check"],
}


def _probe(verdict):
    def plan(**_):
        if verdict == "raise":
            raise RuntimeError("probe machinery")
        return verdict
    faults.install(faults.FaultInjector()).plan("device.backend", plan)
    jfaults.install(jfaults.FaultInjector()).plan("device.backend", plan)


def _view(s):
    snap = s.snapshot()
    snap.pop("state_age_s")
    return s.state(), s.cpu_forced(), snap


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_supervisor_walks_as_jax(script):
    clock = Clock()
    ours, theirs, batchers = _pair(clock)
    for step in SCRIPTS[script]:
        if step == "T":
            ours.record_batch_failure(TRANSIENT)
            theirs.record_batch_failure(JTRANSIENT)
        elif step == "P":
            ours.record_batch_failure(POISON)
            theirs.record_batch_failure(JPOISON)
        elif step == "S":
            ours.record_batch_success()
            theirs.record_batch_success()
        elif step == "check":
            assert _view(ours) == _view(theirs), script
        elif step[0] == "tick":
            clock.now += step[1]
        elif step[0] == "probe":
            _probe(step[1])
            assert ours.probe_and_handle() == theirs.probe_and_handle()
    assert _view(ours) == _view(theirs)
    # every failover and re-promotion held both controllers' launches
    # around the drain and the rebuild, and resumed them
    reasons = [c[1] for c in batchers[0].calls if c[0] == "failover"]
    assert reasons == [c[1] for c in batchers[1].calls if c[0] == "failover"]
    assert reasons == [c[1] for c in theirs._batcher.calls if c[0] == "failover"]
    for batcher in batchers:
        assert batcher.calls.count(("pause",)) == batcher.calls.count(("resume",))


def test_disabled_supervisors_record_nothing():
    ours, theirs = sup_mod.DeviceSupervisor(), jsup.DeviceSupervisor()
    for _ in range(10):
        ours.record_batch_failure(TRANSIENT)
        theirs.record_batch_failure(JTRANSIENT)
    assert (ours.state(), ours.cpu_forced()) == (theirs.state(), theirs.cpu_forced()) == (
        "device", False)


def test_probe_on_the_cpu_and_injected_verdicts():
    assert sup_mod.probe_device(torch.device("cpu"), 5.0) == (True, "up")
    _probe(False)
    assert sup_mod.probe_device(torch.device("cpu"), 5.0) == (False, "injected")
    _probe("raise")
    assert sup_mod.probe_device(torch.device("cpu"), 5.0) == (False, "error:RuntimeError")


# ---------------------------------------------------------------------------
# the batcher's side


def _img(seed, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _plan():
    return build_plan(OptionsBag("w_32,h_24,c_1"), 64, 48)


def test_paused_launches_hold_and_failover_keeps_the_queue():
    ctl = BatchController(max_batch=4, deadline_ms=1.0, device="cpu")
    try:
        clean = [ctl.submit(_img(i), _plan()).result(timeout=30) for i in range(3)]
        launches = len(ctl.launch_log)
        ctl.pause_launches()
        futures = [ctl.submit(_img(i), _plan()) for i in range(3)]
        time.sleep(0.05)
        assert not any(f.done() for f in futures)
        assert len(ctl.launch_log) == launches
        old_thread = ctl._thread
        ctl.failover_backend("cpu", drain_timeout_s=1.0, reason="device_failover")
        got = [f.result(timeout=30) for f in futures]
        assert ctl._thread is not old_thread and ctl.device == torch.device("cpu")
        assert all(np.array_equal(a, b) for a, b in zip(got, clean))
        assert ctl.metrics.summary()[
            'flyimg_executor_restarts_total{reason="device_failover"}'] == 1
    finally:
        ctl.close(5.0)


def test_aux_runner_bound_to_a_device_follows_the_controller():
    ctl = BatchController(max_batch=4, deadline_ms=1.0, device="cpu")
    seen = []

    def runner(items, device=None):
        seen.append(str(device))
        return items

    try:
        ctl.device = torch.device("meta")   # a device the runner is not bound to
        assert ctl.submit_aux(("x",), 1, partial(runner, device="cpu")).result(10) == 1
        ctl.device = torch.device("cpu")
        assert ctl.submit_aux(("y",), 2, partial(runner, device="cpu")).result(10) == 2
    finally:
        ctl.close(5.0)
    assert seen == ["meta", "cpu"]


def test_drain_inflight_stamps_what_is_left():
    ctl = BatchController(max_batch=2, deadline_ms=1.0, device="cpu")
    gate = threading.Event()
    faults.install(faults.FaultInjector()).plan(
        "batcher.drain", lambda **_: (gate.wait(30), faults.PASS)[-1])
    try:
        fut = ctl.submit(_img(0), _plan())
        deadline = time.monotonic() + 10
        while not ctl._inflight_batches and time.monotonic() < deadline:
            time.sleep(0.01)
        ctl.drain_inflight(0.1, "abandoned")
        with pytest.raises(TimeoutError, match="abandoned"):
            fut.result(timeout=5)
    finally:
        gate.set()
        ctl.close(5.0)


def test_batcher_feeds_the_supervisor():
    class Recorder:
        def __init__(self):
            self.events = []

        def record_batch_success(self):
            self.events.append("ok")

        def record_batch_failure(self, kind):
            self.events.append(kind)

    rec = Recorder()
    ctl = BatchController(max_batch=2, deadline_ms=1.0, device="cpu", batch_retries=1,
                          supervisor=rec)
    ctl._retry_policy.sleep = lambda _s: None
    try:
        ctl.submit(_img(0), _plan()).result(timeout=30)
        assert rec.events == ["ok"]
        faults.install(faults.FaultInjector()).plan(
            "batcher.drain", lambda key=None, **_: (_ for _ in ()).throw(OSError("lost")))
        with pytest.raises(OSError):
            ctl.submit(_img(1), _plan()).result(timeout=30)
        assert rec.events == ["ok", TRANSIENT, TRANSIENT]
        faults.clear()
        ctl.submit(_img(2), _plan()).result(timeout=30)
        assert rec.events[-1] == "ok"
    finally:
        ctl.close(5.0)


# ---------------------------------------------------------------------------
# the handlers


def _pixels(content):
    return np.asarray(Image.open(io.BytesIO(content)).convert("RGB")).astype(int)


@pytest.mark.parametrize("opts", ["w_300,h_250,c_1,o_png", "w_300,h_250,c_1,smc_1,o_png",
                                  "w_120,blr_1x1,o_png"])
def test_failover_answers_are_tagged_and_unstored_as_jax(tmp_path, opts):
    src = tmp_path / "src.png"
    Image.fromarray(_img(5, 330, 420)).save(src)
    clock = Clock()
    ours, theirs, _b = _pair(clock, threshold=1)
    handler = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "tu"),
                                          "tmp_dir": str(tmp_path / "tt")}),
                           device="cpu", device_supervisor=ours)
    jparams = JAppParameters({"upload_dir": str(tmp_path / "ju"),
                              "tmp_dir": str(tmp_path / "jt")})
    jhandler = JImageHandler(JLocalStorage(jparams), jparams, device_supervisor=theirs)
    ours.record_batch_failure(TRANSIENT)
    theirs.record_batch_failure(JTRANSIENT)
    assert handler.device == torch.device("cpu") and handler._device_down()
    rows = []
    for h, store in ((handler, handler.storage), (jhandler, jhandler.storage)):
        first = h.process_image(opts, str(src))
        second = h.process_image(opts, str(src))
        rows.append((first.degraded, second.degraded, first.from_cache, second.from_cache,
                     first.modified_at, store.has(first.spec.name)))
        assert first.content == second.content
    assert rows[0] == rows[1] == (("cpu-fallback",), ("cpu-fallback",), False, False, None,
                                  False)
    a = _pixels(handler.process_image(opts, str(src)).content)
    b = _pixels(jhandler.process_image(opts, str(src)).content)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


# ---------------------------------------------------------------------------
# the server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _storm_plans(flags):
    """A storm of TRANSIENT failures of the transform launches while
    ``flags["storm"]``, and a dead card for the probe while
    ``flags["dead"]``."""
    injector = faults.FaultInjector()

    def drain(key=None, **_):
        if flags["storm"] and key and key[0] != "aux":
            raise ConnectionError("device lost")
        return faults.PASS

    injector.plan("batcher.drain", drain)
    injector.plan("device.backend", lambda **_: not flags["dead"])
    return injector


@pytest.mark.parametrize("enabled", [True, False])
def test_server_fails_over_and_repromotes(tmp_path, enabled):
    src = tmp_path / "src.png"
    Image.fromarray(_img(6, 240, 320)).save(src)
    flags = {"storm": False, "dead": False}
    server = make_server(AppParameters({
        "upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t"), "debug": True,
        "device_supervisor_enable": enabled, "device_storm_threshold": 3,
        "device_probe_interval_s": 3600.0, "device_probe_hysteresis": 2,
        "resilience_batch_retries": 0, "fault_injector": _storm_plans(flags)}), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    sup = server.device_supervisor
    try:
        clean = _get(f"{base}/upload/w_100,h_80,c_1,o_png/{src}")
        assert clean[0] == 200 and "X-Flyimg-Degraded" not in clean[1]
        flags.update(storm=True, dead=True)
        storm = [_get(f"{base}/upload/w_{90 + i},o_png/{src}")[0] for i in range(3)]
        assert storm == [500, 500, 500]
        flags["storm"] = False
        if not enabled:
            again = _get(f"{base}/upload/w_90,o_png/{src}")
            assert again[0] == 200 and "X-Flyimg-Degraded" not in again[1]
            assert json.loads(_get(f"{base}/readyz")[2]) == {"status": "ok"}
            assert _get(f"{base}/debug/device")[0] == 200
            assert "flyimg_device_health" not in _get(f"{base}/metrics")[2].decode()
            return
        assert sup.cpu_forced()
        deadline = time.monotonic() + 30
        while server.batcher.metrics.summary().get(
                'flyimg_executor_restarts_total{reason="device_failover"}', 0) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        # a hit never notices; a miss renders on the CPU, tagged, unstored
        hit = _get(f"{base}/upload/w_100,h_80,c_1,o_png/{src}")
        assert hit[2] == clean[2] and "X-Flyimg-Degraded" not in hit[1]
        down = [_get(f"{base}/upload/w_101,h_81,c_1,o_png/{src}") for _ in range(2)]
        for status, headers, body in down:
            assert status == 200 and headers["X-Flyimg-Degraded"] == "cpu-fallback"
            assert headers["Cache-Control"] == "max-age=60, public"
            assert body == down[0][2]
        assert json.loads(_get(f"{base}/readyz")[2]) == {"status": "ok", "device": "down"}
        doc = json.loads(_get(f"{base}/debug/device")[2])
        assert doc["state"] == "cpu-fallback" and doc["failovers"] == 1
        text = _get(f"{base}/metrics")[2].decode()
        assert "flyimg_device_health 0" in text
        assert sup.probe_and_handle() is False
        flags["dead"] = False
        assert sup.probe_and_handle() is True and sup.cpu_forced()
        assert sup.probe_and_handle() is True and not sup.cpu_forced()
        back = [_get(f"{base}/upload/w_101,h_81,c_1,o_png/{src}") for _ in range(2)]
        for status, headers, body in back:
            assert status == 200 and "X-Flyimg-Degraded" not in headers
            assert body == down[0][2]    # the CPU program is the card's here
        assert back[1][1]["Cache-Control"] != "max-age=60, public"
        summary = server.metrics.summary()
        assert summary['flyimg_backend_failovers_total{to="cpu"}'] == 1
        assert summary['flyimg_backend_failovers_total{to="device"}'] == 1
        assert json.loads(_get(f"{base}/readyz")[2]) == {"status": "ok", "device": "ok"}
    finally:
        flags.update(storm=False, dead=False)
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


FLEET_ENABLE_KEYS = ("l2_enable", "tier_supervisor_enable", "tier_scrub_enable",
                     "fleet_membership_enable", "fleet_observatory_enable")


def _jax_fleet_modules(params):
    """What the JAX app arms for ``params``: its store's class and each
    fleet module's ``enabled`` (and the scrubber's)."""
    from flyimg_tpu.runtime.fleet import FleetRouter as JFleetRouter
    from flyimg_tpu.runtime.membership import FleetMembership as JFleetMembership
    from flyimg_tpu.runtime.observatory import FleetObservatory as JFleetObservatory
    from flyimg_tpu.runtime.tiersupervisor import TierSupervisor as JTierSupervisor
    from flyimg_tpu.storage import make_storage as jmake_storage

    storage = jmake_storage(params)
    router = JFleetRouter.from_params(params)
    tier = JTierSupervisor.from_params(params)
    membership = JFleetMembership.from_params(params, storage=storage.shared, router=router)
    observatory = JFleetObservatory.from_params(params, storage=storage.shared,
                                                membership=membership)
    return (type(storage).__name__, router.enabled, tier.enabled, tier.scrub_enable,
            membership.enabled, observatory.enabled)


def _port_fleet_modules(server):
    return (type(server.storage).__name__, server.fleet.enabled,
            server.tier_supervisor.enabled, server.tier_supervisor.scrub_enable,
            server.membership.enabled, server.observatory.enabled)


@pytest.mark.parametrize("key", FLEET_ENABLE_KEYS)
def test_unported_enable_keys_refuse_the_server(tmp_path, key):
    """The fleet tier's enable keys, which refused the server before the
    tier was ported, now arm their module as the JAX app arms it: the same
    store and the same ``enabled`` for each module; off, each is inert."""
    for on in (True, False):
        settings = {"upload_dir": str(tmp_path / f"u{on}"), "tmp_dir": str(tmp_path / f"t{on}"),
                    "l2_upload_dir": str(tmp_path / f"l2{on}"),
                    "fleet_replica_id": "http://127.0.0.1:1", key: on}
        server = make_server(AppParameters(settings), device="cpu")
        try:
            assert _port_fleet_modules(server) == _jax_fleet_modules(JAppParameters(settings))
            assert (server.handler.l2lease is not None) == (key == "l2_enable" and on)
        finally:
            server.server_close()


def test_fleet_replicas_refuse_the_server(tmp_path):
    """A non-empty ``fleet_replicas``, which refused the server before
    routing was ported, now arms rendezvous routing as in the JAX app: the
    router is on exactly when the JAX one is, and a request answers whether
    its owner is this replica or a peer that cannot be reached (the
    fallback renders here); an empty list serves with routing off."""
    from flyimg_tpu.runtime.fleet import FleetRouter as JFleetRouter

    replicas = ["http://127.0.0.1:1", "http://127.0.0.1:2"]
    for replica_id in ("", replicas[0]):
        settings = {"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t"),
                    "fleet_replicas": replicas, "fleet_replica_id": replica_id}
        server = make_server(AppParameters(settings), device="cpu")
        assert server.fleet.enabled == JFleetRouter.from_params(
            JAppParameters(settings)).enabled == bool(replica_id)
        server.server_close()
    assert JAppParameters().by_key("fleet_replicas") == AppParameters().by_key(
        "fleet_replicas") == []
    src = tmp_path / "src.png"
    Image.fromarray(_img(7, 60, 80)).save(src)
    for replica_list in (replicas, []):
        server = make_server(AppParameters({
            "upload_dir": str(tmp_path / "u2"), "tmp_dir": str(tmp_path / "t2"),
            "fleet_replicas": replica_list, "fleet_replica_id": replicas[0],
            "retry_base_backoff_s": 0.001}), device="cpu")
        thread = serve_in_thread(server)
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            for w in (40, 41, 42, 43):
                assert _get(f"{base}/upload/w_{w},h_30,c_1,o_png/{src}")[0] == 200
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)


@pytest.mark.parametrize("key", ["warmstart_enable", "autotune_enable"])
def test_ported_enable_keys_start_the_server(tmp_path, key):
    """The enable keys of warm start and the autotuner, ported, start a
    server that answers."""
    src = tmp_path / "src.png"
    Image.fromarray(_img(8, 60, 80)).save(src)
    server = make_server(AppParameters({"upload_dir": str(tmp_path / "u"),
                                        "tmp_dir": str(tmp_path / "t"), "debug": True,
                                        key: True}), device="cpu")
    thread = serve_in_thread(server)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, _headers, body = _get(f"{base}/upload/w_40,h_30,c_1,o_png/{src}")
        assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        assert (server.warmstart if key == "warmstart_enable" else server.autotuner).enabled
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
