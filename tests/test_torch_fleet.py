"""The PyTorch package's fleet routing, cross-replica lease and fleet HTTP
surface held against the JAX package's (``tests/test_fleet.py``'s cases),
on the CPU:

- ``route_key`` and ``rendezvous_owner`` equal the JAX functions on 10,000
  seeded keys for every replica set of 1 to 8 (exact), and ``FleetRouter``
  answers as the JAX router (enabled rules, owners, swaps, device-down
  marks, peer health, routing counters, ``from_params``, and ``proxy`` over
  the ``fleet.proxy`` fault point: the same relays and fallbacks);
- two handlers over one shared L2 directory, each package's pair on the
  same scripts: a render shared through the L2, the lease released, a hot
  key rendered once across replicas, a live foreign lease coalesced, a
  crashed leader's lease stolen, the wait's 504 and 503, a torn artifact
  re-rendered, ``rf_1`` rendering at once and writing through,
  cross-replica reuse through the shared manifest, the lease's followers
  as brownout pressure, and off-is-off; the same outcomes, counters and
  flags (exact), and the same pixels within 1 level (each package encodes
  its own PNG). Lease waits run on injected clocks and sleeps: no test
  sleeps through a TTL;
- two HTTP replicas of each package (a third peer that is down and a
  fourth that answers 503), the same requests: proxy to the owner, a
  self-owned key, the hop header, the owner down, the owner's 5xx, a 4xx
  relayed, local mode, the ``fleet.route`` span and the hop's trace,
  ``/debug/perf``'s fleet, ``/debug/fleet/replicas`` (applied, validated,
  404 with debug off, refused under membership), the replica header with
  debug off, and the fleet-off surface: the same statuses, replica roles
  and routing counters (exact);
- the port alone: off is off (the default server's answers, files and
  ``/metrics`` carry nothing of the fleet) and the SIGHUP reload.
"""

import asyncio
import functools
import json
import logging
import os
import random
import socket
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import flyimg_tpu.appconfig as jappconfig
import flyimg_tpu.exceptions as jexceptions
import flyimg_tpu.runtime.brownout as jbrownout
import flyimg_tpu.runtime.fleet as jfleet
import flyimg_tpu.runtime.metrics as jmetrics
import flyimg_tpu.runtime.resilience as jresilience
import flyimg_tpu.service.handler as jhandler
import flyimg_tpu.storage as jstorage
import flyimg_tpu.storage.tiered as jtiered
import flyimg_tpu.testing.faults as jfaults
import flyimg_tpu_torch.appconfig as tappconfig
import flyimg_tpu_torch.exceptions as texceptions
import flyimg_tpu_torch.runtime.brownout as tbrownout
import flyimg_tpu_torch.runtime.fleet as tfleet
import flyimg_tpu_torch.runtime.metrics as tmetrics
import flyimg_tpu_torch.runtime.resilience as tresilience
import flyimg_tpu_torch.service.handler as thandler
import flyimg_tpu_torch.storage as tstorage
import flyimg_tpu_torch.storage.tiered as ttiered
import flyimg_tpu_torch.testing.faults as tfaults
from flyimg_tpu.service.app import FLEET_KEY, make_app
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.service import app as tapp
from flyimg_tpu_torch.service.app import make_server, serve_in_thread

torch.set_num_threads(1)


def _ns(appconfig, exceptions, brownout, fleet, metrics, resilience, handler, storage,
        tiered, faults, make_handler, render_hook):
    return types.SimpleNamespace(
        AppParameters=appconfig.AppParameters, exceptions=exceptions, brownout=brownout,
        route_key=fleet.route_key, rendezvous_owner=fleet.rendezvous_owner,
        FleetRouter=fleet.FleetRouter, HOP_HEADER=fleet.HOP_HEADER,
        MetricsRegistry=metrics.MetricsRegistry, Deadline=resilience.Deadline,
        RetryPolicy=resilience.RetryPolicy, make_storage=storage.make_storage,
        LocalStorage=storage.LocalStorage, TieredStorage=tiered.TieredStorage,
        lease_name=tiered.lease_name, faults=faults, handler=make_handler,
        render_hook=render_hook)


PACKAGES = {
    "jax": _ns(jappconfig, jexceptions, jbrownout, jfleet, jmetrics, jresilience, jhandler,
               jstorage, jtiered, jfaults,
               lambda storage, params, metrics: jhandler.ImageHandler(
                   storage, params, metrics=metrics), "_process_new"),
    "torch": _ns(tappconfig, texceptions, tbrownout, tfleet, tmetrics, tresilience, thandler,
                 tstorage, ttiered, tfaults,
                 lambda storage, params, metrics: thandler.ImageHandler(
                     params, device="cpu", storage=storage, metrics=metrics),
                 "_process_admitted"),
}


def gradient(w=192, h=144):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xx * (255.0 / max(w - 1, 1)), yy * (255.0 / max(h - 1, 1)),
                     (xx + yy) * (255.0 / max(w + h - 2, 1))], axis=-1).astype(np.uint8)


def counter(metrics, name):
    found = metrics._counters.get(name)
    return found.value if found is not None else 0.0


def lease_count(metrics, outcome):
    return counter(metrics, f'flyimg_l2_lease_total{{outcome="{outcome}"}}')


def pixels(content):
    return png.decode(content)[0]


def assert_pixels_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert int(np.abs(a.astype(np.int16) - b).max()) <= 1


# ---------------------------------------------------------------------------
# rendezvous routing


@functools.lru_cache(maxsize=1)
def routing_keys(n=10_000):
    """``n`` seeded requests (options of random tokens, the encode-only ones
    among them, in random order, mostly comma-separated; sources of several
    schemes) and their route keys, each equal to the JAX function's."""
    rng = random.Random(27)
    pool = ["w_{}", "h_{}", "c_1", "c_0", "q_{}", "moz_0", "moz_1", "sf_2x2", "st_1",
            "webpl_1", "rf_1", "o_png", "o_jpg", "smc_1", "r_{}", "g_North", "e_1",
            "bg_%23{:06x}", "clsp_Gray", "blr_{}x2"]
    sources = ["https://e.com/{}.jpg", "/data/{}.png", "s3://b/\u00fc{}.webp",
               "http://h:8080/a/{}?x=1"]
    keys = []
    for _ in range(n):
        sep = "," if rng.random() < 0.9 else "-"
        options = sep.join(rng.choice(pool).format(rng.randrange(1, 5000))
                           for _ in range(rng.randrange(0, 7)))
        src = rng.choice(sources).format(rng.randrange(10**6))
        key = tfleet.route_key(options, src, separator=sep)
        assert key == jfleet.route_key(options, src, separator=sep), (options, src)
        keys.append(key)
    return keys


@pytest.mark.parametrize("size", range(1, 9))
def test_route_key_and_owner_equal_the_jax_functions(size):
    replicas = [f"http://10.0.{size}.{i}:{8000 + i}" for i in range(size)]
    keys = routing_keys()
    assert len(set(keys)) > 9_900
    for key in keys:
        assert tfleet.rendezvous_owner(replicas, key) == jfleet.rendezvous_owner(replicas, key)
    for fn in (tfleet.rendezvous_owner, jfleet.rendezvous_owner):
        with pytest.raises(ValueError):
            fn([], "k")


REPLICAS = [f"http://10.0.0.{i}:8080" for i in range(1, 5)]


def test_rendezvous_properties_hold_on_the_port():
    key = tfleet.route_key("w_200,h_200,c_1", "https://example.com/a.jpg")
    owner = tfleet.rendezvous_owner(REPLICAS, key)
    assert tfleet.rendezvous_owner(list(reversed(REPLICAS)), key) == owner
    keys = [tfleet.route_key(f"w_{100 + i}", "https://e.com/a.jpg") for i in range(1000)]
    counts = {r: 0 for r in REPLICAS}
    for k in keys:
        counts[tfleet.rendezvous_owner(REPLICAS, k)] += 1
    assert all(150 <= c <= 350 for c in counts.values()), counts
    moved = 0
    for k in keys[:400]:
        before, after = (tfleet.rendezvous_owner(REPLICAS, k),
                         tfleet.rendezvous_owner(REPLICAS[:-1], k))
        moved += before == REPLICAS[-1]
        assert after == before or before == REPLICAS[-1]
    assert moved > 0
    base = tfleet.route_key("w_200,h_150,c_1", "https://e.com/a.jpg")
    assert tfleet.route_key("q_80,moz_0,w_200,h_150,c_1,sf_2x2,st_1,rf_1",
                            "https://e.com/a.jpg") == base
    assert tfleet.route_key("h_150,c_1,w_200", "https://e.com/a.jpg") == base
    assert tfleet.route_key("w_201,h_150,c_1", "https://e.com/a.jpg") != base


def _router_script(ns):
    out = [(ns.FleetRouter([], "").enabled,),
           (ns.FleetRouter(["http://a"], "http://a").enabled,),
           (ns.FleetRouter(["http://a", "http://b"], "").enabled,)]
    router = ns.FleetRouter(["http://a", "http://b"], "http://a")
    local = ns.FleetRouter(["http://a", "http://b"], "http://a", mode="local")
    bogus = ns.FleetRouter(["http://a/", "http://b"], "http://a/", mode="bogus")
    out.append((router.enabled, router.proxies, local.enabled, local.proxies,
                bogus.mode, bogus.replicas, bogus.self_id))
    keys = [ns.route_key(f"w_{i}", "s.jpg") for i in range(64)]
    other = ns.FleetRouter(["http://a", "http://b"], "http://b")
    out.append(tuple((router.is_owner(k), other.is_owner(k)) for k in keys))
    big = ns.FleetRouter(REPLICAS, REPLICAS[0], health_ttl_s=60.0)
    owners = [big.owner(k) for k in keys]
    out.append(big.update_replicas(REPLICAS[:-1]))
    out.append(tuple(big.owner(k) for k in keys))
    out.append(big.update_replicas(REPLICAS, self_id=REPLICAS[1], source="membership"))
    big.mark_device_down(REPLICAS[2])
    big.mark_device_down(REPLICAS[1])          # self is never marked
    health = big.peer_health()
    out.append((sorted(health["device_down"]), {k: v for k, v in health.items()
                                                if k != "device_down"}))
    out.append(tuple(big.owner(k) for k in keys))
    out.append(tuple(owners))
    empty = ns.FleetRouter([], "http://x")
    out.append((empty.owner("k"), empty.update_replicas([])["enabled"]))
    metrics = ns.MetricsRegistry()
    counted = ns.FleetRouter(["http://a", "http://b"], "http://a", metrics=metrics)
    for outcome in ("self", "hop", "proxied", "proxied", "fallback", "local"):
        counted.record(outcome)
    out.append(sorted((k, v.value) for k, v in metrics._counters.items()))
    params = ns.AppParameters({"fleet_replicas": ["http://x/", "http://y"],
                               "fleet_replica_id": "http://y", "fleet_route": "local",
                               "fleet_proxy_timeout_s": 7.0, "fleet_health_ttl_s": 0.0})
    made = ns.FleetRouter.from_params(params)
    out.append((made.replicas, made.self_id, made.mode, made.proxy_timeout_s,
                made.health_ttl_s, made.retry.max_attempts, made.enabled))
    return out


def test_router_answers_as_the_jax_router():
    got = {name: _router_script(ns) for name, ns in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == [(False,)] * 3


def _proxy_script(ns, run):
    """``proxy`` over the fleet.proxy fault point: relays, an owner's 5xx,
    transport failures with retries, and the breaker opening."""
    plans = iter([
        (200, {"Content-Type": "image/png", "X-Flyimg-Replica": "http://b"}, b"png"),
        (404, {"Content-Type": "text/plain"}, b"nope"),
        (503, {}, b""),
        "raise", "raise", "raise",
        "raise", (200, {}, b"second try"),
    ] + [(502, {}, b"")] * 6)
    seen = []

    def plan(**ctx):
        seen.append(ctx["attempt"])
        step = next(plans)
        if step == "raise":
            raise OSError("injected transport failure")
        return step

    injector = ns.faults.FaultInjector()
    injector.plan("fleet.proxy", plan)
    ns.faults.install(injector)
    retry = ns.RetryPolicy(max_attempts=3, base_backoff_s=0.0001, max_backoff_s=0.0002)
    router = ns.FleetRouter(["http://a", "http://b"], "http://a", health_ttl_s=0.0,
                            retry=retry)
    out = []
    try:
        for _ in range(10):
            out.append(run(router.proxy("http://b", "/upload/w_1/x", {"Accept": "image/webp"})))
            out.append(router.breakers.for_host("http://b").state)
    finally:
        ns.faults.clear()
    return out, seen


def test_proxy_relays_and_falls_back_as_the_jax_router():
    def run_async(coro):
        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(coro)
        finally:
            loop.close()

    jax = _proxy_script(PACKAGES["jax"], run_async)
    port = _proxy_script(PACKAGES["torch"], lambda result: result)
    assert port == jax
    out, _seen = port
    assert out[0] == (200, {"Content-Type": "image/png", "X-Flyimg-Replica": "http://b"}, b"png")
    assert out[2] == (404, {"Content-Type": "text/plain"}, b"nope")
    assert out[4] is None and out[6] is None and out[8] == (200, {}, b"second try")


# ---------------------------------------------------------------------------
# handler-level cross-replica coalescing: two handlers, one shared L2

OPTS = "w_96,h_72,c_1,o_png"


def replica(ns, root, sub, shared, replica_id, **over):
    params = ns.AppParameters({
        "tmp_dir": str(root / sub / "tmp"), "upload_dir": str(root / sub / "uploads"),
        "l2_enable": True, "l2_upload_dir": str(shared), "fleet_replica_id": replica_id,
        **over})
    metrics = ns.MetricsRegistry()
    storage = ns.make_storage(params, metrics=metrics)
    return ns.handler(storage, params, metrics), storage, metrics


def env(ns, root, **over):
    src = root / "src.png"
    src.write_bytes(png.encode(gradient()))
    shared = root / "shared-l2"
    a = replica(ns, root, "a", shared, "replica-a", **over)
    b = replica(ns, root, "b", shared, "replica-b", **over)
    return a, b, str(src), shared


def foreign_marker(ns, store, name, owner, acquired_at, ttl_s):
    store.shared.write(ns.lease_name(name), json.dumps({
        "owner": owner, "token": "t0", "acquired_at": acquired_at, "ttl_s": ttl_s,
    }).encode())


def script_hook(lease, steps):
    """Replace the lease's poll sleep by ``steps``, one a poll (then
    nothing): no wall time passes."""
    steps = list(steps)

    def sleep(_seconds):
        if steps:
            steps.pop(0)()

    lease._sleep = sleep


def h_shared_render(ns, root):
    (ha, _sa, ma), (hb, _sb, mb), src, _ = env(ns, root)
    first = ha.process_image(OPTS, src)
    second = hb.process_image(OPTS, src)
    return ((first.from_cache, lease_count(ma, "lead"), second.from_cache,
             second.content == first.content,
             counter(mb, 'flyimg_cache_total{result="miss"}'),
             counter(mb, "flyimg_l2_promotions_total") >= 1.0), [pixels(first.content)])


def h_lease_released(ns, root):
    (ha, sa, _ma), _b, src, _ = env(ns, root)
    result = ha.process_image(OPTS, src)
    return (sa.shared.has(ns.lease_name(result.spec.name)),), []


def h_hot_key_once(ns, root):
    """b's request arrives while a holds the lease and renders: b waits on
    it (a's render goes on only once b is counted a follower)."""
    (ha, _sa, ma), (hb, _sb, mb), src, _ = env(ns, root)
    hb.l2lease.poll_s = 0.005
    original = getattr(ha, ns.render_hook)
    results = {}

    def render_b():
        results["b"] = hb.process_image(OPTS, src)

    follower = threading.Thread(target=render_b)

    def held(*args, **kwargs):
        follower.start()
        give_up = time.monotonic() + 30.0
        while hb.l2lease.waiters == 0 and time.monotonic() < give_up:
            time.sleep(0.001)
        return original(*args, **kwargs)

    setattr(ha, ns.render_hook, held)
    results["a"] = ha.process_image(OPTS, src)
    follower.join(timeout=60)
    renders = (counter(ma, 'flyimg_cache_total{result="miss"}')
               + counter(mb, 'flyimg_cache_total{result="miss"}'))
    return ((results["a"].content == results["b"].content, renders,
             lease_count(ma, "coalesced") + lease_count(mb, "coalesced"),
             lease_count(ma, "lead"), results["b"].from_cache),
            [pixels(results["a"].content)])


def h_foreign_lease_coalesced(ns, root):
    (ha, _sa, _ma), (hb, sb, mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    name = reference.spec.name
    sb.delete(name)
    foreign = hb.l2lease.__class__(sb.shared, "replica-x", ttl_s=30.0, poll_s=0.01)
    token = foreign.acquire(name)

    def publish():
        sb.shared.write(name, reference.content)
        foreign.release(name, token)

    script_hook(hb.l2lease, [lambda: None, publish])
    result = hb.process_image(OPTS, src)
    return ((token is not None, result.from_cache, result.content == reference.content,
             lease_count(mb, "coalesced"), counter(mb, 'flyimg_cache_total{result="miss"}')),
            [pixels(result.content)])


def h_crashed_leader_stolen(ns, root):
    (ha, _sa, _ma), (hb, sb, mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    name = reference.spec.name
    sb.delete(name)
    now = [5000.0]
    foreign_marker(ns, sb, name, "replica-dead", now[0], 0.3)
    hb.l2lease._clock = lambda: now[0]
    hb.l2lease.poll_s = 0.02

    def tick(_seconds):
        now[0] += 0.1

    hb.l2lease._sleep = tick
    result = hb.process_image(OPTS, src)
    return ((result.from_cache, result.content == reference.content, lease_count(mb, "steal"),
             sb.shared.has(ns.lease_name(name)), now[0] > 5000.3), [pixels(result.content)])


def h_wait_deadline_504(ns, root):
    (ha, _sa, _ma), (hb, sb, _mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    sb.delete(reference.spec.name)
    foreign_marker(ns, sb, reference.spec.name, "replica-slow", time.time(), 60.0)
    hb.l2lease.poll_s = 0.02
    t0 = time.monotonic()
    try:
        hb.process_image(OPTS, src, deadline=ns.Deadline(0.3))
        raised = None
    except Exception as exc:
        raised = type(exc).__name__
    return (raised, time.monotonic() - t0 < 5.0), []


def h_wait_cap_503(ns, root):
    (ha, _sa, _ma), (hb, sb, mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    sb.delete(reference.spec.name)
    foreign_marker(ns, sb, reference.spec.name, "replica-slow", time.time(), 60.0)
    hb.l2lease.poll_s = 0.02
    hb.l2lease.wait_cap_s = 0.2
    hb.l2lease._sleep = lambda _s: None
    try:
        hb.process_image(OPTS, src)
        raised = None
    except Exception as exc:
        raised = type(exc).__name__
    return (raised, lease_count(mb, "timeout"), hb.l2lease.waiters), []


def h_torn_rerendered(ns, root):
    (ha, _sa, _ma), (hb, sb, mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    name = reference.spec.name
    sb.delete(name)
    foreign = hb.l2lease.__class__(sb.shared, "replica-x", ttl_s=30.0, poll_s=0.01)
    token = foreign.acquire(name)
    script_hook(hb.l2lease, [lambda: sb.shared.write(name, b"not-a-png-at-all" * 8),
                             lambda: foreign.release(name, token)])
    result = hb.process_image(OPTS, src)
    return ((result.content == reference.content, result.from_cache,
             counter(mb, "flyimg_cache_corrupt_total") >= 1.0, lease_count(mb, "steal"),
             sb.shared.read(name) == result.content), [pixels(result.content)])


def h_refresh_writes_through(ns, root):
    (ha, _sa, _ma), (hb, sb, _mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    foreign_marker(ns, sb, reference.spec.name, "replica-x", time.time(), 60.0)
    result = hb.process_image(OPTS + ",rf_1", src)
    return ((result.from_cache, sb.shared.read(reference.spec.name) == result.content),
            [pixels(result.content)])


def h_cross_replica_reuse(ns, root):
    src = root / "src.png"
    src.write_bytes(png.encode(gradient(256, 192)))
    shared = root / "shared-l2"
    ha, _sa, _ma = replica(ns, root, "a", shared, "replica-a", reuse_enable=True)
    hb, _sb, mb = replica(ns, root, "b", shared, "replica-b", reuse_enable=True)
    seeded = ha.process_image("w_128,o_png", str(src))
    src.unlink()
    result = hb.process_image("w_48,h_36,c_1,o_png", str(src))
    return ((seeded.reused_from, result.reused_from == seeded.spec.name,
             counter(mb, 'flyimg_reuse_hits_total{outcome="hit"}')), [pixels(result.content)])


def h_follower_is_brownout_pressure(ns, root):
    (ha, _sa, _ma), (hb, sb, _mb), src, _ = env(ns, root)
    reference = ha.process_image(OPTS, src)
    name = reference.spec.name
    sb.delete(name)
    foreign = hb.l2lease.__class__(sb.shared, "replica-stalled", ttl_s=30.0, poll_s=0.01)
    token = foreign.acquire(name)
    engine = ns.brownout.BrownoutEngine(enabled=True, degraded_at=0.4, lease_ref=2.0,
                                        eval_interval_s=0.0, metrics=ns.MetricsRegistry())
    engine.attach(lease_waiters_fn=lambda: float(hb.l2lease.waiters))
    before = engine.evaluate()
    seen = {}

    def stalled():
        seen["waiters"] = hb.l2lease.waiters
        seen["level"] = engine.evaluate()
        seen["component"] = engine.snapshot()["components"]["l2_lease"]
        sb.shared.write(name, reference.content)
        foreign.release(name, token)

    script_hook(hb.l2lease, [stalled])
    hb.process_image(OPTS, src)
    return (before, seen["waiters"], seen["level"] >= ns.brownout.DEGRADED,
            seen["component"], hb.l2lease.waiters), []


def h_lease_component_absent(ns, root):
    engine = ns.brownout.BrownoutEngine(enabled=True, eval_interval_s=0.0,
                                        metrics=ns.MetricsRegistry())
    absent = "l2_lease" in engine._components()
    engine.attach(lease_waiters_fn=lambda: 5.0)
    share = engine._components()["l2_lease"]
    zero = ns.brownout.BrownoutEngine(enabled=True, lease_ref=0.0, eval_interval_s=0.0,
                                      metrics=ns.MetricsRegistry())
    zero.attach(lease_waiters_fn=lambda: 5.0)
    return (absent, share, "l2_lease" in zero._components()), []


def h_off_is_off(ns, root):
    src = root / "src.png"
    src.write_bytes(png.encode(gradient()))
    params = ns.AppParameters({"tmp_dir": str(root / "off" / "tmp"),
                               "upload_dir": str(root / "off" / "uploads")})
    storage = ns.make_storage(params)
    handler = ns.handler(storage, params, ns.MetricsRegistry())
    off = handler.process_image(OPTS, str(src))
    shared = root / "shared-l2"
    on_handler, on_storage, _ = replica(ns, root, "on", shared, "r1")
    on = on_handler.process_image(OPTS, str(src))
    return ((type(storage).__name__, handler.l2lease, type(on_storage).__name__,
             off.content == on.content,
             any(n.endswith(".lease") for n in os.listdir(shared)),
             sorted(os.listdir(root / "off" / "uploads")) == [off.spec.name]),
            [pixels(off.content)])


HANDLER_CASES = [h_shared_render, h_lease_released, h_hot_key_once, h_foreign_lease_coalesced,
                 h_crashed_leader_stolen, h_wait_deadline_504, h_wait_cap_503,
                 h_torn_rerendered, h_refresh_writes_through, h_cross_replica_reuse,
                 h_follower_is_brownout_pressure, h_lease_component_absent, h_off_is_off]

#: what tests/test_fleet.py pins for each case, on the port
EXPECTED = {
    "shared_render": (False, 1.0, True, True, 0.0, True),
    "lease_released": (False,),
    "hot_key_once": (True, 1.0, 1.0, 1.0, True),
    "foreign_lease_coalesced": (True, True, True, 1.0, 0.0),
    "crashed_leader_stolen": (False, True, 1.0, False, True),
    "wait_deadline_504": ("DeadlineExceededException", True),
    "wait_cap_503": ("ServiceUnavailableException", 1.0, 0),
    "torn_rerendered": (True, False, True, 1.0, True),
    "refresh_writes_through": (False, True),
    "cross_replica_reuse": (None, True, 1.0),
    "follower_is_brownout_pressure": (0, 1, True, 0.5, 0),
    "lease_component_absent": (False, 5.0 / 8.0, False),
    "off_is_off": ("LocalStorage", None, "TieredStorage", True, False, True),
}


@pytest.mark.parametrize("case", HANDLER_CASES, ids=lambda f: f.__name__[2:])
def test_cross_replica_lease_as_the_jax_handlers(tmp_path, case):
    seen = {}
    for name, ns in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        seen[name] = case(ns, root)
    assert seen["torch"][0] == seen["jax"][0] == EXPECTED[case.__name__[2:]]
    assert_pixels_close(seen["torch"][1], seen["jax"][1])


# ---------------------------------------------------------------------------
# HTTP: two replicas of each package, a dead peer and a sick one


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(url, method="GET", headers=None, data=None):
    req = urllib.request.Request(url, method=method, headers=headers or {}, data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def metric(url, name):
    text = http(url + "/metrics")[2].decode()
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def fleet_params(root, sub, replicas, self_url, shared, **extra):
    return {"tmp_dir": str(root / sub / "tmp"), "upload_dir": str(root / sub / "uploads"),
            "debug": True, "batch_deadline_ms": 1.0, "log_access": False,
            "fleet_replicas": replicas, "fleet_replica_id": self_url, "l2_enable": True,
            "l2_upload_dir": str(shared), "retry_base_backoff_s": 0.001,
            "retry_max_backoff_s": 0.002, **extra}


class Sick(BaseHTTPRequestHandler):
    """A peer that sheds every request as 503."""

    def do_GET(self):  # noqa: N802
        body = b"shedding"
        self.send_response(503)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class JaxFleet:
    """Two JAX apps on fixed local ports, served by one event loop on a
    thread of its own."""

    def __init__(self, root, replicas, urls, shared):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.apps, self.clients = [], []
        for i, url in enumerate(urls):
            app, client = self.call(self._start(
                fleet_params(root, f"j{i}", replicas, url, shared), url))
            self.apps.append(app)
            self.clients.append(client)

    @staticmethod
    async def _start(params, url):
        app = make_app(jappconfig.AppParameters(params))
        client = TestClient(TestServer(app, host="127.0.0.1", port=int(url.rsplit(":", 1)[1])))
        await client.start_server()
        return app, client

    def call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(120)

    def routers(self):
        return [app[FLEET_KEY] for app in self.apps]

    def close(self):
        for client in self.clients:
            self.call(client.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        self.loop.close()


class PortFleet:
    def __init__(self, root, replicas, urls, shared):
        self.servers = []
        for i, url in enumerate(urls):
            server = make_server(tappconfig.AppParameters(
                fleet_params(root, f"t{i}", replicas, url, shared)),
                port=int(url.rsplit(":", 1)[1]), device="cpu")
            self.servers.append((server, serve_in_thread(server)))

    def routers(self):
        return [server.fleet for server, _t in self.servers]

    def close(self):
        for server, thread in self.servers:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleets")
    src = root / "src.png"
    src.write_bytes(png.encode(gradient()))
    sick = ThreadingHTTPServer(("127.0.0.1", 0), Sick)
    threading.Thread(target=sick.serve_forever, daemon=True).start()
    dead = f"http://127.0.0.1:{free_port()}"
    sick_url = f"http://127.0.0.1:{sick.server_address[1]}"
    made = {}
    try:
        for name, cls in (("jax", JaxFleet), ("torch", PortFleet)):
            urls = [f"http://127.0.0.1:{free_port()}" for _ in range(2)]
            replicas = urls + [dead, sick_url]
            made[name] = (cls(root, replicas, urls, root / f"{name}-l2"), urls, replicas)
        params = jappconfig.AppParameters({"tmp_dir": str(root / "ref" / "tmp"),
                                           "upload_dir": str(root / "ref" / "uploads")})
        reference = jhandler.ImageHandler(jstorage.make_storage(params), params)
        yield made, str(src), reference
    finally:
        for fleet, _urls, _replicas in made.values():
            fleet.close()
        sick.shutdown()
        sick.server_close()


def owned(replicas, owner, src, template="w_{},h_48,c_1,o_png"):
    for w in range(40, 200):
        options = template.format(w)
        if jfleet.rendezvous_owner(replicas, jfleet.route_key(options, src)) == owner:
            return f"/upload/{options}/{src}"
    raise AssertionError("no candidate key landed on the wanted owner")


COUNTED = ("self", "hop", "proxied", "fallback", "local")


def exchange(fleet_entry, src, owner_index, sender=0, headers=None, template=None):
    """One request on a fleet: (status, the answering replica's index in
    the set, each replica's routing counters' deltas, the misses' deltas,
    the pixels of a 200)."""
    _fleet, urls, replicas = fleet_entry
    path = owned(replicas, replicas[owner_index], src, *(template and [template] or []))

    def snapshot():
        return [[metric(u, f'flyimg_fleet_routed_total{{outcome="{o}"}}') for o in COUNTED]
                + [metric(u, 'flyimg_cache_total{result="miss"}'),
                   metric(u, 'flyimg_cache_total{result="hit"}')] for u in urls]

    before = snapshot()
    status, hdrs, body = http(urls[sender] + path, headers=headers)
    after = snapshot()
    deltas = [[a - b for a, b in zip(x, y)] for x, y in zip(after, before)]
    who = hdrs.get("X-Flyimg-Replica")
    role = replicas.index(who) if who in replicas else who
    pix = pixels(body) if status == 200 and body[:4] == b"\x89PNG" else None
    return status, role, deltas, pix, path


def both_exchange(fleets, *args, **kwargs):
    """``exchange`` on each package's fleet: the same status, answering
    replica and counters. The key each fleet's owner was picked by differs
    (so do the replicas' URLs): the port's answer's pixels are held to the
    JAX package's render of the port's request, on a handler of its own."""
    made, src, reference = fleets
    got = {name: exchange(made[name], src, *args, **kwargs) for name in ("jax", "torch")}
    jax, port = got["jax"], got["torch"]
    assert port[:3] == jax[:3]
    if port[3] is not None:
        options = port[4].split("/")[2]
        assert_pixels_close([port[3]], [pixels(reference.process_image(options, src).content)])
    return port


def test_proxy_routes_to_owner_and_attributes_renderer(fleets):
    status, role, deltas, _p, _h = both_exchange(fleets, 1)
    assert (status, role) == (200, 1)
    assert deltas[0][COUNTED.index("proxied")] == 1 and deltas[1][COUNTED.index("hop")] == 1
    assert deltas[0][len(COUNTED)] == 0            # no pipeline ran on replica 0


def test_self_owned_key_renders_locally(fleets):
    status, role, deltas, _p, _h = both_exchange(fleets, 0)
    assert (status, role, deltas[0][COUNTED.index("self")]) == (200, 0, 1)


def test_hop_header_prevents_proxy_loops(fleets):
    status, role, deltas, _p, _h = both_exchange(
        fleets, 1, headers={tfleet.HOP_HEADER: "somewhere"})
    assert (status, role, deltas[0][COUNTED.index("hop")]) == (200, 0, 1)


def test_owner_down_falls_back_to_local_render(fleets):
    status, role, deltas, _p, _h = both_exchange(fleets, 2)
    assert (status, role, deltas[0][COUNTED.index("fallback")]) == (200, 0, 1)


def test_owner_5xx_falls_back_to_local_render(fleets):
    status, role, deltas, _p, _h = both_exchange(fleets, 3)
    assert (status, role, deltas[0][COUNTED.index("fallback")]) == (200, 0, 1)


def test_proxied_owner_4xx_relays_without_local_render(fleets):
    status, _role, deltas, _p, _h = both_exchange(fleets, 1, template="w_{},sf_bogus,o_jpg")
    assert status == 400
    assert deltas[0][COUNTED.index("proxied")] == 1 and deltas[0][len(COUNTED)] == 0


def test_local_mode_renders_and_shares_through_l2(fleets):
    made, src, _reference = fleets
    for fleet, _u, _r in made.values():
        for router in fleet.routers():
            router.mode = "local"
    try:
        status, role, deltas, _p, _h = both_exchange(fleets, 1, template="w_{},h_49,c_1,o_png")
        assert (status, role, deltas[0][COUNTED.index("local")]) == (200, 0, 1)
        # the render is every replica's: replica 1 answers it as a hit
        status, role, deltas, _p, _h = both_exchange(fleets, 1, sender=1,
                                                     template="w_{},h_49,c_1,o_png")
        assert (status, role) == (200, 1)
        assert deltas[1][len(COUNTED):] == [0, 1]
    finally:
        for fleet, _u, _r in made.values():
            for router in fleet.routers():
                router.mode = "proxy"


def _spans(url, trace_id):
    tree = json.loads(http(f"{url}/debug/traces/{trace_id}")[2])
    out = []

    def walk(node):
        out.append(node)
        for child in node.get("children", ()):
            walk(child)

    for node in tree["spans"]:
        walk(node)
    return out


def test_fleet_route_span_and_the_hop_s_trace(fleets):
    """The caller's trace has a fleet.route span (proxied, to the owner) on
    a root tagged with its replica; the owner adopts the caller's trace with
    its root under that span, tagged with its own replica."""
    made, src, _reference = fleets
    shapes = {}
    for name in ("jax", "torch"):
        _fleet, urls, replicas = made[name]
        path = owned(replicas, urls[1], src, "w_{},h_50,c_1,o_png")
        _status, hdrs, _body = http(urls[0] + path)
        trace_id = hdrs["traceparent"].split("-")[1]
        caller = _spans(urls[0], trace_id)
        route = next(s for s in caller if s["name"] == "fleet.route")
        owner = _spans(urls[1], trace_id)
        shapes[name] = (route["attributes"]["fleet.outcome"],
                        replicas.index(route["attributes"]["fleet.owner"]),
                        replicas.index(caller[0]["attributes"]["fleet.replica_id"]),
                        owner[0]["name"], owner[0]["parent_id"] == route["span_id"],
                        replicas.index(owner[0]["attributes"]["fleet.replica_id"]))
    assert shapes["torch"] == shapes["jax"] == ("proxied", 1, 0, "request", True, 1)


def test_debug_perf_carries_fleet_identity(fleets):
    made, _src, _reference = fleets
    docs = {}
    for name, (_fleet, urls, replicas) in made.items():
        fleet = json.loads(http(urls[0] + "/debug/perf")[2])["fleet"]
        docs[name] = (replicas.index(fleet["replica_id"]), fleet["mode"],
                      [replicas.index(r) for r in fleet["replicas"]])
    assert docs["torch"] == docs["jax"] == (0, "proxy", [0, 1, 2, 3])


def _single(kind, root, settings, requests):
    """``requests`` ((method, path, json body or raw bytes)) against one
    server of ``kind``: (status, body) each, and its router's replicas."""
    params = {"tmp_dir": str(root / kind / "tmp"), "upload_dir": str(root / kind / "up"),
              "log_access": False, **settings}
    if kind == "jax":
        async def go():
            app = make_app(jappconfig.AppParameters(params))
            client = TestClient(TestServer(app))
            await client.start_server()
            out = []
            try:
                for method, path, body in requests:
                    kwargs = ({"data": body} if isinstance(body, bytes)
                              else {"json": body} if body is not None else {})
                    resp = await client.request(method, path, **kwargs)
                    out.append((resp.status, await resp.read()))
            finally:
                await client.close()
            return out, app[FLEET_KEY].replicas

        loop = asyncio.new_event_loop()
        try:
            return loop.run_until_complete(go())
        finally:
            loop.close()
    server = make_server(tappconfig.AppParameters(params), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = []
    try:
        for method, path, body in requests:
            data = body if isinstance(body, bytes) else (
                json.dumps(body).encode() if body is not None else None)
            status, _h, got = http(base + path, method=method, data=data,
                                   headers={"Content-Type": "application/json"})
            out.append((status, got))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return out, server.fleet.replicas


def _both_single(tmp_path, settings, requests):
    jax = _single("jax", tmp_path, settings, requests)
    port = _single("torch", tmp_path, settings, requests)
    assert [s for s, _b in port[0]] == [s for s, _b in jax[0]]
    for (s, jb), (_s, tb) in zip(jax[0], port[0]):
        if s == 200 and jb[:1] == b"{":
            assert json.loads(tb) == json.loads(jb)
    assert port[1] == jax[1]
    return port


def test_debug_fleet_replicas_endpoint_applies_and_validates(tmp_path):
    answers, replicas = _both_single(tmp_path, {
        "debug": True, "fleet_replicas": ["http://r1", "http://r2"],
        "fleet_replica_id": "http://r1", "fleet_route": "local"}, [
        ("POST", "/debug/fleet/replicas", {"replicas": ["http://r1", "http://r2", "http://r3"]}),
        ("GET", "/debug/perf", None),
        ("POST", "/debug/fleet/replicas", {"replicas": ["http://r2", "http://r3"],
                                           "replica_id": "http://r2"}),
        ("POST", "/debug/fleet/replicas", {"replicas": "x"}),
        ("POST", "/debug/fleet/replicas", {"replicas": [1, 2]}),
        ("POST", "/debug/fleet/replicas", b"not json"),
        ("POST", "/debug/fleet/replicas", {"replicas": ["http://a"], "replica_id": 7}),
    ])
    assert [s for s, _b in answers] == [200, 200, 200, 400, 400, 400, 400]
    assert json.loads(answers[1][1])["fleet"]["replicas"] == [
        "http://r1", "http://r2", "http://r3"]
    assert replicas == ["http://r2", "http://r3"]


@pytest.mark.parametrize("settings,status", [
    ({"debug": False}, 404),
    ({"debug": True, "fleet_membership_enable": True, "fleet_replica_id": "http://r1",
      "l2_enable": True}, 400),
])
def test_debug_fleet_replicas_404_without_debug(tmp_path, settings, status):
    """404 with debug off; 400 (the split-brain guard) while membership owns
    the set."""
    if "l2_enable" in settings:
        settings = {**settings, "l2_upload_dir": str(tmp_path / "l2")}
    answers, _r = _both_single(tmp_path, settings, [
        ("POST", "/debug/fleet/replicas", {"replicas": []})])
    assert answers[0][0] == status


def test_debug_off_hides_replica_header_and_fleet_off_has_no_surface(tmp_path):
    src = tmp_path / "src.png"
    src.write_bytes(png.encode(gradient()))
    seen = {}
    for kind in ("jax", "torch"):
        on = {"fleet_replica_id": "r1", "l2_enable": True,
              "l2_upload_dir": str(tmp_path / kind / "l2")}
        for label, settings in (("replica", on), ("off", {"debug": True})):
            reqs = [("GET", f"/upload/w_64,o_png/{src}", None), ("GET", "/metrics", None),
                    ("GET", "/debug/perf", None)]
            if kind == "jax":
                async def go(settings=settings, reqs=reqs, label=label):
                    app = make_app(jappconfig.AppParameters({
                        "tmp_dir": str(tmp_path / kind / label / "t"),
                        "upload_dir": str(tmp_path / kind / label / "u"), **settings}))
                    client = TestClient(TestServer(app))
                    await client.start_server()
                    try:
                        return [(r.status, dict(r.headers), await r.read())
                                for r in [await client.get(p) for _m, p, _b in reqs]]
                    finally:
                        await client.close()

                loop = asyncio.new_event_loop()
                try:
                    answers = loop.run_until_complete(go())
                finally:
                    loop.close()
            else:
                server = make_server(tappconfig.AppParameters({
                    "tmp_dir": str(tmp_path / kind / label / "t"),
                    "upload_dir": str(tmp_path / kind / label / "u"), **settings}),
                    device="cpu")
                thread = serve_in_thread(server)
                base = f"http://127.0.0.1:{server.server_address[1]}"
                try:
                    answers = [http(base + p) for _m, p, _b in reqs]
                finally:
                    server.shutdown()
                    server.server_close()
                    thread.join(timeout=10)
            metrics_text = answers[1][2].decode()
            perf = json.loads(answers[2][2]) if answers[2][0] == 200 else None
            seen[(kind, label)] = (answers[0][0], "X-Flyimg-Replica" in answers[0][1],
                                   "flyimg_fleet_routed_total" in metrics_text,
                                   "flyimg_l2_lease_total" in metrics_text,
                                   perf["fleet"] if perf else answers[2][0])
    for label in ("replica", "off"):
        assert seen[("torch", label)] == seen[("jax", label)]
    assert seen[("torch", "replica")] == (200, False, False, True, 404)
    assert seen[("torch", "off")] == (200, False, False, False, None)


def test_access_log_and_configured_logging_carry_the_replica(caplog):
    from flyimg_tpu.runtime import logging as jlogging
    from flyimg_tpu_torch.runtime import logging as tlogging

    for mod in (jlogging, tlogging):
        with caplog.at_level(logging.INFO, logger=mod.ACCESS_LOGGER):
            mod.access_log(method="GET", path="/upload/x/y", route="upload", status=200,
                           duration_s=0.01, replica="replica-9")
        assert caplog.records[-1].replica == "replica-9"
    import io

    logger = logging.getLogger("flyimg")
    saved = (list(logger.handlers), logger.propagate, logger.level)
    lines = []
    try:
        for mod, params in ((jlogging, jappconfig), (tlogging, tappconfig)):
            stream = io.StringIO()
            mod.configure_logging(params.AppParameters({"fleet_replica_id": "replica-3",
                                                        "log_format": "json"}), stream=stream)
            logging.getLogger("flyimg.fleet").warning("something happened")
            lines.append(json.loads(stream.getvalue().strip().splitlines()[-1])["replica"])
    finally:
        for handler in list(logger.handlers):
            if handler not in saved[0]:
                logger.removeHandler(handler)
        for handler in saved[0]:
            if handler not in logger.handlers:
                logger.addHandler(handler)
        logger.propagate, _ = saved[1], logger.setLevel(saved[2])
    assert lines == ["replica-3", "replica-3"]


# ---------------------------------------------------------------------------
# the port alone


def test_off_is_off_on_the_port_server(tmp_path):
    """Every fleet key at its default: no fleet family on ``/metrics``, no
    fleet field on ``/readyz`` or ``/debug/perf``, no replica header, no
    background thread, and the upload directory holds the answer alone,
    byte for byte an L2-armed replica's."""
    src = tmp_path / "src.png"
    src.write_bytes(png.encode(gradient()))
    threads = {t.name for t in threading.enumerate()}
    answers = {}
    for label, extra in (("off", {}), ("on", {"l2_enable": True,
                                              "l2_upload_dir": str(tmp_path / "l2"),
                                              "fleet_replica_id": "r1"})):
        server = make_server(tappconfig.AppParameters({
            "tmp_dir": str(tmp_path / label / "t"), "upload_dir": str(tmp_path / label / "u"),
            "debug": True, "log_access": False, **extra}), device="cpu")
        thread = serve_in_thread(server)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            answers[label] = [http(base + f"/upload/w_64,h_48,c_1,o_png/{src}"),
                              http(base + "/readyz"), http(base + "/debug/perf"),
                              http(base + "/metrics")]
            if label == "off":
                assert not any(("membership" in t.name or "tier" in t.name
                                or "fleet" in t.name) and t.name not in threads
                               for t in threading.enumerate())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    off = answers["off"]
    assert off[0][0] == 200 and "X-Flyimg-Replica" not in off[0][1]
    assert json.loads(off[1][2]) == {"status": "ok"}
    assert json.loads(off[2][2])["fleet"] is None
    text = off[3][2].decode()
    for family in ("flyimg_fleet_", "flyimg_tier_", "flyimg_membership_",
                   "flyimg_observatory_", "flyimg_l2_"):
        assert family not in text, family
    assert os.listdir(tmp_path / "off" / "u") == os.listdir(tmp_path / "on" / "u")
    assert off[0][2] == answers["on"][0][2]
    assert not os.path.exists(tmp_path / "off" / "l2")


def test_sighup_reload_swaps_the_replica_set(tmp_path):
    """``reload_replicas`` (the SIGHUP path) re-reads the params file's set
    and identity into the router, and is refused while membership owns the
    set; ``install_sighup_reload`` binds it only on the main thread."""
    params_file = tmp_path / "params.json"
    params_file.write_text(json.dumps({"fleet_replicas": ["http://a/", "http://b"],
                                       "fleet_replica_id": "http://b"}))
    server = make_server(tappconfig.AppParameters({
        "tmp_dir": str(tmp_path / "t"), "upload_dir": str(tmp_path / "u")}), device="cpu")
    try:
        assert not server.fleet.enabled
        applied = tapp.reload_replicas(server, str(params_file))
        assert applied == {"replicas": ["http://a", "http://b"], "replica_id": "http://b",
                           "mode": "proxy", "enabled": True, "source": "manual"}
        assert server.fleet.replicas == ["http://a", "http://b"]
        params_file.write_text("{not json")
        assert tapp.reload_replicas(server, str(params_file)) is None
        assert server.fleet.replicas == ["http://a", "http://b"]
        worker = {}
        t = threading.Thread(target=lambda: worker.update(
            bound=tapp.install_sighup_reload(server, str(params_file))))
        t.start()
        t.join()
        assert worker["bound"] is False
    finally:
        server.server_close()
    managed = make_server(tappconfig.AppParameters({
        "tmp_dir": str(tmp_path / "t2"), "upload_dir": str(tmp_path / "u2"),
        "fleet_membership_enable": True, "fleet_replica_id": "http://a", "l2_enable": True,
        "l2_upload_dir": str(tmp_path / "l2")}), device="cpu")
    try:
        params_file.write_text(json.dumps({"fleet_replicas": ["http://x", "http://y"]}))
        assert managed.membership.active
        assert tapp.reload_replicas(managed, str(params_file)) is None
        assert managed.fleet.replicas == []
    finally:
        managed.server_close()
