"""The PyTorch package's ``FleetMembership`` held against the JAX package's
(``tests/test_fleet_membership.py``'s cases): each scripted sequence of
announces, heartbeats, watches, drains, closes, clock steps and marker
faults runs on both packages' classes, each over a shared directory of its
own on one injected clock, and gives the same views, the same router swaps
and the same keys re-homed (exact), the same marker documents with their
token and timestamps taken out, and the same counters. Then the server:
membership off writes no marker, starts no thread, registers no family
and serves no field; on, it owns the replica set (a manual swap is
refused), walks ``/readyz`` from ready to draining to gone, and the beat
drives warm start's publish and the observatory's beat."""

import json
import logging
import os
import threading
import types
import urllib.error
import urllib.request

import pytest

import flyimg_tpu.appconfig as jappconfig
import flyimg_tpu.runtime.fleet as jfleet
import flyimg_tpu.runtime.membership as jmembership
import flyimg_tpu.runtime.metrics as jmetrics
import flyimg_tpu.storage.local as jlocal
import flyimg_tpu.storage.tiered as jtiered
import flyimg_tpu.testing.faults as jfaults
import flyimg_tpu_torch.appconfig as tappconfig
import flyimg_tpu_torch.runtime.fleet as tfleet
import flyimg_tpu_torch.runtime.membership as tmembership
import flyimg_tpu_torch.runtime.metrics as tmetrics
import flyimg_tpu_torch.storage.local as tlocal
import flyimg_tpu_torch.storage.tiered as ttiered
import flyimg_tpu_torch.testing.faults as tfaults
from flyimg_tpu_torch.service.app import make_server, serve_in_thread


def _ns(appconfig, fleet, membership, metrics, local, tiered, faults):
    return types.SimpleNamespace(
        AppParameters=appconfig.AppParameters, rendezvous_owner=fleet.rendezvous_owner,
        FleetRouter=fleet.FleetRouter, FleetMembership=membership.FleetMembership,
        member_slug=membership.member_slug, MetricsRegistry=metrics.MetricsRegistry,
        LocalStorage=local.LocalStorage, member_name=tiered.member_name,
        MEMBER_PREFIX=tiered.MEMBER_PREFIX, faults=faults)


PACKAGES = {
    "jax": _ns(jappconfig, jfleet, jmembership, jmetrics, jlocal, jtiered, jfaults),
    "torch": _ns(tappconfig, tfleet, tmembership, tmetrics, tlocal, ttiered, tfaults),
}

#: a marker's fields that differ run to run
VOLATILE = ("token", "renewed_at", "started_at")


class Clock:
    def __init__(self, now=1_000_000.0):
        self.now = float(now)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += float(dt)


class StubRouter:
    def __init__(self):
        self.calls = []

    def update_replicas(self, replicas, self_id=None, source="manual"):
        self.calls.append((list(replicas), self_id, source))
        return {"replicas": list(replicas)}


def markers(root):
    out = {}
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else ():
        if not name.endswith(".member"):
            continue
        with open(os.path.join(root, name), "rb") as fh:
            data = fh.read()
        try:
            doc = json.loads(data)
            out[name] = {k: v for k, v in doc.items() if k not in VOLATILE}
        except ValueError:
            out[name] = data
    return out


def both(tmp_path, scenario):
    seen = {}
    for name, ns in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        try:
            result = scenario(ns, root)
        finally:
            ns.faults.clear()
        seen[name] = (result, markers(root / "shared"))
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def store(ns, root):
    return ns.LocalStorage(ns.AppParameters({"upload_dir": str(root / "shared")}))


def member(ns, st, url, clock, *, ttl=15.0, beat=5.0, router=None, supervisor=None,
           warmstart=None, metrics=None, enabled=True):
    return ns.FleetMembership(st, url, router or StubRouter(), enabled=enabled, ttl_s=ttl,
                              heartbeat_s=beat, supervisor=supervisor, warmstart=warmstart,
                              metrics=metrics, clock=clock)


def m_slug(ns, root):
    slug = ns.member_slug("http://10.0.0.1:8080/base")
    return slug, ns.member_name(slug), ns.member_name(slug).startswith(ns.MEMBER_PREFIX)


def m_converge(ns, root):
    st, clock, router = store(ns, root), Clock(), StubRouter()
    a = member(ns, st, "http://a:1", clock, router=router)
    b = member(ns, st, "http://b:2", clock)
    a.announce()
    b.announce()
    return a.watch(), b.watch(), router.calls, a.snapshot()["members"]


def m_skewed_future(ns, root):
    st, clock = store(ns, root), Clock()
    a = member(ns, st, "http://a:1", clock, ttl=10.0)
    a.announce()
    st.write(ns.member_name("b-2"), json.dumps({
        "replica": "http://b:2", "status": "ready", "token": "t",
        "renewed_at": clock.now + 30.0, "ttl_s": 10.0}).encode())
    out = [a.watch()]
    for step in (35.0, 11.0):
        clock.advance(step)
        a._write_marker()
        out.append(a.watch())
    return out


def m_wedged_until_ttl(ns, root):
    st, clock = store(ns, root), Clock()
    a = member(ns, st, "http://a:1", clock)
    b = member(ns, st, "http://b:2", clock)
    a.announce()
    b.announce()
    out = [a.watch()]
    clock.advance(6.0)
    a._write_marker()
    out.append(a.watch())
    out.append([(m.get("replica"), m.get("expired")) for m in a.snapshot()["markers"]])
    clock.advance(10.0)
    a._write_marker()
    out.append(a.watch())
    return out


def m_malformed(ns, root):
    st, clock = store(ns, root), Clock()
    a = member(ns, st, "http://a:1", clock)
    a.announce()
    st.write(ns.member_name("junk"), b"not json")
    st.write(ns.member_name("junk2"), json.dumps(
        {"replica": "http://x:9", "status": "ready", "renewed_at": "soon"}).encode())
    return a.watch()


def m_crash_rehomes_its_keys(ns, root):
    st, clock, router = store(ns, root), Clock(), StubRouter()
    urls = ["http://a:1", "http://b:2", "http://c:3"]
    members = [member(ns, st, u, clock, router=router if u == urls[0] else None) for u in urls]
    for m in members:
        m.announce()
    views = [members[0].watch()]
    keys = [f"key-{i}" for i in range(200)]
    before = {k: ns.rendezvous_owner(urls, k) for k in keys}
    for step in (6.0, 10.0):
        clock.advance(step)
        for m in members[:2]:
            m._write_marker()
        views.append(members[0].watch())
    after = {k: ns.rendezvous_owner(views[-1], k) for k in keys}
    moved = sorted(k for k in keys if before[k] != after[k])
    return views, moved, all(before[k] == urls[2] for k in moved), router.calls[-1]


def m_join_rehomes_to_joiner(ns, root):
    st, clock = store(ns, root), Clock()
    a, b = member(ns, st, "http://a:1", clock), member(ns, st, "http://b:2", clock)
    a.announce()
    b.announce()
    two = a.watch()
    keys = [f"key-{i}" for i in range(200)]
    before = {k: ns.rendezvous_owner(two, k) for k in keys}
    member(ns, st, "http://c:3", clock).announce()
    three = a.watch()
    after = {k: ns.rendezvous_owner(three, k) for k in keys}
    moved = sorted(k for k in keys if before[k] != after[k])
    return three, moved, all(after[k] == "http://c:3" for k in moved)


def m_drain_and_close(ns, root):
    st, clock = store(ns, root), Clock()
    a, b = member(ns, st, "http://a:1", clock), member(ns, st, "http://b:2", clock)
    a.announce()
    b.announce()
    out = [a.watch()]
    b.begin_drain()
    out += [b.current_status(), a.watch(), b.watch(), markers(root / "shared")]
    b.close()
    out.append(sorted(st.list_names(ns.MEMBER_PREFIX)))
    return out


def m_close_leaves_foreign_marker(ns, root):
    st, clock = store(ns, root), Clock()
    a1 = member(ns, st, "http://a:1", clock)
    a1.announce()
    member(ns, st, "http://a:1", clock).announce()
    a1.close()
    return sorted(st.list_names(ns.MEMBER_PREFIX))


def m_duplicate_logs(ns, root):
    st, clock = store(ns, root), Clock()
    a1, a2 = member(ns, st, "http://a:1", clock), member(ns, st, "http://a:1", clock)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("flyimg.fleet")
    handler = Keep(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        a1.announce()
        a2.announce()
        a1.announce()
    finally:
        logger.removeHandler(handler)
    return any("duplicate" in r for r in records)


def m_degraded_not_dead(ns, root):
    sup = types.SimpleNamespace(forced=False)
    sup.cpu_forced = lambda: sup.forced
    st, clock = store(ns, root), Clock()
    a = member(ns, st, "http://a:1", clock, supervisor=sup)
    b = member(ns, st, "http://b:2", clock)
    a.announce()
    b.announce()
    sup.forced = True
    a._write_marker()
    doc = json.loads(st.read(ns.member_name(ns.member_slug("http://a:1"))))
    return doc["status"], a.current_status(), b.watch()


def m_marker_faults(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = member(ns, st, "http://a:1", clock, metrics=metrics)
    member(ns, st, "http://b:2", clock).announce()
    a.announce()
    out = [a.watch()]

    def down(**ctx):
        if ctx.get("op") in ("write", "list"):
            raise OSError("marker io down")
        return ns.faults.PASS

    ns.faults.install(ns.faults.FaultInjector().plan("fleet.member", down))
    out += [a._write_marker(), a._heartbeat_failures,
            metrics._counters["flyimg_fleet_heartbeat_failures_total"].value,
            a.watch(), a.members()]
    ns.faults.clear()
    out.append(a.watch())
    return out


def m_view_staleness(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = member(ns, st, "http://a:1", clock, metrics=metrics)
    clock.advance(3.0)
    out = [a.view_stale_seconds()]
    a.announce()
    out += [a.watch(), a.view_stale_seconds(), a.expired_view()]

    def listing_down(**_ctx):
        raise OSError("listing down")

    ns.faults.install(ns.faults.FaultInjector().plan("fleet.member", listing_down))
    clock.advance(10.0)
    out += [a.watch(), a.view_stale_seconds(), a.expired_view()]
    clock.advance(6.0)
    snap = a.snapshot()
    out += [a.expired_view(), snap["view_stale_seconds"], snap["expired_view"]]
    ns.faults.clear()
    out += ["flyimg_fleet_view_stale_seconds" in metrics._gauges, a.watch(),
            a.view_stale_seconds()]
    off = member(ns, st, "http://a:1", clock, enabled=False)
    clock.advance(1000.0)
    return out + [off.view_stale_seconds(), off.expired_view(), off.active]


def m_beat_drives_publish_and_observatory(ns, root):
    """``step`` heartbeats, watches, then publishes warm start and runs
    the observatory's beat; ``start`` announces with a first observatory
    beat; a failing piggyback never stops the beat."""
    calls = []
    warm = types.SimpleNamespace(maybe_publish=lambda: calls.append("publish"))

    def on_beat():
        calls.append("observatory")
        if len(calls) > 3:
            raise RuntimeError("observatory down")

    st, clock = store(ns, root), Clock()
    a = member(ns, st, "http://a:1", clock, warmstart=warm, beat=3600.0)
    a.observatory = types.SimpleNamespace(on_beat=on_beat)
    a.start()
    try:
        a.step()
        clock.advance(1.0)
        a.step()
    finally:
        a.close()
    return calls, a.members(), sorted(st.list_names(ns.MEMBER_PREFIX))


def m_islanded_tier(ns, root):
    """With the tier supervisor islanded, heartbeats and listings skip
    their IO (counted) and the view freezes; a marker outcome feeds it."""
    tier = types.SimpleNamespace(on=False, skips=[], outcomes=[])
    tier.islanded = lambda: tier.on
    tier.count_skip = tier.skips.append
    tier.record_success = lambda site: tier.outcomes.append(("ok", site))
    tier.record_failure = lambda site: tier.outcomes.append(("fail", site))
    st, clock = store(ns, root), Clock()
    a = member(ns, st, "http://a:1", clock)
    a.tier_supervisor = tier
    a.announce()
    out = [a.watch()]
    tier.on = True
    member(ns, st, "http://b:2", clock).announce()
    a.step()
    out += [a.members(), a._write_marker()]
    a.close()
    return out, tier.skips, tier.outcomes


def m_requires_listing(ns, root):
    m = ns.FleetMembership(object(), "http://a:1", StubRouter(), enabled=True)
    n = ns.FleetMembership(store(ns, root), "", StubRouter(), enabled=True)
    return m.enabled, m.active, n.enabled


def m_from_params(ns, root):
    clock = Clock(42.0)
    params = ns.AppParameters({"fleet_membership_enable": True, "fleet_replica_id": "http://a/",
                               "fleet_membership_ttl_s": 9.0,
                               "fleet_membership_heartbeat_s": 2.0,
                               "fleet_membership_clock": clock})
    router = ns.FleetRouter(["http://a", "http://b"], "http://a")
    m = ns.FleetMembership.from_params(params, storage=store(ns, root), router=router)
    m.announce()
    m.watch()
    return (m.enabled, m.replica_id, m.ttl_s, m.heartbeat_s, router.replicas,
            router.enabled)


SCENARIOS = [m_slug, m_converge, m_skewed_future, m_wedged_until_ttl, m_malformed,
             m_crash_rehomes_its_keys, m_join_rehomes_to_joiner, m_drain_and_close,
             m_close_leaves_foreign_marker, m_duplicate_logs, m_degraded_not_dead,
             m_marker_faults, m_view_staleness, m_beat_drives_publish_and_observatory,
             m_islanded_tier, m_requires_listing, m_from_params]

A, B, C = "http://a:1", "http://b:2", "http://c:3"
#: what tests/test_fleet_membership.py pins, on the port
PINNED = {
    "converge": lambda r: r[0] == r[1] == [A, B] and r[2][-1] == ([A, B], A, "membership"),
    "skewed_future": lambda r: r == [[A, B], [A, B], [A]],
    "wedged_until_ttl": lambda r: r[0] == r[1] == [A, B] and (B, False) in r[2] and r[3] == [A],
    "malformed": lambda r: r == [A],
    "crash_rehomes_its_keys": lambda r: r[0] == [[A, B, C], [A, B, C], [A, B]] and r[1] and r[2],
    "join_rehomes_to_joiner": lambda r: r[0] == [A, B, C] and r[1] and r[2],
    "drain_and_close": lambda r: r[1] == "draining" and r[2] == r[3] == [A] and len(r[5]) == 1,
    "close_leaves_foreign_marker": lambda r: len(r) == 1,
    "duplicate_logs": lambda r: r is True,
    "degraded_not_dead": lambda r: r == ("degraded", "degraded", [A, B]),
    "marker_faults": lambda r: r[1:6] == [False, 1, 1.0, None, [A, B]] and r[6] == [A, B],
    "view_staleness": lambda r: r[:4] == [3.0, [A], 0.0, False] and r[4:7] == [None, 10.0, False]
    and r[7:10] == [True, 16.0, True] and r[10:] == [True, [A], 0.0, 0.0, False, False],
    "beat_drives_publish_and_observatory": lambda r: r[0] == [
        "observatory", "publish", "observatory", "publish", "observatory"],
    "requires_listing": lambda r: r == (False, False, False),
    "from_params": lambda r: r == (True, "http://a", 9.0, 2.0, ["http://a"], False),
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_membership_as_the_jax_package(tmp_path, scenario):
    result, _markers = both(tmp_path, scenario)
    check = PINNED.get(scenario.__name__[2:])
    if check is not None:
        assert check(result), result


# ---------------------------------------------------------------------------
# the server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _server(tmp_path, sub, **extra):
    return make_server(tappconfig.AppParameters({
        "tmp_dir": str(tmp_path / sub / "tmp"), "upload_dir": str(tmp_path / sub / "up"),
        "debug": True, "log_access": False, "l2_enable": True,
        "l2_upload_dir": str(tmp_path / "shared"), "fleet_replica_id": f"http://127.0.0.1:1{sub}",
        **extra}), device="cpu")


def test_membership_off_is_byte_identical_serving(tmp_path):
    server = _server(tmp_path, "off")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert json.loads(_get(base + "/readyz")[1]) == {"status": "ok"}
        text = _get(base + "/metrics")[1].decode()
        for name in ("flyimg_fleet_members", "flyimg_fleet_heartbeat_failures_total",
                     "flyimg_fleet_membership_transitions_total", "flyimg_warmstart_programs_total"):
            assert name not in text
        assert not any(t.name == "flyimg-membership" for t in threading.enumerate())
        assert _post(base + "/debug/fleet/replicas", {"replicas": ["http://x:1", "http://y:2"]}
                     )[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    shared = tmp_path / "shared"
    assert not shared.exists() or not [n for n in os.listdir(shared) if n.endswith(".member")]


def test_membership_on_owns_the_set_and_walks_readiness(tmp_path):
    """As ``test_membership_on_marks_active_and_guards_escape_hatches``:
    /readyz counts one member, a manual swap is refused (400), /debug/fleet
    says ready, the drain answers 503 draining with the marker flipped, and
    closing the server releases the marker and stops the beat."""
    server = _server(tmp_path, "on", fleet_membership_enable=True,
                     fleet_membership_heartbeat_s=30.0)
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    shared = tmp_path / "shared"
    try:
        assert server.membership.active
        assert json.loads(_get(base + "/readyz")[1]) == {"status": "ok", "members": 1}
        status, body = _post(base + "/debug/fleet/replicas",
                             {"replicas": ["http://x:1", "http://y:2"]})
        assert status == 400 and b"membership" in body
        doc = json.loads(_get(base + "/debug/fleet")[1])
        assert doc["status"] == "ready" and doc["members"] == [server.membership.replica_id]
        assert doc["warmstart"]["enabled"] is False
        assert any(t.name == "flyimg-membership" for t in threading.enumerate())
        server.begin_drain()
        status, body = _get(base + "/readyz")
        assert status == 503 and json.loads(body)["status"] == "draining"
        name = tmembership.member_name(tmembership.member_slug(server.membership.replica_id))
        assert json.loads((shared / name).read_bytes())["status"] == "draining"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not [n for n in os.listdir(shared) if n.endswith(".member")]
    assert not any(t.name == "flyimg-membership" and t.is_alive()
                   for t in threading.enumerate())
