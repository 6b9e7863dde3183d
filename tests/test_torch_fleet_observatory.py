"""The PyTorch package's fleet observatory and autoscale recommender held
against the JAX package's (``tests/test_fleet_observatory.py``'s cases):

- ``AutoscaleRecommender.decide`` is a pure function: over a seeded grid
  of rollups and a scripted run of decisions through hysteresis, cooldown
  and bounds, both packages' recommenders give exactly the same decisions;
- each scripted sequence of digest publishes, collects, beats, clock steps
  and digest faults runs on both packages' observatories (and their
  memberships), each over a shared directory of its own on one injected
  clock, and gives the same collected digests, rollups, recommendations,
  drains and counters, and the same digest documents with their token and
  timestamps taken out (exact);
- each consumer's ``SignalWindow`` diffs its own launches;
- the server: the observatory off writes no digest and registers no family;
  on, ``/debug/fleet/status`` joins its digests, rollup and recommendation
  with membership and routing, a drain nomination flips ``/readyz``, and
  the route is gated by ``debug``."""

import json
import os
import random
import types
import urllib.error
import urllib.request

import pytest

import flyimg_tpu.appconfig as jappconfig
import flyimg_tpu.runtime.membership as jmembership
import flyimg_tpu.runtime.metrics as jmetrics
import flyimg_tpu.runtime.observatory as jobservatory
import flyimg_tpu.storage.local as jlocal
import flyimg_tpu.storage.tiered as jtiered
import flyimg_tpu.testing.faults as jfaults
import flyimg_tpu_torch.appconfig as tappconfig
import flyimg_tpu_torch.runtime.membership as tmembership
import flyimg_tpu_torch.runtime.metrics as tmetrics
import flyimg_tpu_torch.runtime.observatory as tobservatory
import flyimg_tpu_torch.storage.local as tlocal
import flyimg_tpu_torch.storage.tiered as ttiered
import flyimg_tpu_torch.testing.faults as tfaults
from flyimg_tpu_torch.service.app import make_server, serve_in_thread


def _ns(appconfig, membership, metrics, observatory, local, tiered, faults):
    return types.SimpleNamespace(
        AppParameters=appconfig.AppParameters, FleetMembership=membership.FleetMembership,
        member_slug=membership.member_slug, MetricsRegistry=metrics.MetricsRegistry,
        AutoscaleRecommender=observatory.AutoscaleRecommender,
        FleetObservatory=observatory.FleetObservatory, SignalWindow=observatory.SignalWindow,
        DIGEST_VERSION=observatory.DIGEST_VERSION, LocalStorage=local.LocalStorage,
        digest_name=tiered.digest_name, faults=faults)


PACKAGES = {
    "jax": _ns(jappconfig, jmembership, jmetrics, jobservatory, jlocal, jtiered, jfaults),
    "torch": _ns(tappconfig, tmembership, tmetrics, tobservatory, tlocal, ttiered, tfaults),
}

VOLATILE = ("token", "renewed_at")


class Clock:
    def __init__(self, now=1_000_000.0):
        self.now = float(now)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += float(dt)


class StubRouter:
    def update_replicas(self, replicas, self_id=None, source="manual"):
        return {"replicas": list(replicas)}


def markers(root):
    out = {}
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else ():
        if not name.endswith((".digest", ".member")):
            continue
        with open(os.path.join(root, name), "rb") as fh:
            data = fh.read()
        try:
            out[name] = {k: v for k, v in json.loads(data).items() if k not in VOLATILE}
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
    return seen["torch"][0]


def store(ns, root):
    return ns.LocalStorage(ns.AppParameters({"upload_dir": str(root / "shared")}))


def observatory(ns, st, url, clock, *, ttl=15.0, metrics=None, recommender=None, drain=False):
    membership = ns.FleetMembership(st, url, StubRouter(), enabled=True, ttl_s=ttl,
                                    heartbeat_s=5.0, clock=clock)
    return ns.FleetObservatory(st, url, enabled=True, ttl_s=ttl, membership=membership,
                               metrics=metrics, recommender=recommender, drain_enabled=drain,
                               clock=clock)


def skips(metrics, reason):
    found = metrics._counters.get(f'flyimg_fleet_digest_skipped_total{{reason="{reason}"}}')
    return found.value if found is not None else 0.0


def clean(snapshot):
    """A snapshot's digests without their volatile fields."""
    snapshot = dict(snapshot)
    snapshot["digests"] = {k: {f: v for f, v in d.items() if f not in VOLATILE}
                           for k, d in (snapshot.get("digests") or {}).items()}
    return snapshot


# ---------------------------------------------------------------------------
# the recommender: a pure function


def _rollups(n=400):
    rng = random.Random(27)
    out = []
    for _ in range(n):
        out.append({"routable": rng.choice([0, 1, 2, 3, 4, 5, 8, 9]),
                    "burn_worst": rng.choice([0.0, 0.1, 0.5, 0.7, 0.99, 1.0, 1.5, 3.0]),
                    "occupancy": rng.choice([0.0, 0.1, 0.5, 0.6, 0.85, 0.9, 1.0]),
                    "brownout_worst": rng.choice([0, 1, 2, 3])})
    return out


@pytest.mark.parametrize("settings", [
    {}, {"min_replicas": 1, "max_replicas": 4}, {"min_replicas": 2, "cooldown_s": 0.0},
    {"burn_out": 1.0, "burn_in": 0.5, "occupancy_out": 0.9, "occupancy_in": 0.4,
     "brownout_out": 3, "cooldown_s": 30.0},
    {"burn_in": 2.0, "occupancy_in": 2.0, "min_replicas": 0, "max_replicas": 0},
])
def test_recommender_decides_as_the_jax_recommender(settings):
    """Fresh recommenders answer each rollup of the grid alike, and one
    recommender of each, fed the whole grid at rising times (cooldown
    deferrals included), makes the same sequence of decisions."""
    grid = _rollups()
    for rollup in grid:
        assert (tobservatory.AutoscaleRecommender(**settings).decide(rollup, 0.0)
                == jobservatory.AutoscaleRecommender(**settings).decide(rollup, 0.0))
    ours = tobservatory.AutoscaleRecommender(**settings)
    theirs = jobservatory.AutoscaleRecommender(**settings)
    for t, rollup in enumerate(grid):
        assert ours.decide(rollup, 7.0 * t) == theirs.decide(rollup, 7.0 * t)


PRESSURE = {"routable": 2, "burn_worst": 2.0, "occupancy": 0.2, "brownout_worst": 0}
QUIET = {"routable": 2, "burn_worst": 0.1, "occupancy": 0.1, "brownout_worst": 0}
BETWEEN = {"routable": 2, "burn_worst": 0.7, "occupancy": 0.2, "brownout_worst": 0}


def test_recommender_rules_say_what_the_jax_tests_say():
    R = tobservatory.AutoscaleRecommender
    out = R(min_replicas=1, max_replicas=4).decide(PRESSURE, 0.0)
    assert (out["action"], out["delta"]) == ("scale_out", 1) and "worst burn" in out["reason"]
    capped = R(max_replicas=2).decide(PRESSURE, 0.0)
    assert capped["action"] == "hold" and "max_replicas" in capped["reason"]
    floored = R(min_replicas=2).decide(QUIET, 0.0)
    assert floored["action"] == "hold" and "min_replicas" in floored["reason"]
    assert R().decide({"routable": 2, "burn_worst": 0.0, "occupancy": 0.95,
                       "brownout_worst": 0}, 0.0)["action"] == "scale_out"
    assert "hysteresis" in R(burn_out=1.0, burn_in=0.5).decide(BETWEEN, 0.0)["reason"]
    assert "no live signal digests" in R().decide({"routable": 0}, 0.0)["reason"]
    r = R(cooldown_s=60.0)
    assert [r.decide(x, t)["action"] for x, t in ((PRESSURE, 0.0), (QUIET, 10.0),
                                                  (QUIET, 70.0))] == [
        "scale_out", "hold", "scale_in"]
    r2 = R(cooldown_s=60.0)
    assert [r2.decide(x, t)["action"] for x, t in ((PRESSURE, 0.0), (BETWEEN, 10.0),
                                                   (PRESSURE, 30.0), (PRESSURE, 71.0))] == [
        "scale_out", "hold", "hold", "scale_out"]
    r3 = R(cooldown_s=60.0)
    assert {r3.decide(PRESSURE, t)["action"] for t in (0.0, 5.0, 10.0, 15.0)} == {"scale_out"}


# ---------------------------------------------------------------------------
# digests, rollup, beat and drain


def o_round_trip(ns, root):
    st, clock = store(ns, root), Clock()
    a, b = observatory(ns, st, "http://a:1", clock), observatory(ns, st, "http://b:2", clock)
    published = (a.publish(), b.publish())
    digests = a.collect()
    raw = json.loads(st.read(ns.digest_name(ns.member_slug("http://a:1"))))
    return (published, {k: {f: v for f, v in d.items() if f not in VOLATILE}
                        for k, d in digests.items()}, raw["replica"], ns.DIGEST_VERSION)


def o_stale_excluded(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = observatory(ns, st, "http://a:1", clock, ttl=10.0, metrics=metrics)
    b = observatory(ns, st, "http://b:2", clock, ttl=10.0)
    a.on_beat()
    b.on_beat()
    a.on_beat()
    first = a.snapshot()["rollup"]["replicas"]
    clock.advance(11.0)
    a.on_beat()
    return first, clean(a.snapshot()), skips(metrics, "stale") >= 1.0


def o_corrupt_and_alien(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = observatory(ns, st, "http://a:1", clock, metrics=metrics)
    a.publish()
    st.write(ns.digest_name("b-2"), b"not json")
    for slug, version, replica in (("c-3", ns.DIGEST_VERSION + 1, "http://c:3"),
                                   ("d-4", ns.DIGEST_VERSION, "")):
        st.write(ns.digest_name(slug), json.dumps({
            "v": version, "replica": replica, "renewed_at": clock.now, "ttl_s": 15.0,
            "signals": {}}).encode())
    return sorted(a.collect()), skips(metrics, "corrupt"), skips(metrics, "alien")


def o_skewed_future(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = observatory(ns, st, "http://a:1", clock, ttl=10.0, metrics=metrics)
    a.publish()
    st.write(ns.digest_name("b-2"), json.dumps({
        "v": ns.DIGEST_VERSION, "replica": "http://b:2", "status": "ready",
        "renewed_at": clock.now + 30.0, "ttl_s": 10.0, "signals": {}}).encode())
    out = [sorted(a.collect())]
    for step in (35.0, 11.0):
        clock.advance(step)
        a.publish()
        out.append(sorted(a.collect()))
    return out, skips(metrics, "stale")


def o_publish_failure(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = observatory(ns, st, "http://a:1", clock, metrics=metrics)

    def down(**ctx):
        if ctx.get("op") == "digest":
            raise OSError("digest io down")
        return ns.faults.PASS

    ns.faults.install(ns.faults.FaultInjector().plan("fleet.member", down))
    out = [a.publish(), metrics._counters["flyimg_fleet_digest_failures_total"].value,
           a.snapshot()["publish_failures"]]
    ns.faults.clear()
    return out + [a.publish()]


def o_listing_failure(ns, root):
    st, clock = store(ns, root), Clock()
    a, b = observatory(ns, st, "http://a:1", clock), observatory(ns, st, "http://b:2", clock)
    b.publish()
    a.on_beat()
    first = a.snapshot()["rollup"]["replicas"]

    def down(**ctx):
        if ctx.get("op") == "digest-list":
            raise OSError("enumeration down")
        return ns.faults.PASS

    ns.faults.install(ns.faults.FaultInjector().plan("fleet.member", down))
    a.on_beat()
    return first, clean(a.snapshot())


def o_close_token_checked(ns, root):
    st, clock = store(ns, root), Clock()
    a = observatory(ns, st, "http://a:1", clock)
    a.publish()
    name = ns.digest_name(ns.member_slug("http://a:1"))
    st.write(name, json.dumps({"v": ns.DIGEST_VERSION, "replica": "http://a:1",
                               "token": "foreign", "renewed_at": clock.now, "ttl_s": 15.0,
                               "signals": {}}).encode())
    a.close()
    b = observatory(ns, st, "http://b:2", clock)
    b.publish()
    b.close()
    return st.has(name), st.has(ns.digest_name(ns.member_slug("http://b:2")))


def o_requires_membership(ns, root):
    st = store(ns, root)
    off = ns.FleetMembership(st, "http://a:1", StubRouter(), enabled=False)
    obs = ns.FleetObservatory(st, "http://a:1", enabled=True, membership=off)
    return obs.enabled, obs.publish(), obs.collect()


def o_rollup(ns, root):
    obs = observatory(ns, store(ns, root), "http://a:1", Clock())
    return obs._assemble_rollup({
        "http://a:1": {"status": "ready", "signals": {
            "burn_fast_norm": 0.2, "burn_slow_norm": 0.1, "window_requests": 100.0,
            "occupancy": 0.9, "launches_delta": 30.0, "brownout_level": 0}},
        "http://b:2": {"status": "degraded", "signals": {
            "burn_fast_norm": 1.5, "burn_slow_norm": 0.4, "window_requests": 300.0,
            "occupancy": 0.3, "launches_delta": 10.0, "brownout_level": 2}},
        "http://c:3": {"status": "draining", "signals": {}},
        "http://d:4": {"status": "ready", "signals": {"burn_fast_norm": "x",
                                                      "brownout_level": "y"}},
    })


def o_beat_flips(ns, root):
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    rec = ns.AutoscaleRecommender(min_replicas=1, max_replicas=4, cooldown_s=0.0)
    a = observatory(ns, st, "http://a:1", clock, metrics=metrics, recommender=rec)
    a.on_beat()
    out = [a.snapshot()["recommendation"]]
    st.write(ns.digest_name("b-2"), json.dumps({
        "v": ns.DIGEST_VERSION, "replica": "http://b:2", "status": "ready",
        "renewed_at": clock.now, "ttl_s": 15.0,
        "signals": {"burn_fast_norm": 3.0, "window_requests": 500.0}}).encode())
    a.on_beat()
    out.append(a.snapshot()["recommendation"])
    a.on_beat()
    return out, sorted((k, v.value) for k, v in metrics._counters.items())


def o_scale_in_drains_last(ns, root):
    st, clock = store(ns, root), Clock()
    urls = ("http://a:1", "http://b:2", "http://c:3")
    fleet = {u: observatory(ns, st, u, clock, drain=True, recommender=ns.AutoscaleRecommender(
        min_replicas=1, cooldown_s=0.0)) for u in urls}
    for obs in fleet.values():
        obs.publish()
    actions = []
    for obs in fleet.values():
        obs.on_beat()
        actions.append(obs.snapshot()["recommendation"]["action"])
    return actions, [fleet[u].membership.current_status() for u in urls]


def o_drain_min_replicas(ns, root):
    st, clock = store(ns, root), Clock()
    a, b = (observatory(ns, st, u, clock, drain=True, recommender=ns.AutoscaleRecommender(
        min_replicas=2, cooldown_s=0.0)) for u in ("http://a:1", "http://b:2"))
    a.publish()
    b.publish()
    for obs in (a, b):
        obs.on_beat()
    for obs in (a, b):
        obs._maybe_drain({"ready_members": ["http://a:1", "http://b:2"]})
    return a.membership.current_status(), b.membership.current_status()


def o_drain_disabled(ns, root):
    st, clock = store(ns, root), Clock()
    a = observatory(ns, st, "http://a:1", clock, drain=False,
                    recommender=ns.AutoscaleRecommender(min_replicas=0, cooldown_s=0.0))
    a.publish()
    a.on_beat()
    return a.snapshot()["recommendation"]["action"], a.membership.current_status()


def o_islanded_beat(ns, root):
    """An islanded tier: the beat skips its digest IO (counted by site)
    and labels the previous rollup stale."""
    tier = types.SimpleNamespace(on=False, skips=[])
    tier.islanded = lambda: tier.on
    tier.count_skip = tier.skips.append
    tier.record_success = tier.record_failure = lambda site: None
    st, clock, metrics = store(ns, root), Clock(), ns.MetricsRegistry()
    a = observatory(ns, st, "http://a:1", clock, metrics=metrics)
    a.tier_supervisor = tier
    a.on_beat()
    tier.on = True
    a.on_beat()
    return clean(a.snapshot()), tier.skips, skips(metrics, "island")


def o_from_params(ns, root):
    clock = Clock(5.0)
    params = ns.AppParameters({
        "fleet_observatory_enable": True, "fleet_replica_id": "http://a:1",
        "fleet_membership_ttl_s": 9.0, "fleet_autoscale_min_replicas": 2,
        "fleet_autoscale_max_replicas": 6, "fleet_autoscale_burn_out": 1.5,
        "fleet_autoscale_burn_in": 2.0, "fleet_autoscale_occupancy_out": 0.8,
        "fleet_autoscale_occupancy_in": 0.3, "fleet_autoscale_brownout_out": 3,
        "fleet_autoscale_cooldown_s": 12.0, "fleet_autoscale_drain": True,
        "fleet_observatory_clock": clock})
    membership = ns.FleetMembership(store(ns, root), "http://a:1", StubRouter(), enabled=True,
                                    clock=clock)
    obs = ns.FleetObservatory.from_params(params, storage=store(ns, root), membership=membership)
    rec = obs.recommender
    return (obs.enabled, obs.ttl_s, obs.drain_enabled, rec.min_replicas, rec.max_replicas,
            rec.burn_out, rec.burn_in, rec.occupancy_out, rec.occupancy_in, rec.brownout_out,
            rec.cooldown_s, clean(obs.snapshot()))


SCENARIOS = [o_round_trip, o_stale_excluded, o_corrupt_and_alien, o_skewed_future,
             o_publish_failure, o_listing_failure, o_close_token_checked, o_requires_membership,
             o_rollup, o_beat_flips, o_scale_in_drains_last, o_drain_min_replicas,
             o_drain_disabled, o_islanded_beat, o_from_params]

PINNED = {
    "round_trip": lambda r: r[0] == (True, True) and sorted(r[1]) == ["http://a:1", "http://b:2"]
    and r[1]["http://b:2"]["signals"]["backend"] == "device" and r[2] == "http://a:1",
    "stale_excluded": lambda r: r[0] == 2 and sorted(r[1]["digests"]) == ["http://a:1"]
    and r[1]["rollup"]["replicas"] == 1 and r[2],
    "corrupt_and_alien": lambda r: r == (["http://a:1"], 1.0, 2.0),
    "skewed_future": lambda r: r[0] == [["http://a:1", "http://b:2"]] * 2 + [["http://a:1"]]
    and r[1] == 1.0,
    "publish_failure": lambda r: r == [False, 1.0, 1, True],
    "listing_failure": lambda r: r[0] == 2 and r[1]["rollup"]["replicas"] == 2,
    "close_token_checked": lambda r: r == (True, False),
    "requires_membership": lambda r: r == (False, False, None),
    "rollup": lambda r: r["by_status"] == {"ready": 2, "degraded": 1, "draining": 1}
    and r["routable"] == 3 and r["burn_worst"] == 1.5 and r["ready_members"] == [
        "http://a:1", "http://d:4"],
    "scale_in_drains_last": lambda r: r == (["scale_in"] * 3, ["ready", "ready", "draining"]),
    "drain_min_replicas": lambda r: r == ("ready", "ready"),
    "drain_disabled": lambda r: r == ("scale_in", "ready"),
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_observatory_as_the_jax_package(tmp_path, scenario):
    result = both(tmp_path, scenario)
    check = PINNED.get(scenario.__name__[2:])
    if check is not None:
        assert check(result), result


def test_signal_window_is_per_consumer_as_the_jax_package():
    class Stats:
        total = 0.0

        def stats(self):
            return {"recorded_total": self.total, "mean_occupancy": 0.5}

    stats = Stats()
    registry = types.SimpleNamespace(batch_efficiency=lambda name: stats)
    windows = [cls() for cls in (tobservatory.SignalWindow, tobservatory.SignalWindow,
                                 jobservatory.SignalWindow)]
    for w in windows:
        w.attach(metrics=registry)
        w.assemble()
    stats.total = 10.0
    deltas = [w.assemble()["controllers"]["device"]["launches_delta"] for w in windows]
    assert deltas == [10.0, 10.0, 10.0]


# ---------------------------------------------------------------------------
# the server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _serve(tmp_path, sub, **extra):
    server = make_server(tappconfig.AppParameters({
        "tmp_dir": str(tmp_path / sub / "tmp"), "upload_dir": str(tmp_path / sub / "up"),
        "debug": True, "log_access": False, "l2_enable": True,
        "l2_upload_dir": str(tmp_path / "shared"), "fleet_replica_id": f"http://127.0.0.1:1{sub}",
        "fleet_membership_heartbeat_s": 30.0, **extra}), device="cpu")
    return server, serve_in_thread(server), f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_observatory_off_is_byte_identical_serving(tmp_path):
    server, thread, base = _serve(tmp_path, "off", fleet_membership_enable=True)
    try:
        assert not server.observatory.enabled
        text = _get(base + "/metrics")[1].decode()
        for name in ("flyimg_fleet_replicas", "flyimg_fleet_burn_worst",
                     "flyimg_fleet_burn_weighted", "flyimg_fleet_occupancy",
                     "flyimg_fleet_pressure_level", "flyimg_fleet_autoscale_recommendation",
                     "flyimg_fleet_autoscale_delta", "flyimg_fleet_digest_"):
            assert name not in text
        status = json.loads(_get(base + "/debug/fleet/status")[1])
        assert status["observatory"]["enabled"] is False
        assert status["membership"]["enabled"] is True
    finally:
        _stop(server, thread)
    assert not [n for n in os.listdir(tmp_path / "shared") if n.endswith(".digest")]


def test_fleet_status_joins_digests_rollup_and_membership(tmp_path):
    server, thread, base = _serve(tmp_path, "on", fleet_membership_enable=True,
                                  fleet_observatory_enable=True)
    try:
        replica = server.observatory.replica_id
        status = json.loads(_get(base + "/debug/fleet/status")[1])
        assert replica in status["observatory"]["digests"]
        rollup = status["observatory"]["rollup"]
        assert rollup["replicas"] == 1 and rollup["routable"] == 1
        assert status["observatory"]["recommendation"]["action"] in ("hold", "scale_in")
        assert status["membership"]["members"] == [replica]
        assert status["routing"]["replica_id"] == replica
        text = _get(base + "/metrics")[1].decode()
        assert 'flyimg_fleet_replicas{status="ready"} 1' in text
        assert "flyimg_fleet_autoscale_recommendation" in text
    finally:
        _stop(server, thread)
    assert not [n for n in os.listdir(tmp_path / "shared") if n.endswith(".digest")]


def test_drain_nomination_flips_readyz_and_the_route_is_gated(tmp_path):
    server, thread, base = _serve(tmp_path, "nominated", fleet_membership_enable=True)
    gated, gthread, gbase = _serve(tmp_path, "gated", debug=False)
    try:
        assert _get(base + "/readyz")[0] == 200
        server.membership.begin_drain()
        status, body = _get(base + "/readyz")
        assert status == 503 and json.loads(body)["status"] == "draining"
        assert _get(gbase + "/debug/fleet/status")[0] == 404
    finally:
        _stop(server, thread)
        _stop(gated, gthread)
