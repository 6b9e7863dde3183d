"""The PyTorch package's ``TierSupervisor`` held against the JAX package's
(``tests/test_tier_supervisor.py``'s cases): each scripted sequence of L2
outcomes, island short-circuits, journal writes, probes, replays and scrub
passes runs on both packages' supervisors, each with its own tiered store
over two temporary directories and one injected clock, and gives the same
states and trips, the same island skips by site, the same journal (names,
kinds and stamps), the same re-promotions, the same scrub verdicts, the
same counters and the same files on disk. Exact comparison throughout. Then
the server: off, no family, field or route; on, ``/debug/tier`` and
``/readyz`` answer the supervisor's state, gated by ``debug``."""

import hashlib
import json
import os
import random
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import flyimg_tpu.appconfig as jappconfig
import flyimg_tpu.runtime.metrics as jmetrics
import flyimg_tpu.runtime.tiersupervisor as jtier
import flyimg_tpu.runtime.variantindex as jvariantindex
import flyimg_tpu.storage.local as jlocal
import flyimg_tpu.storage.tiered as jtiered
import flyimg_tpu.testing.faults as jfaults
import flyimg_tpu_torch.appconfig as tappconfig
import flyimg_tpu_torch.runtime.metrics as tmetrics
import flyimg_tpu_torch.runtime.tiersupervisor as ttier
import flyimg_tpu_torch.runtime.variantindex as tvariantindex
import flyimg_tpu_torch.storage.local as tlocal
import flyimg_tpu_torch.storage.tiered as ttiered
import flyimg_tpu_torch.testing.faults as tfaults
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.service.app import make_server, serve_in_thread


def _ns(appconfig, metrics, tier, variantindex, local, tiered, faults):
    return types.SimpleNamespace(
        AppParameters=appconfig.AppParameters, MetricsRegistry=metrics.MetricsRegistry,
        TierSupervisor=tier.TierSupervisor, verify_artifact=tier.verify_artifact,
        probe_name=tier.probe_name, ATTACHED=tier.ATTACHED, ISLAND=tier.ISLAND,
        MANIFEST_VERSION=variantindex.MANIFEST_VERSION, manifest_name=variantindex.manifest_name,
        VariantIndex=variantindex.VariantIndex, LocalStorage=local.LocalStorage,
        TieredStorage=tiered.TieredStorage, L2Lease=tiered.L2Lease,
        checksum_name=tiered.checksum_name, faults=faults)


PACKAGES = {
    "jax": _ns(jappconfig, jmetrics, jtier, jvariantindex, jlocal, jtiered, jfaults),
    "torch": _ns(tappconfig, tmetrics, ttier, tvariantindex, tlocal, ttiered, tfaults),
}


class Clock:
    def __init__(self, now=1000.0):
        self.now = float(now)

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += float(dt)


def files(root):
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            with open(os.path.join(dirpath, name), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = fh.read()
    return out


def counters(metrics):
    return sorted((name, c.value) for name, c in metrics._counters.items())


def both(tmp_path, scenario):
    seen = {}
    for name, ns in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        try:
            result = scenario(ns, root)
        finally:
            ns.faults.clear()
        seen[name] = (result, files(root))
    assert seen["torch"] == seen["jax"]
    return seen["torch"][0]


def local(ns, root):
    return ns.LocalStorage(ns.AppParameters({"upload_dir": str(root)}))


def supervisor(ns, clock=None, *, threshold=3, window_s=10.0, hysteresis=2, metrics=None,
               **kw):
    sup = ns.TierSupervisor(enabled=True, storm_threshold=threshold, storm_window_s=window_s,
                            probe_hysteresis=hysteresis, probe_interval_s=0.05,
                            metrics=metrics, clock=clock or Clock(), **kw)
    sup._ensure_prober = lambda: None     # probes are driven by the scripts
    return sup


def tiered(ns, root, sup, checksum_enable=False):
    l1, l2 = local(ns, root / "l1"), local(ns, root / "l2")
    t = ns.TieredStorage(l1, l2, checksum_enable=checksum_enable)
    t.attach_supervisor(sup)
    sup.attach(storage=t)
    return t, l1, l2


def trip(sup):
    for _ in range(sup.storm_threshold):
        sup.record_failure("storage")
    return sup.islanded()


def snap(sup):
    return sup.snapshot()


def png_bytes(seed=7):
    rng = np.random.default_rng(seed)
    return png.encode(rng.integers(0, 230, (8, 8, 3), dtype=np.uint8))


def s_storm_trips(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics)
    sup.record_failure("storage")
    sup.record_failure("lease")
    states = [sup.state()]
    sup.record_failure("membership")
    return states + [sup.state(), sup.islanded()], snap(sup), counters(metrics)


def s_success_resets(ns, root):
    sup = supervisor(ns)
    for _ in range(5):
        sup.record_failure("storage")
        sup.record_success("storage")
    return sup.state(), snap(sup)


def s_window(ns, root):
    clock = Clock()
    sup = supervisor(ns, clock)
    out = []
    for step in (0.0, 11.0, 11.0):
        clock.advance(step)
        sup.record_failure("storage")
        out.append(sup.state())
    sup.record_failure("storage")
    sup.record_failure("storage")
    return out + [sup.state()], snap(sup)


def s_disabled(ns, root):
    sup = ns.TierSupervisor(enabled=False, clock=Clock())
    for _ in range(20):
        sup.record_failure("storage")
    sup.journal_artifact("a.png")
    sup.journal_manifest("src", {"v": 1})
    return sup.islanded(), sup.state(), sup.journal_snapshot(), snap(sup)


def s_island_short_circuits(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics)
    t, l1, l2 = tiered(ns, root, sup)
    tripped = trip(sup)
    t.write("a.png", b"bytes")
    l2.write("only-l2.png", b"remote")
    out = [tripped, l1.read("a.png"), l2.has("a.png"), sup.journal_snapshot(),
           t.has("only-l2.png"), t.fetch("only-l2.png"), t.stat("only-l2.png")]
    return out, snap(sup), counters(metrics)


def s_island_lease(ns, root):
    sup = supervisor(ns)
    l2 = local(ns, root / "l2")
    lease = ns.L2Lease(l2, "replica-a")
    lease.supervisor = sup
    trip(sup)
    token = lease.acquire("a.png")
    out = [bool(token), list(l2.list_names("")), lease.holder("a.png")]
    lease.release("a.png", token)
    return out + [list(l2.list_names(""))], snap(sup)


def s_pre_trip_journal(ns, root):
    sup = supervisor(ns)
    t, l1, _l2 = tiered(ns, root, sup)

    def boom(**ctx):
        if ctx.get("op") == "write":
            raise OSError("bucket down")
        return ns.faults.PASS

    ns.faults.install(ns.faults.FaultInjector().plan("l2.storage", boom))
    t.write("a.png", b"bytes")
    ns.faults.clear()
    return l1.read("a.png"), sup.journal_snapshot(), sup.state()


def s_journal_dedup(ns, root):
    sup = supervisor(ns)
    sup.journal_artifact("hot.png")
    sup.journal_artifact("hot.png")
    sup.journal_manifest("src", {"v": 1, "variants": {"a": {}}})
    sup.journal_manifest("src", {"v": 1, "variants": {"a": {}, "b": {}}})
    return sup.journal_snapshot()


def s_journal_overflow(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics, journal_max_entries=2)
    for name in ("one.png", "two.png", "three.png"):
        sup.journal_artifact(name)
    return sup.journal_snapshot(), snap(sup)["journal"], counters(metrics)


def s_journal_ttl(ns, root):
    clock, metrics = Clock(), ns.MetricsRegistry()
    sup = supervisor(ns, clock, metrics=metrics, journal_ttl_s=100.0)
    sup.journal_artifact("stale.png")
    clock.advance(101.0)
    sup.journal_artifact("fresh.png")
    return sup._journal_drain(), counters(metrics)


def s_repromote_replays(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics, hysteresis=2)
    t, _l1, l2 = tiered(ns, root, sup, checksum_enable=True)
    trip(sup)
    t.write("a.png", b"island-render")
    sup.journal_manifest("srckey", {"v": ns.MANIFEST_VERSION, "source_mime": "image/png",
                                    "variants": {"w_32": {"stub": True}}})
    out = [sup.probe_and_handle(), sup.state(), l2.has("a.png"), sup.probe_and_handle(),
           sup.state(), l2.read("a.png"), l2.has(ns.checksum_name("a.png")),
           json.loads(l2.read(ns.manifest_name("srckey"))), sup.journal_snapshot(),
           l2.has(ns.probe_name(""))]
    return out, snap(sup), counters(metrics)


def s_manifest_merge(ns, root):
    sup = supervisor(ns, hysteresis=1)
    _t, _l1, l2 = tiered(ns, root, sup)
    trip(sup)
    sup.journal_manifest("srckey", {"v": ns.MANIFEST_VERSION, "source_mime": "image/png",
                                    "variants": {"mine": {"who": "islanded"}}})
    l2.write(ns.manifest_name("srckey"), json.dumps({
        "v": ns.MANIFEST_VERSION, "source_mime": "image/png",
        "variants": {"theirs": {"who": "remote"}}}).encode())
    return sup.probe_and_handle(), sup.state(), json.loads(l2.read(ns.manifest_name("srckey")))


def s_replay_failure_requeues(ns, root):
    sup = supervisor(ns, hysteresis=1)
    t, _l1, l2 = tiered(ns, root, sup)
    trip(sup)
    t.write("a.png", b"bytes")

    def fail_replay(**ctx):
        if ctx.get("op") == "replay":
            raise OSError("still down for big writes")
        return ns.faults.PASS

    ns.faults.install(ns.faults.FaultInjector().plan("l2.storage", fail_replay))
    out = [sup.probe_and_handle(), sup.state(), sup.journal_snapshot(),
           snap(sup)["probe"]["clean_probes"]]
    ns.faults.clear()
    return out + [sup.probe_and_handle(), sup.state(), l2.read("a.png")]


def s_replay_drops_pruned(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics, hysteresis=1)
    _t, _l1, l2 = tiered(ns, root, sup)
    trip(sup)
    sup.journal_artifact("pruned-away.png")
    return sup.probe_and_handle(), sup.state(), l2.has("pruned-away.png"), counters(metrics)


def s_dead_probe_resets(ns, root):
    sup = supervisor(ns, hysteresis=2)
    tiered(ns, root, sup)
    trip(sup)
    out = [sup.probe_and_handle()]

    def boom(**ctx):
        if ctx.get("op") == "probe":
            raise OSError("flapping")
        return ns.faults.PASS

    ns.faults.install(ns.faults.FaultInjector().plan("l2.storage", boom))
    out.append(sup.probe_and_handle())
    ns.faults.clear()
    out += [sup.state(), snap(sup)["probe"]]
    for _ in range(2):
        out += [sup.probe_and_handle(), sup.state()]
    return out


def s_flap_damping(ns, root):
    clock = Clock()
    sup = supervisor(ns, clock, hysteresis=1)
    tiered(ns, root, sup)
    trip(sup)
    out = [sup.probe_and_handle(), sup.state()]
    trip(sup)
    out.append(snap(sup)["probe"]["hysteresis_mult"])
    out += [sup.probe_and_handle(), sup.state(), sup.probe_and_handle(), sup.state()]
    clock.advance(sup.flap_window_s + 1.0)
    trip(sup)
    return out + [snap(sup)["probe"]["hysteresis_mult"], snap(sup)]


def s_probe_unattached(ns, root):
    sup = supervisor(ns)
    out = [sup.probe()]
    trip(sup)
    return out + [sup.probe_and_handle(), snap(sup)["probe"]["last_outcome"]]


def s_probe_torn_read(ns, root):
    class TornL2(ns.LocalStorage):
        def read(self, name):
            return b"not what was written"

    sup = supervisor(ns)
    l2 = TornL2(ns.AppParameters({"upload_dir": str(root / "l2")}))
    sup.attach(storage=ns.TieredStorage(local(ns, root / "l1"), l2))
    return sup.probe()


def s_verify_verdicts(ns, root):
    art = png_bytes()
    good = hashlib.blake2b(art).hexdigest().encode()
    bad = hashlib.blake2b(b"other").hexdigest().encode()
    cases = [("a.png", b"", None), ("a.png", art, None), ("a.jpg", art, None),
             ("blob.xyz", b"arbitrary", None), ("a.png", art, good), ("a.png", art, bad),
             ("a.png", art, b""), ("a.webp", b"RIFF\x00\x00\x00\x00WEBPVP8 ", None),
             ("a.gif", b"GIF89a" + bytes(20), None)]
    return [ns.verify_artifact(*case) for case in cases]


class RecordingIndex:
    def __init__(self):
        self.discarded = []

    def discard_name(self, name):
        self.discarded.append(name)


def s_scrub_purges(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics, scrub_enable=True, scrub_sample=16)
    t, l1, l2 = tiered(ns, root, sup)
    index = RecordingIndex()
    sup.attach(storage=t, variant_index=index)
    t.write("good.png", png_bytes())
    t.write("torn.png", b"\x00garbage that sniffs as nothing")
    l2.write("a.png.lease", b"{}")
    l2.write("fleet-member--x.member", b"{}")
    result = sup.scrub_once()
    return result, l1.has("torn.png"), index.discarded, snap(sup)["scrub"], counters(metrics)


def s_scrub_checksum(ns, root):
    metrics = ns.MetricsRegistry()
    sup = supervisor(ns, metrics=metrics, scrub_enable=True)
    t, _l1, l2 = tiered(ns, root, sup, checksum_enable=True)
    t.write("a.png", png_bytes(1))
    l2.write("a.png", png_bytes(2))
    return sup.scrub_once(), l2.has(ns.checksum_name("a.png")), counters(metrics)


def s_scrub_sample_bound(ns, root):
    sup = supervisor(ns, scrub_enable=True, scrub_sample=3, rng=random.Random(5))
    _t, _l1, l2 = tiered(ns, root, sup)
    for i in range(10):
        l2.write(f"art-{i}.png", png_bytes())
    return sup.scrub_once()["scanned"]


def s_scrub_list_failure(ns, root):
    class DeadList(ns.LocalStorage):
        def list_names(self, prefix):
            raise OSError("bucket down")

    sup = supervisor(ns, scrub_enable=True)
    l2 = DeadList(ns.AppParameters({"upload_dir": str(root / "l2")}))
    sup.attach(storage=ns.TieredStorage(local(ns, root / "l1"), l2))
    return sup.scrub_once(), snap(sup)["storm"]


def s_variant_index_islanded(ns, root):
    """A variant index attached to the supervisor journals its manifest
    writes while islanded (and skips its reads), and the replay merges
    them into the L2."""
    sup = supervisor(ns, hysteresis=1)
    t, _l1, l2 = tiered(ns, root, sup)
    index = ns.VariantIndex(storage=t.shared, clock=Clock())
    index.attach_supervisor(sup)
    trip(sup)
    index._sources["src"] = index._state_from_doc(
        {"v": ns.MANIFEST_VERSION, "source_mime": "image/png", "variants": {}}, 0.0)
    index._persist("src")
    out = [index.lookup("other"), [e["kind"] for e in sup.journal_snapshot()],
           l2.has(ns.manifest_name("src"))]
    out += [sup.probe_and_handle(), json.loads(l2.read(ns.manifest_name("src")))]
    index.discard_name("nothing")
    return out, snap(sup)["island_skips"]


def s_from_params(ns, root):
    clock = Clock(7.0)
    sup = ns.TierSupervisor.from_params(ns.AppParameters({
        "tier_supervisor_enable": True, "tier_storm_threshold": 4, "tier_storm_window_s": 9.0,
        "tier_probe_interval_s": 2.0, "tier_probe_hysteresis": 3,
        "tier_journal_max_entries": 7, "tier_journal_ttl_s": 11.0, "tier_scrub_enable": True,
        "tier_scrub_interval_s": 13.0, "tier_scrub_sample": 5, "fleet_replica_id": "r9",
        "tier_supervisor_clock": clock}))
    return snap(sup), sup.replica_id, sup.flap_window_s


SCENARIOS = [s_storm_trips, s_success_resets, s_window, s_disabled, s_island_short_circuits,
             s_island_lease, s_pre_trip_journal, s_journal_dedup, s_journal_overflow,
             s_journal_ttl, s_repromote_replays, s_manifest_merge, s_replay_failure_requeues,
             s_replay_drops_pruned, s_dead_probe_resets, s_flap_damping, s_probe_unattached,
             s_probe_torn_read, s_verify_verdicts, s_scrub_purges, s_scrub_checksum,
             s_scrub_sample_bound, s_scrub_list_failure, s_variant_index_islanded,
             s_from_params]

#: what tests/test_tier_supervisor.py pins, on the port
PINNED = {
    "storm_trips": lambda r: r[0] == ["attached", "island", True]
    and r[1]["storm"]["last_failure_site"] == "membership"
    and ('flyimg_tier_transitions_total{to="island"}', 1.0) in r[2],
    "success_resets": lambda r: r[0] == "attached",
    "window": lambda r: r[0] == ["attached"] * 3 + ["island"],
    "island_short_circuits": lambda r: r[0][:3] == [True, b"bytes", False]
    and [e["name"] for e in r[0][3]] == ["a.png"] and r[0][4:] == [False, None, None]
    and r[1]["island_skips"] >= 4,
    "island_lease": lambda r: r[0] == [True, [], None, []],
    "journal_overflow": lambda r: [e["name"] for e in r[0]] == ["two.png", "three.png"]
    and r[1]["dropped"] == 1,
    "journal_ttl": lambda r: [e["name"] for e in r[0]] == ["fresh.png"],
    "repromote_replays": lambda r: r[0][:7] == [True, "island", False, True, "attached",
                                                b"island-render", True]
    and r[0][7]["variants"] == {"w_32": {"stub": True}} and r[0][8] == [],
    "manifest_merge": lambda r: r[:2] == (True, "attached")
    and set(r[2]["variants"]) == {"mine", "theirs"},
    "replay_failure_requeues": lambda r: r[:2] == [True, "island"] and r[3] == 0
    and r[4:] == [True, "attached", b"bytes"],
    "dead_probe_resets": lambda r: r[:3] == [True, False, "island"]
    and r[4:] == [True, "island", True, "attached"],
    "flap_damping": lambda r: r[:7] == [True, "attached", 2, True, "island", True, "attached"]
    and r[7] == 1,
    "probe_unattached": lambda r: r == [(False, "unattached"), False, "unattached"],
    "probe_torn_read": lambda r: r == (False, "torn-read"),
    "verify_verdicts": lambda r: r[:7] == ["empty", None, "magic", None, None, "checksum", None],
    "scrub_purges": lambda r: r[0] == {"scanned": 2, "purged": 1, "unreadable": 0}
    and r[1] is False and r[2] == ["torn.png"],
    "scrub_checksum": lambda r: r[0]["purged"] == 1 and r[1] is False,
    "scrub_sample_bound": lambda r: r == 3,
    "scrub_list_failure": lambda r: r[0] == {"scanned": 0, "purged": 0, "unreadable": 0}
    and r[1]["consecutive_failures"] == 1,
}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_tier_supervisor_as_the_jax_package(tmp_path, scenario):
    result = both(tmp_path, scenario)
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


def _serve(tmp_path, sub, **extra):
    server = make_server(tappconfig.AppParameters({
        "tmp_dir": str(tmp_path / sub / "t"), "upload_dir": str(tmp_path / sub / "u"),
        "batch_deadline_ms": 1.0, "log_access": False, **extra}), device="cpu")
    return server, serve_in_thread(server), f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_default_off_is_byte_identical(tmp_path):
    rng = np.random.default_rng(11)
    src = tmp_path / "src.png"
    src.write_bytes(png.encode(rng.integers(0, 230, (48, 64, 3), dtype=np.uint8)))
    server, thread, base = _serve(tmp_path, "plain")
    try:
        assert server.handler.variants._supervisor is None
        assert json.loads(_get(base + "/readyz")[1]) == {"status": "ok"}
        assert _get(f"{base}/upload/w_32,o_png/{src}")[0] == 200
        assert "flyimg_tier_" not in _get(base + "/metrics")[1].decode()
        assert _get(base + "/debug/tier")[0] == 404
    finally:
        _stop(server, thread)


def test_debug_tier_gated_and_snapshots(tmp_path):
    gated = _serve(tmp_path, "gated", tier_supervisor_enable=True)
    on = _serve(tmp_path, "on", debug=True, tier_supervisor_enable=True)
    try:
        assert _get(gated[2] + "/debug/tier")[0] == 404
        status, body = _get(on[2] + "/debug/tier")
        doc = json.loads(body)
        assert status == 200 and doc["enabled"] is True and doc["state"] == "attached"
        assert doc["storm"]["threshold"] == 5 and doc["journal"]["depth"] == 0
        assert json.loads(_get(on[2] + "/readyz")[1])["tier"] == "attached"
        text = _get(on[2] + "/metrics")[1].decode()
        assert "flyimg_tier_attached 1" in text and "flyimg_tier_journal_depth 0" in text
        sup = on[0].tier_supervisor
        with sup._lock:
            sup._state = ttier.ISLAND
        assert json.loads(_get(on[2] + "/readyz")[1])["tier"] == "island"
        assert "flyimg_tier_attached 0" in _get(on[2] + "/metrics")[1].decode()
        assert on[0].handler.variants._supervisor is sup
    finally:
        _stop(*gated[:2])
        _stop(*on[:2])


def test_snapshot_shape_as_the_jax_package():
    docs = [ns.TierSupervisor(enabled=True, clock=Clock()).snapshot()
            for ns in PACKAGES.values()]
    assert docs[0] == docs[1]
    assert set(docs[1]) == {"enabled", "state", "state_age_s", "storm", "probe", "journal",
                            "scrub", "island_skips", "trips", "repromotions"}
    json.dumps(docs[1])
