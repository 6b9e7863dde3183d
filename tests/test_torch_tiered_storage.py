"""The PyTorch package's ``TieredStorage`` and ``L2Lease`` held against the
JAX package's: each scripted sequence of operations runs on both packages'
classes, each over two temporary directories of its own (L1 and L2), and
gives the same results, the same files with the same bytes on disk
(checksum sidecars included), the same lease outcomes and the same lease
marker documents with their random token and their timestamp taken out.
Exact comparison throughout; the scenarios are the cases of
``tests/test_tiered_storage.py``, the checksum sidecars, the journal's
``replay_to_l2``, the ``l2.storage`` fault point and the tier supervisor's
island short-circuits."""

import json
import os
import types

import pytest

import flyimg_tpu.appconfig as jappconfig
import flyimg_tpu.runtime.metrics as jmetrics
import flyimg_tpu.storage as jstorage
import flyimg_tpu.storage.base as jbase
import flyimg_tpu.storage.local as jlocal
import flyimg_tpu.storage.tiered as jtiered
import flyimg_tpu.testing.faults as jfaults
import flyimg_tpu_torch.appconfig as tappconfig
import flyimg_tpu_torch.runtime.metrics as tmetrics
import flyimg_tpu_torch.storage as tstorage
import flyimg_tpu_torch.storage.base as tbase
import flyimg_tpu_torch.storage.local as tlocal
import flyimg_tpu_torch.storage.tiered as ttiered
import flyimg_tpu_torch.testing.faults as tfaults


def _ns(appconfig, metrics, storage, base, local, tiered, faults):
    return types.SimpleNamespace(
        AppParameters=appconfig.AppParameters, MetricsRegistry=metrics.MetricsRegistry,
        make_storage=storage.make_storage, Storage=base.Storage,
        StorageStat=base.StorageStat, LocalStorage=local.LocalStorage,
        TieredStorage=tiered.TieredStorage, L2Lease=tiered.L2Lease,
        lease_name=tiered.lease_name, checksum_name=tiered.checksum_name,
        faults=faults)


PACKAGES = {
    "jax": _ns(jappconfig, jmetrics, jstorage, jbase, jlocal, jtiered, jfaults),
    "torch": _ns(tappconfig, tmetrics, tstorage, tbase, tlocal, ttiered, tfaults),
}

#: the lease marker's fields that differ run to run
VOLATILE = ("token", "acquired_at")


def disk(root):
    """Every file under ``root``: relative path -> bytes, a lease marker's
    document with its volatile fields taken out."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                data = fh.read()
            if name.endswith(".lease"):
                try:
                    doc = json.loads(data)
                    data = {k: v for k, v in doc.items() if k not in VOLATILE}
                except ValueError:
                    pass
            out[os.path.relpath(path, root)] = data
    return out


def both(tmp_path, scenario):
    """``scenario(ns, root)``'s result and the files it left, for each
    package; the pair held equal."""
    seen = {}
    for name, ns in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        try:
            result = scenario(ns, root)
        finally:
            ns.faults.clear()
        seen[name] = (result, disk(root))
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def local(ns, root):
    return ns.LocalStorage(ns.AppParameters({"upload_dir": str(root)}))


def tiered(ns, root, metrics=None, **kw):
    l1, l2 = local(ns, root / "l1"), local(ns, root / "l2")
    return ns.TieredStorage(l1, l2, metrics=metrics, **kw), l1, l2


def counters(metrics, *names):
    return [metrics._counters[n].value if n in metrics._counters else 0.0 for n in names]


def attempt(fn):
    try:
        return ("ok", fn())
    except Exception as exc:
        return ("raise", type(exc).__name__)


# ---------------------------------------------------------------------------
# TieredStorage


def s_l1_hit(ns, root):
    t, l1, l2 = tiered(ns, root)
    l1.write("a.png", b"l1-bytes")
    l2.write("a.png", b"l2-bytes")
    data, stat = t.fetch("a.png")
    return data, stat.mtime is not None


def s_l2_hit_promotes(ns, root):
    metrics = ns.MetricsRegistry()
    t, l1, l2 = tiered(ns, root, metrics)
    l2.write("a.png", b"shared-bytes")
    before = l1.has("a.png")
    data, _ = t.fetch("a.png")
    return before, data, l1.read("a.png"), counters(metrics, "flyimg_l2_promotions_total")


def s_both_miss(ns, root):
    return tiered(ns, root)[0].fetch("missing.png")


def s_write_through(ns, root):
    t, l1, l2 = tiered(ns, root)
    return t.write("a.png", b"bytes") is not None, l1.read("a.png"), l2.read("a.png")


def s_write_l2_failure(ns, root):
    class BrokenWrite(ns.LocalStorage):
        def write(self, name, data):
            raise OSError("bucket down")

    metrics = ns.MetricsRegistry()
    l1 = local(ns, root / "l1")
    l2 = BrokenWrite(ns.AppParameters({"upload_dir": str(root / "l2")}))
    t = ns.TieredStorage(l1, l2, metrics=metrics)
    return (t.write("a.png", b"bytes") is not None, l1.read("a.png"),
            counters(metrics, "flyimg_l2_writethrough_failures_total"))


def s_delete_both(ns, root):
    t, l1, l2 = tiered(ns, root)
    t.write("a.png", b"bytes")
    t.delete("a.png")
    out = (l1.has("a.png"), l2.has("a.png"))
    t.delete("a.png")
    return out


def broken_l2(ns, root):
    class BrokenL2(ns.LocalStorage):
        def has(self, name):
            raise OSError("bucket down")

        def stat(self, name):
            raise OSError("bucket down")

        def delete(self, name):
            raise OSError("bucket down")

    l1 = local(ns, root / "l1")
    l2 = BrokenL2(ns.AppParameters({"upload_dir": str(root / "l2")}))
    return ns.TieredStorage(l1, l2), l1, l2


def s_has_l2_failure(ns, root):
    t, l1, _ = broken_l2(ns, root)
    l1.write("a.png", b"x")
    return t.has("a.png"), t.has("missing.png")


def s_stat_l2_failure(ns, root):
    t, l1, _ = broken_l2(ns, root)
    l1.write("a.png", b"x")
    return t.stat("a.png") is not None, t.stat("missing.png")


def s_delete_l2_failure(ns, root):
    t, l1, l2 = broken_l2(ns, root)
    l1.write("a.png", b"x")
    ns.LocalStorage.write(l2, "a.png", b"x")
    t.delete("a.png")
    return l1.has("a.png"), ns.LocalStorage.has(l2, "a.png")


def s_delete_l1_failure(ns, root):
    class BrokenL1(ns.LocalStorage):
        def delete(self, name):
            raise OSError("disk fault")

    l1 = BrokenL1(ns.AppParameters({"upload_dir": str(root / "l1")}))
    l2 = local(ns, root / "l2")
    t = ns.TieredStorage(l1, l2)
    l2.write("a.png", b"x")
    return attempt(lambda: t.delete("a.png")), l2.has("a.png")


def s_read_never_promotes(ns, root):
    t, l1, l2 = tiered(ns, root)
    l2.write("m.variants.json", b"{}")
    return t.read("m.variants.json"), l1.has("m.variants.json")


def s_stat_has_fall_through(ns, root):
    t, _, l2 = tiered(ns, root)
    before = (t.has("a.png"), t.stat("a.png"))
    l2.write("a.png", b"x")
    return before, t.has("a.png"), t.stat("a.png") is not None


def s_shared(ns, root):
    t, _, l2 = tiered(ns, root)
    plain = local(ns, root / "plain")
    return t.shared is l2, plain.shared is plain


def s_prune(ns, root):
    t, l1, _ = tiered(ns, root)
    t.write("a.png", b"x" * 100)
    summary = t.prune(10)

    class NoPrune(ns.Storage):
        def has(self, name):
            return False

        def read(self, name):
            raise FileNotFoundError(name)

        def write(self, name, data):
            return None

        def delete(self, name):
            pass

        def public_url(self, name, request_base=None):
            return name

    no_prune = ns.TieredStorage(NoPrune(), local(ns, root / "x"))
    return (summary["deleted"], summary["kept"], l1.has("a.png"),
            hasattr(no_prune, "prune"))


def s_make_storage(ns, root):
    on = ns.make_storage(ns.AppParameters({
        "upload_dir": str(root / "l1"), "l2_enable": True,
        "l2_upload_dir": str(root / "shared"), "l2_checksum_enable": True}))
    on.write("a.png", b"x")
    off = ns.make_storage(ns.AppParameters({"upload_dir": str(root / "solo")}))
    return (type(on).__name__, type(on.shared).__name__, on.checksum_enable,
            type(off).__name__, off.shared is off)


def s_hedged(ns, root):
    t, _, l2 = tiered(ns, root)
    l2.write("a.png", b"bytes")
    data, stat = t.fetch_hedged("a.png")
    return data, isinstance(stat, ns.StorageStat)


def s_checksums(ns, root):
    """Sidecars beside each L2 write (never of a sidecar), gone with the
    artifact, none with checksums off."""
    t, _, l2 = tiered(ns, root, checksum_enable=True)
    t.write("a.png", b"artifact-bytes")
    t.write(ns.checksum_name("b.png"), b"not-a-sidecar's-sidecar")
    sidecar = l2.read(ns.checksum_name("a.png"))
    t.delete("a.png")
    off, _, off_l2 = tiered(ns, root / "off")
    off.write("a.png", b"x")
    return sidecar, l2.has(ns.checksum_name("a.png")), off_l2.has(ns.checksum_name("a.png"))


def s_replay(ns, root):
    t, l1, l2 = tiered(ns, root, checksum_enable=True)
    l1.write("a.png", b"journaled")
    return t.replay_to_l2("a.png"), t.replay_to_l2("gone.png"), l2.read("a.png")


def s_fault_point(ns, root):
    """A raising l2.storage plan: reads serve as misses, writes stay on the
    L1 (counted), deletes leave the L2 copy; the plan sees each op."""
    seen = []

    def down(**ctx):
        seen.append(ctx["op"])
        raise OSError("injected")

    metrics = ns.MetricsRegistry()
    t, l1, l2 = tiered(ns, root, metrics)
    l2.write("b.png", b"shared")
    injector = ns.faults.FaultInjector()
    injector.plan("l2.storage", down)
    ns.faults.install(injector)
    out = [t.fetch("b.png"), t.has("b.png"), t.stat("b.png"),
           t.write("c.png", b"x") is not None]
    t.delete("b.png")
    out.append(attempt(lambda: t.replay_to_l2("c.png")))
    return out, seen, l2.has("b.png"), counters(
        metrics, "flyimg_l2_writethrough_failures_total", "flyimg_l2_promotions_total")


class Island:
    """A tier supervisor stand-in holding the island: every short-circuit
    counts its op, every journaled name is kept."""

    def __init__(self, islanded=True):
        self.on = islanded
        self.skips, self.journal, self.outcomes = [], [], []

    def islanded(self):
        return self.on

    def count_skip(self, op):
        self.skips.append(op)

    def journal_artifact(self, name):
        self.journal.append(name)

    def record_success(self, site):
        self.outcomes.append(("ok", site))

    def record_failure(self, site):
        self.outcomes.append(("fail", site))


def s_islanded(ns, root):
    t, l1, l2 = tiered(ns, root)
    l2.write("b.png", b"shared")
    sup = Island()
    t.attach_supervisor(sup)
    out = [t.fetch("b.png"), t.has("b.png"), t.stat("b.png"), t.write("c.png", b"x") is not None,
           attempt(lambda: t.read("b.png"))]
    t.delete("b.png")
    sup.on = False
    out.append(t.fetch("b.png")[0])
    return out, sup.skips, sup.journal, sup.outcomes, l2.has("c.png")


TIERED = [s_l1_hit, s_l2_hit_promotes, s_both_miss, s_write_through, s_write_l2_failure,
          s_delete_both, s_has_l2_failure, s_stat_l2_failure, s_delete_l2_failure,
          s_delete_l1_failure, s_read_never_promotes, s_stat_has_fall_through, s_shared,
          s_prune, s_make_storage, s_hedged, s_checksums, s_replay, s_fault_point,
          s_islanded]


@pytest.mark.parametrize("scenario", TIERED, ids=lambda f: f.__name__[2:])
def test_tiered_storage_as_the_jax_package(tmp_path, scenario):
    both(tmp_path, scenario)


def test_tiered_scenarios_say_what_the_jax_tests_say(tmp_path):
    """The pinned values of ``tests/test_tiered_storage.py`` on the port."""
    ns = PACKAGES["torch"]

    def run(scenario):
        root = tmp_path / scenario.__name__
        root.mkdir()
        return scenario(ns, root)

    assert run(s_l1_hit) == (b"l1-bytes", True)
    assert run(s_l2_hit_promotes) == (False, b"shared-bytes", b"shared-bytes", [1.0])
    assert run(s_write_l2_failure) == (True, b"bytes", [1.0])
    assert run(s_delete_both) == (False, False)
    assert run(s_delete_l2_failure) == (False, True)
    assert run(s_delete_l1_failure) == (("raise", "OSError"), True)
    assert run(s_prune) == (1, 0, False, False)
    assert run(s_make_storage) == ("TieredStorage", "LocalStorage", True, "LocalStorage", True)
    islanded = run(s_islanded)
    assert islanded[1] == ["read", "has", "stat", "write", "read", "delete"]
    assert islanded[2] == ["c.png"] and islanded[4] is False


# ---------------------------------------------------------------------------
# L2Lease


def lease(ns, store, replica="r1", **kw):
    kw.setdefault("ttl_s", 5.0)
    kw.setdefault("poll_s", 0.01)
    return ns.L2Lease(store, replica, **kw)


def s_lease_hold_release(ns, root):
    store = local(ns, root)
    ls = lease(ns, store)
    token = ls.acquire("a.png")
    held = (token is not None, ls.holder("a.png"), store.has(ns.lease_name("a.png")),
            disk(root))
    ls.release("a.png", token)
    return held, ls.holder("a.png"), store.has(ns.lease_name("a.png"))


def s_lease_second_fails(ns, root):
    store = local(ns, root)
    leader, follower = lease(ns, store, "r1"), lease(ns, store, "r2")
    token = leader.acquire("a.png")
    second = follower.acquire("a.png")
    leader.release("a.png", token)
    return token is not None, second, follower.acquire("a.png") is not None


def s_lease_expired_stolen(ns, root):
    store = local(ns, root)
    now = [1000.0]
    crashed = lease(ns, store, "r1", clock=lambda: now[0], ttl_s=10.0)
    first = crashed.acquire("a.png") is not None
    thief = lease(ns, store, "r2", clock=lambda: now[0], ttl_s=10.0)
    live = thief.acquire("a.png")
    now[0] += 10.1
    return first, live, thief.acquire("a.png") is not None, thief.holder("a.png")


def s_lease_malformed(ns, root):
    store = local(ns, root)
    store.write(ns.lease_name("a.png"), b"not-json{")
    ls = lease(ns, store)
    a = ls.acquire("a.png") is not None
    store.write(ns.lease_name("b.png"),
                json.dumps({"owner": "x", "acquired_at": "garbage"}).encode())
    return a, ls.acquire("b.png") is not None


def s_lease_stale_release(ns, root):
    store = local(ns, root)
    now = [0.0]
    old = lease(ns, store, "r1", clock=lambda: now[0], ttl_s=1.0)
    old_token = old.acquire("a.png")
    now[0] += 2.0
    thief = lease(ns, store, "r2", clock=lambda: now[0], ttl_s=10.0)
    stolen = thief.acquire("a.png") is not None
    old.release("a.png", old_token)
    return stolen, thief.holder("a.png")


def s_lease_race(ns, root):
    store = local(ns, root)
    now = [0.0]
    lease(ns, store, "r0", clock=lambda: now[0], ttl_s=0.5).acquire("a.png")
    now[0] += 1.0
    lease_b = lease(ns, store, "r2", clock=lambda: now[0] + 31.0, ttl_s=30.0)
    results = {}

    class Interleaved(ns.LocalStorage):
        armed = True

        def write(self, name, data):
            out = super().write(name, data)
            if self.armed and name == ns.lease_name("a.png"):
                self.armed = False
                results["b"] = lease_b.acquire("a.png")
            return out

    store_a = Interleaved(ns.AppParameters({"upload_dir": str(root)}))
    results["a"] = lease(ns, store_a, "r1", clock=lambda: now[0], ttl_s=30.0).acquire("a.png")
    return results["a"] is None, results["b"] is not None


def s_lease_confirm_blind(ns, root):
    class ConfirmBlind(ns.LocalStorage):
        wrote_marker = False

        def write(self, name, data):
            out = super().write(name, data)
            if name.endswith(".lease"):
                self.wrote_marker = True
            return out

        def read(self, name):
            if self.wrote_marker and name.endswith(".lease"):
                raise OSError("transient L2 read error")
            return super().read(name)

    store = ConfirmBlind(ns.AppParameters({"upload_dir": str(root)}))
    return lease(ns, store).acquire("a.png") is not None


def s_lease_write_failure(ns, root):
    class NoMarkers(ns.LocalStorage):
        def write(self, name, data):
            if name.endswith(".lease"):
                raise OSError("read-only bucket")
            return super().write(name, data)

    store = NoMarkers(ns.AppParameters({"upload_dir": str(root)}))
    ls = lease(ns, store)
    sup = Island(islanded=False)
    ls.supervisor = sup
    return ls.acquire("a.png") is not None, sup.outcomes


def s_lease_from_params(ns, root):
    params = ns.AppParameters({"fleet_replica_id": "replica-7", "l2_lease_ttl_s": 12.0,
                               "l2_lease_poll_ms": 5.0, "l2_lease_wait_cap_s": 33.0})
    ls = ns.L2Lease.from_params(params, storage=local(ns, root))
    return ls.replica_id, ls.ttl_s, round(ls.poll_s, 9), ls.wait_cap_s


def s_lease_names(ns, root):
    store = local(ns, root)
    ls = lease(ns, store)
    token = ls.acquire("abc.png")
    store.write("abc.png", b"artifact")
    ls.release("abc.png", token)
    return ns.lease_name("abc.png"), store.read("abc.png")


def s_lease_waiters_and_faults(ns, root):
    """The follower count, the l2.lease fault point (a raising confirm
    claims leadership), and an islanded lease claiming it with no IO."""
    store = local(ns, root)
    ls = lease(ns, store)
    ls.begin_wait()
    ls.begin_wait()
    ls.end_wait()
    waiting = ls.waiters
    ls.end_wait()
    ls.end_wait()
    ops = []

    def blind(**ctx):
        ops.append(ctx["op"])
        if ctx["op"] == "confirm":
            raise OSError("injected")
        return ns.faults.PASS

    injector = ns.faults.FaultInjector()
    injector.plan("l2.lease", blind)
    ns.faults.install(injector)
    led = ls.acquire("f.png") is not None
    ns.faults.clear()
    sup = Island()
    ls.supervisor = sup
    islanded = (ls.acquire("g.png") is not None, ls.holder("g.png"))
    ls.release("g.png", "token")
    return waiting, ls.waiters, led, ops, islanded, sup.skips


LEASE = [s_lease_hold_release, s_lease_second_fails, s_lease_expired_stolen, s_lease_malformed,
         s_lease_stale_release, s_lease_race, s_lease_confirm_blind, s_lease_write_failure,
         s_lease_from_params, s_lease_names, s_lease_waiters_and_faults]


@pytest.mark.parametrize("scenario", LEASE, ids=lambda f: f.__name__[2:])
def test_lease_as_the_jax_package(tmp_path, scenario):
    both(tmp_path, scenario)


def test_lease_scenarios_say_what_the_jax_tests_say(tmp_path):
    ns = PACKAGES["torch"]

    def run(scenario):
        root = tmp_path / scenario.__name__
        root.mkdir()
        return scenario(ns, root)

    held, holder, marker = run(s_lease_hold_release)
    assert held[:3] == (True, "r1", True) and (holder, marker) == (None, False)
    assert held[3] == {"a.png.lease": {"owner": "r1", "ttl_s": 5.0}}
    assert run(s_lease_second_fails) == (True, None, True)
    assert run(s_lease_expired_stolen) == (True, None, True, "r2")
    assert run(s_lease_stale_release) == (True, "r2")
    assert run(s_lease_race) == (True, True)
    assert run(s_lease_write_failure) == (True, [("fail", "lease")])
    assert run(s_lease_from_params) == ("replica-7", 12.0, 0.005, 33.0)
    assert run(s_lease_names) == ("abc.png.lease", b"artifact")
    assert run(s_lease_waiters_and_faults) == (
        1, 0, True, ["read", "write", "confirm"], (True, None), ["lease", "lease", "lease"])
