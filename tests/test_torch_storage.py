"""The PyTorch package's local output store held against the JAX
package's: over copies of one seeded tree (outputs of seeded sizes and
mtimes, stale and fresh temporaries), both ``prune`` passes give equal
summaries and leave the same survivors; ``public_url``, ``stat``,
``fetch``, ``list_names`` and ``has`` answer alike; transient errors
retry through each package's ``RetryPolicy``; hedged reads race one
backup read. The port's own temporary names (``.part-<pid>-<thread>``)
are reclaimed as the JAX ``.part`` ones are and never count as outputs."""

import os
import random
import shutil
import threading
import time

import pytest

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.storage import make_storage as jmake_storage
from flyimg_tpu.storage.local import LocalStorage as JLocalStorage
from flyimg_tpu.testing import faults as jfaults
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.storage import make_storage
from flyimg_tpu_torch.storage.local import LocalStorage
from flyimg_tpu_torch.testing import faults as tfaults

NOW = time.time()


def _seed_tree(root, seed, port_names=False):
    """Outputs with seeded sizes and ages and temporaries, some past a
    1-hour TTL, named as the JAX package names them (``.part``), or also
    as the port does; returns the temporaries with their ages."""
    rng = random.Random(seed)
    os.makedirs(root)
    for i in range(rng.randrange(5, 25)):
        name = "%032x.%s" % (rng.getrandbits(128), rng.choice(["png", "jpg", "webp"]))
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(bytes(rng.randrange(256) for _ in range(rng.randrange(10, 3000))))
        age = rng.randrange(0, 10_000)
        os.utime(os.path.join(root, name), (NOW - age, NOW - age))
    temps = []
    for i in range(rng.randrange(1, 6)):
        base = "%032x.png" % rng.getrandbits(128)
        port_name = f"{base}.part-{rng.randrange(1, 99999)}-{rng.getrandbits(40)}"
        name = port_name if port_names and rng.random() < 0.5 else base + ".part"
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(b"x" * rng.randrange(1, 500))
        age = rng.choice([10, 7200])
        os.utime(os.path.join(root, name), (NOW - age, NOW - age))
        temps.append((name, age))
    os.makedirs(os.path.join(root, "subdir"))
    return temps


def _pair(tmp_path, seed, port_names=False):
    src = str(tmp_path / "seed")
    temps = _seed_tree(src, seed, port_names)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    shutil.copytree(src, jroot)
    shutil.copytree(src, troot)
    for root in (jroot, troot):
        for name in os.listdir(src):
            st = os.stat(os.path.join(src, name))
            os.utime(os.path.join(root, name), (st.st_atime, st.st_mtime))
    return (JLocalStorage(JAppParameters({"upload_dir": jroot})),
            LocalStorage(AppParameters({"upload_dir": troot})), temps)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("budget", [0, 4000, 20_000, 10 ** 9])
@pytest.mark.parametrize("ttl", [0.0, 3600.0])
def test_prune_summaries_and_survivors_are_equal(tmp_path, seed, budget, ttl):
    jstore, tstore, temps = _pair(tmp_path, seed)
    assert tstore.prune(budget, ttl) == jstore.prune(budget, ttl)
    assert sorted(os.listdir(tstore.root)) == sorted(os.listdir(jstore.root))
    for name, age in temps:
        assert os.path.exists(os.path.join(tstore.root, name)) == \
            (ttl <= 0 or age < ttl), name


@pytest.mark.parametrize("seed", range(4))
def test_port_temporaries_are_reclaimed_like_jax_ones(tmp_path, seed):
    """A tree holding the port's temporary names prunes as the JAX store
    prunes the same tree with each renamed to ``.part`` (the JAX store
    never writes the port's names, so it would count them as outputs)."""
    _jstore, tstore, temps = _pair(tmp_path, seed, port_names=True)
    renamed = str(tmp_path / "renamed")
    shutil.copytree(tstore.root, renamed)
    for name, _age in temps:
        if not name.endswith(".part"):
            st = os.stat(os.path.join(renamed, name))
            new = os.path.join(renamed, name.split(".part-")[0] + ".part")
            os.rename(os.path.join(renamed, name), new)
            os.utime(new, (st.st_atime, st.st_mtime))
    jstore = JLocalStorage(JAppParameters({"upload_dir": renamed}))
    assert tstore.prune(4000, 3600.0) == jstore.prune(4000, 3600.0)
    for name, age in temps:
        assert os.path.exists(os.path.join(tstore.root, name)) == (age < 3600), name


def test_port_temporaries_never_count_as_outputs(tmp_path):
    store = LocalStorage(AppParameters({"upload_dir": str(tmp_path / "u")}))
    store.write("a.png", b"\x89PNG" + b"0" * 100)
    stale = os.path.join(store.root, f"b.png.part-{os.getpid()}-123")
    with open(stale, "wb") as fh:
        fh.write(b"y" * 10_000)
    os.utime(stale, (NOW - 7200, NOW - 7200))
    assert store.list_names("") == ["a.png"]
    summary = store.prune(200, 0.0)
    assert summary == {"kept": 1, "deleted": 0, "bytes": 104, "parts": 0}
    assert store.prune(200, 3600.0)["parts"] == 1
    assert not os.path.exists(stale)


@pytest.mark.parametrize("hostname_url", [None, "https://cdn.example.com/"])
@pytest.mark.parametrize("base", [None, "http://127.0.0.1:8080", "http://h/"])
def test_public_url_is_the_same(tmp_path, monkeypatch, hostname_url, base):
    if hostname_url is None:
        monkeypatch.delenv("HOSTNAME_URL", raising=False)
    else:
        monkeypatch.setenv("HOSTNAME_URL", hostname_url)
    jstore, tstore, _ = _pair(tmp_path, 1)
    name = "0123456789abcdef0123456789abcdef.png"
    assert tstore.public_url(name, base) == jstore.public_url(name, base)


def test_read_surface_answers_alike(tmp_path):
    jstore, tstore, _ = _pair(tmp_path, 2)
    names = sorted(n for n in os.listdir(jstore.root)
                   if os.path.isfile(os.path.join(jstore.root, n)))
    for prefix in ("", "0", "a", "f"):
        assert sorted(tstore.list_names(prefix)) == sorted(jstore.list_names(prefix))
    for name in names + ["absent.png"]:
        assert tstore.has(name) == jstore.has(name)
        jst, tst = jstore.stat(name), tstore.stat(name)
        assert (tst is None) == (jst is None)
        if jst is not None:
            assert tst.mtime == jst.mtime
            jf, tf = jstore.fetch(name), tstore.fetch(name)
            assert tf[0] == jf[0] == tstore.read(name)
            assert tf[1].mtime == jf[1].mtime
        else:
            assert tstore.fetch(name) is None and jstore.fetch(name) is None
    jstore.write("new.png", b"abc")
    tstore.write("new.png", b"abc")
    assert tstore.read("new.png") == jstore.read("new.png")
    tstore.delete("new.png")
    tstore.delete("new.png")
    assert not tstore.has("new.png")


def test_transient_errors_retry_through_the_policy(tmp_path):
    """The ``storage.read`` fault point raises EIO twice: both packages'
    stores retry and read the bytes, counting two retries."""
    outcomes = []
    for make, params, faults in (
        (jmake_storage, JAppParameters, jfaults),
        (make_storage, AppParameters, tfaults),
    ):
        store = make(params({"upload_dir": str(tmp_path / faults.__name__),
                             "retry_base_backoff_s": 0.0}))
        store.write("x.png", b"bytes")
        inj = faults.FaultInjector()
        inj.plan("storage.read", faults.fail_n_then_succeed(
            2, lambda: OSError(5, "EIO")))
        faults.install(inj)
        try:
            outcomes.append((store.read("x.png"), inj.fired.get("storage.read")))
        finally:
            faults.clear()
    assert outcomes[0] == outcomes[1] == (b"bytes", 3)


def test_hedged_read_fires_one_backup(tmp_path):
    """A primary read stalled past the hedge delay races one backup: the
    backup's bytes serve and ``flyimg_storage_hedges_total`` counts it."""
    from flyimg_tpu_torch.runtime.metrics import MetricsRegistry

    metrics = MetricsRegistry()
    store = make_storage(AppParameters({"upload_dir": str(tmp_path / "u"),
                                        "storage_hedge_delay_ms": 20.0}), metrics=metrics)
    store.write("x.png", b"bytes")
    release = threading.Event()
    inj = tfaults.FaultInjector()
    inj.plan("storage.read_delay",
             lambda name=None, attempt=0, **_: release.wait(5) if attempt == 0 else None)
    tfaults.install(inj)
    try:
        data, stat = store.fetch_hedged("x.png")
    finally:
        release.set()
        tfaults.clear()
    assert data == b"bytes" and stat.mtime is not None
    summary = metrics.summary()
    assert summary["flyimg_storage_hedges_total"] == 1
    assert summary['flyimg_storage_hedged_reads_total{winner="backup"}'] == 1


@pytest.mark.parametrize("extra", [{"storage_system": "s3"}, {"storage_system": "gcs"},
                                   {"l2_enable": True}])
def test_stores_not_ported_raise(tmp_path, monkeypatch, extra):
    """The S3, GCS and tiered stores, refused before they were ported, are
    built as the JAX package builds them (on stand-in clients): the same
    class, the same shared tier's class, and a write and a read through."""
    import torch_cloud_stand_ins as stand_in

    built = {}
    for name, (cls, make) in {"jax": (JAppParameters, jmake_storage),
                              "torch": (AppParameters, make_storage)}.items():
        stand_in.install_boto3(monkeypatch)
        stand_in.install_gcs(monkeypatch)
        conf = {**stand_in.S3_CONF, **stand_in.GCS_CONF,
                "upload_dir": str(tmp_path / name / "u"),
                "l2_upload_dir": str(tmp_path / name / "l2"), **extra}
        store = make(cls(conf))
        store.write("a.png", b"bytes")
        built[name] = (type(store).__name__, type(store.shared).__name__,
                       store.read("a.png"), store.fetch("a.png")[0])
    assert built["torch"] == built["jax"]
    assert built["torch"][2:] == (b"bytes", b"bytes")
