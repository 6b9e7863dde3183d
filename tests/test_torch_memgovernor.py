"""The PyTorch package's memory governor (flyimg_tpu_torch/runtime/memgovernor.py)
and its out-of-memory recovery in the batcher, against the JAX package's
(flyimg_tpu/runtime/memgovernor.py; tests/test_memgovernor.py is the JAX
side's own).

- ``MemoryGovernor`` (heuristic prediction, pre-split caps, AIMD ceilings
  under an injectable clock), ``HostByteAccountant`` and ``RssWatchdog``
  give the JAX objects' answers to the same scripts;
- an out-of-memory on the first launch of an 8-member batch recovers all 8
  (outputs equal a clean run's) with nothing quarantined and a ceiling of
  4; a single member that never fits fails with a 503 + Retry-After and is
  never quarantined; a group over the device budget is pre-split;
- the server: the host byte budget sheds a 503 + Retry-After and returns
  every charge; the governor off (the default) and on but unconstrained
  answer the same bytes.
The out-of-memory is a ``batcher.oom`` fault plan raising
``torch.OutOfMemoryError`` (chip_smoke.py's resilience phase makes a real
one on the card)."""

import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from flyimg_tpu.runtime import memgovernor as jmg
from flyimg_tpu.testing import faults as jfaults
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.exceptions import ServiceUnavailableException
from flyimg_tpu_torch.ops.compose import run_plan
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.runtime.memgovernor import (
    HostByteAccountant,
    MemoryGovernor,
    RssWatchdog,
)
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
from flyimg_tpu_torch.testing import faults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()
    jfaults.clear()


class FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _pair(**over):
    """The port's governor and the JAX package's, on one clock."""
    kw = dict(enabled=True, heuristic_bytes_per_pixel=1.0, ceiling_ttl_s=300.0,
              probe_successes=4, probe_step=1, clock=FakeClock())
    kw.update(over)
    return MemoryGovernor(**kw), jmg.MemoryGovernor(**kw), kw["clock"]


@pytest.mark.parametrize("budget", [0, 1, 99, 100, 350, 799, 10**12])
@pytest.mark.parametrize("pad", ["identity", "pow2", "x4"])
def test_member_cap_matches_jax(budget, pad):
    pad_fn = {"identity": lambda n: n, "pow2": lambda n: 1 << (n - 1).bit_length(),
              "x4": lambda n: -(-n // 4) * 4}[pad]
    ours, theirs, _ = _pair(device_budget_bytes=budget)
    for requested in (1, 2, 3, 5, 8, 64):
        for shape in ((10, 10), (32, 32), None):
            assert ours.member_cap("fam", shape, requested, pad_fn) == \
                theirs.member_cap("fam", shape, requested, pad_fn)
    assert ours.predict_bytes(8, (32, 32)) == theirs.predict_bytes("fam", 8, (32, 32))
    assert ours.predict_bytes(8, None) == theirs.predict_bytes("fam", 8, None) == 0.0


def test_ceilings_halve_probe_and_expire_as_jax():
    ours, theirs, clock = _pair(ceiling_ttl_s=60.0, probe_successes=3)
    script = [("oom", 8), ("succ", 4), ("succ", 4), ("succ", 4), ("oom", 5),
              ("succ", 1), ("advance", 30), ("succ", 2), ("oom", 64),
              ("advance", 61), ("oom", 1), ("oom", 1)]
    for op, arg in script:
        if op == "advance":
            clock.advance(arg)
        elif op == "oom":
            assert ours.record_oom("fam", arg) == theirs.record_oom("fam", arg)
        else:
            ours.record_success("fam", arg)
            theirs.record_success("fam", arg)
        assert ours.has_ceiling("fam") == theirs.has_ceiling("fam")
        assert ours.member_cap("fam", (10, 10), 64, lambda n: n) == \
            theirs.member_cap("fam", (10, 10), 64, lambda n: n)


def test_record_oom_caps_even_when_disabled():
    ours, theirs, _ = _pair(enabled=False)
    assert ours.record_oom("fam", 8) == theirs.record_oom("fam", 8) == 4
    assert ours.has_ceiling("fam") and theirs.has_ceiling("fam")
    assert ours.member_cap("fam", (10, 10), 8, lambda n: n) is None


@pytest.mark.parametrize("budget", [0, 100])
def test_accountant_matches_jax(budget):
    ours = HostByteAccountant(budget_bytes=budget, retry_after_s=2.0)
    theirs = jmg.HostByteAccountant(budget_bytes=budget, retry_after_s=2.0)
    charges = []
    for op, arg in [("admit", 60), ("admit", 60), ("admit", 10_000), ("release", 0),
                    ("admit", 30), ("release", 1), ("release", 5), ("admit", 999)]:
        if op == "release":
            if charges:
                c = charges.pop(arg % len(charges))
                ours.release(c[0])
                theirs.release(c[1])
            else:
                ours.release(50)
                theirs.release(50)
        else:
            got = want = None
            try:
                got = ours.admit(arg)
            except ServiceUnavailableException as exc:
                got = ("shed", exc.retry_after_s)
            try:
                want = theirs.admit(arg)
            except Exception as exc:
                want = ("shed", exc.retry_after_s)
            assert got == want
            if not isinstance(got, tuple):
                charges.append((got, want))
        assert (ours.inflight_bytes, ours.inflight_units) == \
            (theirs.inflight_bytes, theirs.inflight_units)
    assert ours.snapshot() == theirs.snapshot()


def test_rss_watchdog_pressure_and_fault_override():
    faults.install(faults.FaultInjector()).plan("mem.rss", lambda **_ctx: 75.0)
    jfaults.install(jfaults.FaultInjector()).plan("mem.rss", lambda **_ctx: 75.0)
    ours, theirs = RssWatchdog(limit_bytes=100), jmg.RssWatchdog(limit_bytes=100)
    assert ours.pressure() == theirs.pressure() == 0.75
    assert ours.snapshot() == theirs.snapshot()
    assert RssWatchdog(limit_bytes=0).pressure() == 0.0
    faults.clear()
    assert RssWatchdog(limit_bytes=1).rss_bytes() > 0.0   # a live process's RSS


# ---------------------------------------------------------------------------
# the batcher's out-of-memory recovery

SRC = (32, 32)


def _plan(opts="w_16"):
    return build_plan(OptionsBag(opts), *SRC)


def _img(seed):
    return np.random.default_rng(seed).integers(0, 200, (SRC[1], SRC[0], 3), dtype=np.uint8)


def _ctl(**over):
    kw = dict(device="cpu", max_batch=8, deadline_ms=10_000.0, lone_flush=False,
              quarantine_ttl_s=60.0)
    kw.update(over)
    ctl = BatchController(**kw)
    ctl._retry_policy.sleep = lambda _s: None
    return ctl


def _oom():
    return torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def test_over_budget_group_presplits_into_smaller_launches():
    gov, _, _ = _pair(device_budget_bytes=3000)     # 1024 B a member at 32x32
    ctl = _ctl(max_batch=4, deadline_ms=50.0, governor=gov)
    try:
        imgs = [_img(i) for i in range(4)]
        outs = [f.result(timeout=60) for f in [ctl.submit(im, _plan()) for im in imgs]]
        for img, out in zip(imgs, outs):
            np.testing.assert_array_equal(out, run_plan(img, _plan(), device="cpu"))
        assert gov.snapshot()["presplits_total"] >= 1
        assert max(n for _k, n, _b in ctl.launch_log) <= 2
    finally:
        ctl.close()


def test_oom_batch_of_8_recovers_everyone_no_quarantine():
    faults.install(faults.FaultInjector()).plan(
        "batcher.oom", faults.fail_n_then_succeed(1, _oom))
    gov, _, _ = _pair()
    ctl = _ctl(governor=gov)
    try:
        imgs = [_img(i) for i in range(8)]
        outs = [f.result(timeout=60) for f in [ctl.submit(im, _plan()) for im in imgs]]
        for img, out in zip(imgs, outs):
            np.testing.assert_array_equal(out, run_plan(img, _plan(), device="cpu"))
        assert len(ctl.quarantine) == 0 and ctl.stats["poison_isolated"] == 0
        snap = gov.snapshot()
        assert snap["oom_launches_total"] == 1
        (ceiling,) = snap["ceilings"].values()
        assert ceiling["cap_members"] == 4
        assert [n for _k, n, _b in ctl.launch_log] == [4, 4]
    finally:
        ctl.close()


def test_singleton_oom_fails_with_503_never_quarantines():
    faults.install(faults.FaultInjector()).plan(
        "batcher.oom", lambda **_ctx: (_ for _ in ()).throw(_oom()))
    gov, _, _ = _pair()
    ctl = _ctl(max_batch=1, governor=gov)
    try:
        with pytest.raises(ServiceUnavailableException, match="memory") as err:
            ctl.submit(_img(0), _plan()).result(timeout=60)
        assert err.value.retry_after_s == 1
        # the failed launch's traceback (its frames hold its device tensors)
        # is dropped before any launch again
        assert err.value.__cause__.__traceback__ is None
        assert len(ctl.quarantine) == 0
        (ceiling,) = gov.snapshot()["ceilings"].values()
        assert ceiling["cap_members"] == 1
    finally:
        ctl.close()


def test_oom_recovery_frees_the_failed_launch_s_tensors():
    """The frames of a failed launch hold its tensors (on a card, the device
    memory the re-launch needs) for as long as a traceback holds them, the
    tracebacks of chained errors included: recovery drops them first."""
    held, freed = [], []

    def plan(**_ctx):
        tensor = torch.empty(1 << 16)   # stands in for the launch's device tensors
        if not held:
            held.append(weakref.ref(tensor))
            try:
                raise ValueError("an error the out-of-memory chains")
            except ValueError:
                raise _oom() from None
        freed.append(held[0]() is None)
        return faults.PASS

    faults.install(faults.FaultInjector()).plan("batcher.oom", plan)
    ctl = _ctl(max_batch=2)
    try:
        futures = [ctl.submit(_img(i), _plan()) for i in range(2)]
        assert all(f.result(timeout=60).shape == (16, 16, 3) for f in futures)
        assert freed and all(freed)
    finally:
        ctl.close()


def test_oom_with_every_knob_off_fails_as_before():
    """No bisection, retries, quarantine or governor: the out-of-memory
    reaches every member as it is (the handler answers it 503)."""
    faults.install(faults.FaultInjector()).plan(
        "batcher.oom", faults.fail_n_then_succeed(1, _oom))
    ctl = _ctl(batch_retries=0, bisect_enable=False, quarantine_ttl_s=0.0)
    try:
        futures = [ctl.submit(_img(i), _plan()) for i in range(8)]
        for fut in futures:
            with pytest.raises(torch.OutOfMemoryError):
                fut.result(timeout=60)
        assert list(ctl.launch_log) == []
    finally:
        ctl.close()


# ---------------------------------------------------------------------------
# the server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


@pytest.fixture
def source(tmp_path):
    rng = np.random.default_rng(11)
    path = tmp_path / "src.png"
    path.write_bytes(png.encode(rng.integers(0, 230, (48, 64, 3), dtype=np.uint8)))
    return str(path)


def _serve(tmp_path, sub, **extra):
    conf = {"tmp_dir": str(tmp_path / sub / "t"), "upload_dir": str(tmp_path / sub / "u"),
            "batch_deadline_ms": 1.0}
    conf.update(extra)
    server = make_server(AppParameters(conf), device="cpu")
    thread = serve_in_thread(server)
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_default_off_is_byte_identical(tmp_path, source):
    off = _serve(tmp_path, "off")
    on = _serve(tmp_path, "on", mem_governor_enable=True, mem_device_budget_bytes=10**12,
                mem_host_budget_bytes=10**12)
    try:
        assert off[0].batcher.governor is None and off[0].handler.mem_accountant is None
        assert on[0].batcher.governor is not None and on[0].handler.mem_accountant is not None
        a = _get(f"{off[2]}/upload/w_24,o_png/{source}")
        b = _get(f"{on[2]}/upload/w_24,o_png/{source}")
        assert a[0] == b[0] == 200 and a[2] == b[2]
    finally:
        _stop(*off[:2])
        _stop(*on[:2])


def test_host_budget_sheds_503_with_retry_after(tmp_path, source):
    server, thread, base = _serve(tmp_path, "host", mem_host_budget_bytes=1000)
    acct = server.handler.mem_accountant
    try:
        charge = acct.admit(999)    # the 64x48 source predicts 9216 bytes
        try:
            status, headers, _body = _get(f"{base}/upload/w_24,o_png/{source}")
            assert status == 503 and headers.get("Retry-After") == "1"
        finally:
            acct.release(charge)
        assert _get(f"{base}/upload/w_24,o_png/{source}")[0] == 200
        assert acct.inflight_bytes == 0 and acct.inflight_units == 0
    finally:
        _stop(server, thread)


def test_singleton_oom_answers_503_and_returns_the_charge(tmp_path, source):
    injector = faults.FaultInjector()
    injector.plan("batcher.oom", lambda **_ctx: (_ for _ in ()).throw(_oom()))
    server, thread, base = _serve(tmp_path, "oom", mem_host_budget_bytes=10**9,
                                  mem_governor_enable=True, fault_injector=injector)
    try:
        status, headers, body = _get(f"{base}/upload/w_24,o_png/{source}")
        assert status == 503 and headers.get("Retry-After") == "1", body
        acct = server.handler.mem_accountant
        assert acct.inflight_bytes == 0 and acct.inflight_units == 0
        assert len(server.batcher.quarantine) == 0
    finally:
        _stop(server, thread)
