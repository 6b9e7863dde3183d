"""The PyTorch package's resilience (flyimg_tpu_torch/runtime/resilience.py,
the batcher's containment, the handler's deadlines and bounded device waits,
the server's admission gate, fetch retries and breakers) against the JAX
package's (flyimg_tpu/runtime/resilience.py; tests/test_resilience.py and
tests/test_batch_isolation.py are the JAX side's own).

- ``Deadline``, ``RetryPolicy``, ``CircuitBreaker``, ``BreakerRegistry``,
  ``host_of``, ``AdmissionGate`` and ``QuarantineTable`` give the JAX
  objects' answers to the same scripts (injected clocks and draws);
- ``classify_batch_error`` on torch's errors: out-of-memory is oversize,
  host IO transient, sticky CUDA errors fatal, the rest poison;
- the batcher: one poison member of 8 fails alone and the 7 others equal a
  clean run's outputs (and the JAX package's run_plan within 1 level),
  within 2·log2(8) + 1 launches; quarantine sends it alone after; retries
  of a transient failure; a sticky CUDA error fails the group at once;
  every knob off fails every member as before containment;
- the in-flight window: depth 2 and depth 1 give the same bits and
  launches (within 1 level of the JAX program); a readback failure is
  recovered on its drain thread; ``close`` drains in-flight readbacks and
  stamps a hung one, and a batch wedged mid-dispatch, with a TimeoutError;
- self-healing: a dead executor is replaced at the next submission (the
  replacement started outside the lock), a wedged one too, its queue
  re-homed and a fresh pipeline semaphore;
- the server: a device wait past ``device_result_timeout_s`` answers from
  the direct program (the batched answer's bytes, counted), 503 with
  ``wedged_executor_fallback`` off and 504 with the deadline spent, as the
  JAX app does; the smart-crop and face waits likewise; a full batch queue
  503 with Retry-After, a spent deadline 504 fast; fetches retry transient
  failures, never a 404, and an origin's breaker opens and sheds.
Faults come from the port's injector (flyimg_tpu_torch/testing/faults.py).
"""

import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from flyimg_tpu.ops.compose import run_plan as jrun_plan
from flyimg_tpu.runtime import resilience as jres
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.exceptions import (
    DeadlineExceededException,
    ExecFailedException,
    ServiceUnavailableException,
)
from flyimg_tpu_torch.ops.compose import run_plan
from flyimg_tpu_torch.runtime import resilience as res
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
from flyimg_tpu_torch.testing import faults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()


class Clock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


# ---------------------------------------------------------------------------
# primitives against the JAX package's


def test_deadline_matches_jax():
    for budget in (None, 0.0, -1.0, 0.5, 3.0):
        clock = Clock()
        ours, theirs = res.Deadline(budget, clock=clock), jres.Deadline(budget, clock=clock)
        for step in (0.0, 0.2, 0.4, 1.0, 5.0):
            clock.now += step
            assert ours.expired == theirs.expired
            assert ours.remaining() == theirs.remaining()
            for cap in (None, 0.1, 10.0):
                assert ours.timeout(cap) == theirs.timeout(cap)
            if ours.expired:
                with pytest.raises(DeadlineExceededException, match="at stage 'device'"):
                    ours.check("device")
            else:
                ours.check("device")


def _script(fails, exc):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise exc
        return "ok"
    return fn, calls


@pytest.mark.parametrize("fails,exc,attempts", [
    (0, OSError("x"), 3), (2, OSError("x"), 3), (3, OSError("x"), 3),
    (5, OSError("x"), 5), (1, ValueError("deterministic"), 3),
])
def test_retry_policy_matches_jax(fails, exc, attempts):
    outcomes = []
    for mod in (res, jres):
        sleeps = []
        policy = mod.RetryPolicy(max_attempts=attempts, base_backoff_s=0.05,
                                 max_backoff_s=0.15, sleep=sleeps.append,
                                 rng=lambda: 0.75)
        fn, calls = _script(fails, exc)
        try:
            out = policy.run(fn, retryable=lambda e: isinstance(e, OSError))
        except Exception as err:
            out = type(err).__name__
        outcomes.append((out, calls[0], sleeps,
                         [policy.backoff(a) for a in range(1, 6)]))
    assert outcomes[0] == outcomes[1]


def test_retry_never_sleeps_past_deadline():
    clock = Clock()
    sleeps = []
    policy = res.RetryPolicy(max_attempts=5, base_backoff_s=1.0, sleep=sleeps.append,
                             rng=lambda: 1.0)
    fn, calls = _script(10, OSError("down"))
    with pytest.raises(OSError):
        policy.run(fn, retryable=lambda e: True, deadline=res.Deadline(1.5, clock=clock))
    assert calls[0] == 1 and sleeps == []


def _drive_breaker(mod, clock):
    brk = mod.CircuitBreaker(failure_threshold=3, recovery_s=5.0, clock=clock, name="h")
    trace = []
    for op, arg in [("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0), ("fail", 0),
                    ("allow", 0), ("tick", 4.9), ("allow", 0), ("tick", 0.2),
                    ("allow", 0), ("allow", 0), ("fail", 0), ("allow", 0),
                    ("tick", 5.0), ("allow", 0), ("ok", 0), ("allow", 0)]:
        if op == "tick":
            clock.now += arg
        elif op == "fail":
            brk.record_failure()
        elif op == "ok":
            brk.record_success()
        else:
            try:
                brk.allow()
                trace.append("admitted")
            except mod.CircuitOpenException as exc:
                trace.append(("shed", exc.retry_after_s))
        trace.append(brk.state)
    return trace


def test_breaker_transitions_match_jax():
    assert _drive_breaker(res, Clock()) == _drive_breaker(jres, Clock())


@pytest.mark.parametrize("url", [
    "http://Example.COM/a.png", "https://user:pw@cdn.example.com:8443/x?y=1",
    "/local/path.png", "file:///tmp/a.png", "http://[::1]:80/a", "http://exa mple/",
])
def test_host_of_matches_jax(url):
    assert res.host_of(url) == jres.host_of(url)


def test_breaker_registry_bounds_hosts_as_jax():
    ours = res.BreakerRegistry(failure_threshold=1, max_hosts=3)
    theirs = jres.BreakerRegistry(failure_threshold=1, max_hosts=3)
    for reg in (ours, theirs):
        for i in range(5):
            brk = reg.for_host(f"h{i}")
            if i % 2:
                brk.record_failure()
    assert sorted(ours._breakers) == sorted(theirs._breakers)
    assert [b.state for b in ours._breakers.values()] == \
        [theirs._breakers[h].state for h in ours._breakers]


def test_admission_gate_matches_jax():
    ours = res.AdmissionGate(max_pending=2, retry_after_s=7.0)
    theirs = jres.AdmissionGate(max_pending=2, retry_after_s=7.0)
    for op in ["a", "a", "a", "r", "a", "r", "r", "r", "a"]:
        got = want = None
        if op == "r":
            ours.release()
            theirs.release()
        else:
            for gate, slot in ((ours, 0), (theirs, 1)):
                try:
                    gate.acquire()
                    val = "admitted"
                except Exception as exc:
                    val = ("shed", exc.retry_after_s)
                if slot == 0:
                    got = val
                else:
                    want = val
            assert got == want
        assert ours.pending == theirs.pending


def test_quarantine_table_matches_jax():
    clock = Clock(0.0)
    ours = res.QuarantineTable(10.0, max_entries=4, clock=clock)
    theirs = jres.QuarantineTable(10.0, max_entries=4, clock=clock)
    for i in range(12):
        clock.now = float(i)
        fp = ("key" if i % 3 else "other", i % 5)
        ours.add(fp)
        theirs.add(fp)
        for probe in (("key", 1), ("key", 2), ("other", 0), ("none", 0)):
            assert ours.hit(probe) == theirs.hit(probe)
        assert ours.has_prefix("key") == theirs.has_prefix("key")
        assert len(ours) == len(theirs)
    clock.now = 100.0
    assert len(ours) == len(theirs) == 0


@pytest.mark.parametrize("exc,kind", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 GiB"), res.OVERSIZE),
    (OSError("io hiccup"), res.TRANSIENT),
    (TimeoutError("slow"), res.TRANSIENT),
    (ConnectionResetError("reset"), res.TRANSIENT),
    (ValueError("bad member"), res.POISON),
    (RuntimeError("weird"), res.POISON),
    (RuntimeError("K1 wrapper: a CUDA tensor needs the built kernel"), res.POISON),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), res.FATAL),
    (RuntimeError("CUDA error: device-side assert triggered\nCUDA kernel errors "
                  "might be asynchronously reported"), res.FATAL),
    (RuntimeError("CUDA error: unspecified launch failure"), res.FATAL),
    (RuntimeError("CUDA error: misaligned address"), res.FATAL),
])
def test_classify_batch_error_torch_cases(exc, kind):
    assert res.classify_batch_error(exc) == kind
    if kind in (res.TRANSIENT,) or isinstance(exc, ValueError):
        assert jres.classify_batch_error(exc) == kind   # where the JAX one agrees


# ---------------------------------------------------------------------------
# the batcher's containment

SRC = (32, 32)
MARKER = (255, 0, 255)


def _plan():
    return build_plan(OptionsBag("w_16"), *SRC)


def _img(seed, poison=False):
    img = np.random.default_rng(seed).integers(0, 200, (SRC[1], SRC[0], 3), dtype=np.uint8)
    if poison:
        img[0, 0] = MARKER
    return img


def _is_poison(image=None, **_ctx):
    return getattr(image, "ndim", 0) == 3 and bool(np.all(image[0, 0] == MARKER))


def _poison(exc_factory=lambda: ValueError("poison pixel")):
    return faults.poison_member(_is_poison, exc_factory)


def _ctl(**over):
    kw = dict(device="cpu", max_batch=8, deadline_ms=10_000.0, lone_flush=False,
              quarantine_ttl_s=60.0)
    kw.update(over)
    ctl = BatchController(**kw)
    ctl._retry_policy.sleep = lambda _s: None
    return ctl


@pytest.mark.parametrize("bad", [0, 3, 7])
def test_poison_member_isolated_in_batch_of_8(bad):
    injector = faults.install(faults.FaultInjector())
    injector.plan("batcher.member", _poison())
    ctl = _ctl()
    try:
        images = [_img(i, poison=(i == bad)) for i in range(8)]
        futures = [ctl.submit(img, _plan()) for img in images]
        for i, (img, fut) in enumerate(zip(images, futures)):
            if i == bad:
                with pytest.raises(ValueError, match="poison pixel"):
                    fut.result(timeout=120)
                continue
            out = fut.result(timeout=120)
            np.testing.assert_array_equal(out, run_plan(img, _plan(), device="cpu"))
            ref = jrun_plan(img, jbuild_plan(JOptionsBag("w_16"), *SRC))
            assert np.abs(out.astype(int) - np.asarray(ref).astype(int)).max() <= 1
        assert ctl.stats["poison_isolated"] == 1 and ctl.stats["retries"] == 0
        assert len(ctl.quarantine) == 1
        # every launch tried, the failing ones included (each assembles its
        # members): the first and at most 2·log2(8) recovery launches
        tried = injector.fired["batcher.member"]
        assert tried <= 8 * (int(math.log2(8)) + 1)
        assert 1 < len(ctl.launch_log) <= 2 * 3 + 1
    finally:
        ctl.close()


def test_two_poison_members_both_isolated():
    faults.install(faults.FaultInjector()).plan("batcher.member", _poison())
    ctl = _ctl()
    try:
        futures = [ctl.submit(_img(i, poison=i in (1, 6)), _plan()) for i in range(8)]
        for i, fut in enumerate(futures):
            if i in (1, 6):
                with pytest.raises(ValueError):
                    fut.result(timeout=120)
            else:
                assert fut.result(timeout=120).shape == (16, 16, 3)
        assert ctl.stats["poison_isolated"] == 2 and len(ctl.quarantine) == 2
    finally:
        ctl.close()


def test_quarantined_member_runs_alone():
    faults.install(faults.FaultInjector()).plan("batcher.member", _poison())
    ctl = _ctl(max_batch=4)
    try:
        poison = _img(0, poison=True)
        futures = [ctl.submit(_img(i + 1), _plan()) for i in range(3)]
        futures.append(ctl.submit(poison, _plan()))
        with pytest.raises(ValueError):
            futures[-1].result(timeout=120)
        for fut in futures[:-1]:
            fut.result(timeout=120)
        before = len(ctl.launch_log)
        # resubmitted beside three innocents: it cannot share their launch
        again = [ctl.submit(_img(i + 10), _plan()) for i in range(3)]
        again.append(ctl.submit(poison, _plan()))
        for fut in again[:-1]:
            fut.result(timeout=120)
        with pytest.raises(ValueError):
            again[-1].result(timeout=120)
        assert ctl.stats["quarantine_hits"] == 1
        assert list(ctl.launch_log)[before:] == [("transform", 3, 4)]
        faults.clear()
        assert ctl.submit(poison, _plan()).result(timeout=120).shape == (16, 16, 3)
        assert ctl.stats["quarantine_hits"] == 2
    finally:
        ctl.close()


def test_aux_group_poison_bisected():
    def runner(payloads):
        if any(p == "poison" for p in payloads):
            raise ValueError("aux poison")
        return [p.upper() for p in payloads]

    ctl = _ctl(max_batch=4)
    try:
        futures = [ctl.submit_aux(("t",), p, runner) for p in ("a", "poison", "c", "d")]
        assert [futures[i].result(timeout=60) for i in (0, 2, 3)] == ["A", "C", "D"]
        with pytest.raises(ValueError, match="aux poison"):
            futures[1].result(timeout=60)
        assert len(ctl.quarantine) == 0
    finally:
        ctl.close()


def test_transient_drain_failure_retries_then_succeeds():
    faults.install(faults.FaultInjector()).plan(
        "batcher.drain", faults.fail_n_then_succeed(2, lambda: OSError("flaky readback")))
    ctl = _ctl(max_batch=4, batch_retries=2)
    try:
        imgs = [_img(i) for i in range(4)]
        futures = [ctl.submit(img, _plan()) for img in imgs]
        for img, fut in zip(imgs, futures):
            np.testing.assert_array_equal(fut.result(timeout=120),
                                          run_plan(img, _plan(), device="cpu"))
        assert ctl.stats["retries"] == 2 and ctl.stats["poison_isolated"] == 0
    finally:
        ctl.close()


def test_transient_retries_exhausted_fail_whole_batch():
    faults.install(faults.FaultInjector()).plan(
        "batcher.drain", faults.fail_n_then_succeed(100, lambda: OSError("dead readback")))
    ctl = _ctl(max_batch=4, batch_retries=2)
    try:
        futures = [ctl.submit(_img(i), _plan()) for i in range(4)]
        for fut in futures:
            with pytest.raises(OSError, match="dead readback"):
                fut.result(timeout=120)
        assert ctl.stats["retries"] == 2 and len(ctl.launch_log) == 3
    finally:
        ctl.close()


def test_transient_hiccup_during_bisection_retries_innocent():
    injector = faults.install(faults.FaultInjector())
    injector.plan("batcher.member", _poison())
    injector.plan("batcher.drain",
                  faults.fail_n_then_succeed(1, lambda: OSError("recovery hiccup")))
    ctl = _ctl(max_batch=2, batch_retries=2)
    try:
        innocent, poison = _img(0), _img(1, poison=True)
        f_innocent, f_poison = ctl.submit(innocent, _plan()), ctl.submit(poison, _plan())
        np.testing.assert_array_equal(f_innocent.result(timeout=120),
                                      run_plan(innocent, _plan(), device="cpu"))
        with pytest.raises(ValueError, match="poison pixel"):
            f_poison.result(timeout=120)
        assert ctl.stats["poison_isolated"] == 1 and ctl.stats["retries"] >= 1
    finally:
        ctl.close()


def test_sticky_cuda_error_fails_the_group_at_once():
    """A sticky CUDA error poisons the context: no retry, no bisection, one
    launch, and every member learns why. (Made here as the RuntimeError
    PyTorch raises; never injected on a card.)"""
    sticky = "CUDA error: an illegal memory access was encountered"
    injector = faults.install(faults.FaultInjector())
    injector.plan("batcher.drain", lambda **_ctx: (_ for _ in ()).throw(RuntimeError(sticky)))
    ctl = _ctl(batch_retries=2)
    try:
        futures = [ctl.submit(_img(i), _plan()) for i in range(8)]
        for fut in futures:
            with pytest.raises(ExecFailedException, match="sticky CUDA error.*illegal memory"):
                fut.result(timeout=120)
        assert len(ctl.launch_log) == 1 and injector.fired["batcher.drain"] == 1
        assert ctl.stats == {"retries": 0, "poison_isolated": 0, "quarantine_hits": 0}
        assert len(ctl.quarantine) == 0
    finally:
        ctl.close()


def test_sticky_cuda_error_during_bisection_stops_it():
    injector = faults.install(faults.FaultInjector())
    injector.plan("batcher.member", _poison())
    injector.plan("batcher.drain", lambda **_ctx: (_ for _ in ()).throw(
        RuntimeError("CUDA error: unspecified launch failure")))
    ctl = _ctl()
    try:
        futures = [ctl.submit(_img(i, poison=i == 5), _plan()) for i in range(8)]
        for fut in futures:
            with pytest.raises(ExecFailedException, match="sticky CUDA error"):
                fut.result(timeout=120)
        assert injector.fired["batcher.drain"] == 1    # the first half's launch only
    finally:
        ctl.close()


def test_every_knob_off_fails_every_member():
    faults.install(faults.FaultInjector()).plan("batcher.member", _poison())
    ctl = _ctl(batch_retries=0, bisect_enable=False, quarantine_ttl_s=0.0)
    try:
        futures = [ctl.submit(_img(i, poison=i == 3), _plan()) for i in range(8)]
        for fut in futures:
            with pytest.raises(ValueError, match="poison pixel"):
                fut.result(timeout=120)
        assert ctl.quarantine is None and list(ctl.launch_log) == []
    finally:
        ctl.close()


def test_batcher_sheds_when_queue_full():
    wedge = threading.Event()
    faults.install(faults.FaultInjector()).plan("batcher.execute", faults.wedge_until(wedge))
    ctl = BatchController(device="cpu", max_batch=4, deadline_ms=10_000.0, lone_flush=True,
                          max_queue_depth=2, shed_retry_after_s=7.0)
    try:
        img = _img(0)
        f1 = ctl.submit(img, _plan())
        f2 = ctl.submit(img, _plan())
        with pytest.raises(ServiceUnavailableException) as exc_info:
            ctl.submit(img, _plan())
        assert exc_info.value.retry_after_s == 7
        wedge.set()
        assert f1.result(timeout=120).shape == f2.result(timeout=120).shape == (16, 16, 3)
        ctl.submit(img, _plan()).result(timeout=120)    # the slots came back
        assert ctl.admission.pending == 0
    finally:
        wedge.set()
        ctl.close()


# ---------------------------------------------------------------------------
# the in-flight window (pipelined readback) and executor self-healing


def _flagship_plan(shape=(48, 64)):
    return build_plan(OptionsBag("w_30,h_25,c_1"), shape[1], shape[0])


def _flagship_img(seed, shape=(48, 64)):
    return np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8)


@pytest.mark.parametrize("max_batch", [1, 2, 4])
def test_pipeline_depth_2_equals_depth_1(max_batch):
    """The same flagship members through depth 1 (launch, read, launch)
    and depth 2 (the next launch dispatched while the last reads back):
    the same bits, the same launches, at most ``depth`` launches in flight,
    and within 1 level of the JAX package's program."""
    images = [_flagship_img(40 + i) for i in range(8)]
    outs, logs = {}, {}
    for depth in (1, 2):
        ctl = _ctl(max_batch=max_batch, pipeline_depth=depth, lone_flush=True)
        try:
            futures = [ctl.submit(img, _flagship_plan()) for img in images]
            outs[depth] = [f.result(timeout=120) for f in futures]
            logs[depth] = sorted(ctl.launch_log)
            assert 1 <= ctl.inflight_peak <= depth
        finally:
            ctl.close()
    assert logs[1] == logs[2]
    jplan = jbuild_plan(JOptionsBag("w_30,h_25,c_1"), 64, 48)
    for img, a, b in zip(images, outs[1], outs[2]):
        np.testing.assert_array_equal(a, b)
        ref = np.asarray(jrun_plan(img, jplan))
        assert a.shape == ref.shape == (25, 30, 3)
        assert np.abs(a.astype(int) - ref.astype(int)).max() <= 1


def test_drain_failure_is_recovered_on_the_drain_thread():
    """A readback that raises (a poison-class error at ``batcher.drain``,
    once) is contained on the launch's drain thread: the bisection's
    launches run there and every member answers the clean bits."""
    threads = []

    def once(**_ctx):
        threads.append(threading.current_thread().name)
        if len(threads) == 1:
            raise ValueError("readback poison")
        return faults.PASS

    faults.install(faults.FaultInjector()).plan("batcher.drain", once)
    ctl = _ctl(max_batch=4)
    try:
        imgs = [_img(i) for i in range(4)]
        futures = [ctl.submit(img, _plan()) for img in imgs]
        for img, fut in zip(imgs, futures):
            np.testing.assert_array_equal(fut.result(timeout=120),
                                          run_plan(img, _plan(), device="cpu"))
        assert set(threads) == {"flyimg-torch-batcher-drain"} and len(threads) == 3
        assert [n for _k, n, _b in ctl.launch_log] == [4, 2, 2]
        assert ctl.stats["poison_isolated"] == 0
    finally:
        ctl.close()


def test_close_drains_inflight_readbacks():
    """``close`` resolves the readbacks in flight within its budget; a
    readback that hangs past it answers a TimeoutError."""
    faults.install(faults.FaultInjector()).plan("batcher.drain", faults.latency_spike(0.3))
    ctl = _ctl(max_batch=2)
    imgs = [_img(i) for i in range(4)]
    futures = [ctl.submit(img, _plan()) for img in imgs]
    ctl.close(drain_timeout_s=1.0)
    for img, fut in zip(imgs, futures):
        np.testing.assert_array_equal(fut.result(timeout=0),
                                      run_plan(img, _plan(), device="cpu"))
    hang = threading.Event()
    faults.install(faults.FaultInjector()).plan("batcher.drain", faults.wedge_until(hang))
    ctl = _ctl(max_batch=2)
    try:
        futures = [ctl.submit(_img(i), _plan()) for i in range(2)]
        t0 = time.monotonic()
        ctl.close(drain_timeout_s=0.3)
        assert time.monotonic() - t0 < 5.0
        for fut in futures:
            with pytest.raises(TimeoutError, match="readback hung"):
                fut.result(timeout=1)
    finally:
        hang.set()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_executor_restart_after_thread_death():
    """A BaseException out of a batch kills the executor; the next
    submission finds it dead, replaces it and is served."""
    faults.install(faults.FaultInjector()).plan(
        "batcher.execute", lambda **_: (_ for _ in ()).throw(SystemExit("chaos")))
    ctl = _ctl(max_batch=2, lone_flush=True)
    try:
        with pytest.raises(RuntimeError, match="executor died"):
            ctl.submit(_img(0), _plan()).result(timeout=60)
        for _ in range(500):
            if not ctl._thread.is_alive():
                break
            time.sleep(0.01)
        assert not ctl._thread.is_alive()
        faults.clear()
        assert ctl.submit(_img(1), _plan()).result(timeout=120).shape == (16, 16, 3)
        assert ctl.restarts == {"dead": 1, "wedged": 0}
    finally:
        ctl.close()


def test_executor_restart_when_wedged_rehomes_queue():
    """An executor wedged in one batch past ``executor_wedge_timeout_s`` is
    replaced at the next submission, with a fresh pipeline semaphore; the
    queued group runs on the replacement, the wedged batch still resolves
    when released, and the old thread then exits."""
    wedge = threading.Event()
    faults.install(faults.FaultInjector()).plan("batcher.execute", faults.wedge_until(wedge))
    ctl = _ctl(max_batch=2, lone_flush=True, executor_wedge_timeout_s=0.2)
    try:
        first = ctl.submit(_img(0), _plan())
        old, old_slots = ctl._thread, ctl._inflight
        time.sleep(0.4)
        faults.clear()
        second = ctl.submit(_img(1), _plan())
        assert second.result(timeout=120).shape == (16, 16, 3)
        assert ctl._thread is not old and ctl._inflight is not old_slots
        assert ctl.restarts == {"dead": 0, "wedged": 1}
        wedge.set()
        assert first.result(timeout=120).shape == (16, 16, 3)
        old.join(timeout=10)
        assert not old.is_alive()
    finally:
        wedge.set()
        ctl.close()


def test_close_stamps_batch_wedged_mid_dispatch():
    """A batch whose executor wedged before any drain thread exists is in
    flight from its pop: ``close`` stamps it with a TimeoutError within the
    drain budget instead of leaving its callers waiting."""
    wedge = threading.Event()
    injector = faults.install(faults.FaultInjector())
    injector.plan("batcher.execute", faults.wedge_until(wedge))
    ctl = _ctl(lone_flush=True)
    try:
        fut = ctl.submit(_img(0), _plan())
        for _ in range(200):
            if injector.fired.get("batcher.execute"):
                break
            time.sleep(0.02)
        assert injector.fired.get("batcher.execute", 0) >= 1
        t0 = time.monotonic()
        ctl.close(drain_timeout_s=0.5)
        assert time.monotonic() - t0 < 7.0
        with pytest.raises(TimeoutError, match="readback hung"):
            fut.result(timeout=1)
    finally:
        wedge.set()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_heal_starts_executor_outside_lock(monkeypatch):
    """The healed executor starts after the submission lock is released
    (a thread start blocks; under the lock it would hold every
    submitter)."""
    ctl = BatchController(device="cpu", max_batch=2, deadline_ms=1.0, lone_flush=True)
    seen = {}
    orig_start = threading.Thread.start

    def checking_start(thread):
        if thread.name == "flyimg-torch-batcher":
            seen["lock_owned_at_start"] = ctl._lock._is_owned()
        return orig_start(thread)

    def runner(payloads):
        return [p * 2 for p in payloads]

    try:
        faults.install(faults.FaultInjector()).plan(
            "batcher.execute", lambda **_: (_ for _ in ()).throw(SystemExit("chaos")))
        with pytest.raises(RuntimeError, match="executor died"):
            ctl.submit_aux(("k",), 21, runner).result(timeout=60)
        for _ in range(500):
            if not ctl._thread.is_alive():
                break
            time.sleep(0.01)
        assert not ctl._thread.is_alive()
        faults.clear()
        monkeypatch.setattr(threading.Thread, "start", checking_start)
        assert ctl.submit_aux(("k",), 21, runner).result(timeout=60) == 42
        assert seen == {"lock_owned_at_start": False}
        assert ctl.restarts["dead"] == 1
    finally:
        monkeypatch.undo()
        faults.clear()
        ctl.close(drain_timeout_s=5.0)


# ---------------------------------------------------------------------------
# the server


def _get(url, timeout=120):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


@pytest.fixture
def source(tmp_path):
    path = tmp_path / "source.png"
    path.write_bytes(png.encode(_img(11)))
    return str(path)


@pytest.fixture
def serve(tmp_path):
    started = []

    def start(**extra):
        conf = {"tmp_dir": str(tmp_path / "tmp"), "upload_dir": str(tmp_path / "up"),
                "batch_deadline_ms": 1.0}
        conf.update(extra)
        server = make_server(AppParameters(conf), device="cpu")
        thread = serve_in_thread(server)
        started.append((server, thread))
        return server, f"http://127.0.0.1:{server.server_address[1]}"

    yield start
    for server, thread in started:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("case", ["fallback", "fallback_off", "deadline_spent"])
def test_device_wait_past_its_timeout_answers_504(serve, source, case, tmp_path):
    """A device wait past ``device_result_timeout_s`` (a wedged executor):
    with ``wedged_executor_fallback`` on (the default) the request answers
    the batched answer's bytes from the direct program, counted once; with
    it off, 503; with the request's deadline spent first, 504 (the JAX
    handler's three answers). The stage pools are off here, so that only
    the executor's wedge counts."""
    _clean, clean_base = serve(upload_dir=str(tmp_path / "clean"),
                               host_pipeline_enable=False)
    status, _h, batched = _get(f"{clean_base}/upload/w_20,o_png/{source}")
    assert status == 200
    wedge = threading.Event()
    injector = faults.FaultInjector()
    injector.plan("batcher.execute", faults.wedge_until(wedge))
    extra = {"fallback": {},
             "fallback_off": {"wedged_executor_fallback": False},
             "deadline_spent": {"request_deadline_s": 0.3,
                                "device_result_timeout_s": 5.0}}[case]
    conf = dict(fault_injector=injector, device_result_timeout_s=0.3,
                host_pipeline_enable=False, upload_dir=str(tmp_path / case))
    conf.update(extra)
    server, base = serve(**conf)
    try:
        t0 = time.perf_counter()
        status, _h, body = _get(f"{base}/upload/w_20,o_png/{source}")
        assert time.perf_counter() - t0 < 30
        if case == "fallback":
            assert status == 200 and body == batched
            assert server.handler.wedged_fallbacks == 1
        elif case == "fallback_off":
            assert status == 503 and b"ServiceUnavailableException" in body
            assert b"device_result_timeout_s" in body
            assert server.handler.wedged_fallbacks == 0
        else:
            assert status == 504 and b"DeadlineExceededException" in body
            assert server.handler.wedged_fallbacks == 0
    finally:
        wedge.set()
    # the launch ran on; the next request renders
    assert _get(f"{base}/upload/w_20,o_png,rf_1/{source}")[0] == 200


@pytest.mark.parametrize("stage", ["smartcrop", "faces"])
@pytest.mark.parametrize("fallback", [True, False])
def test_wedged_aux_wait_falls_back_to_the_direct_program(tmp_path, stage, fallback):
    """Smart-crop scoring and face detection wait on aux groups: past
    ``device_result_timeout_s`` each answers from the single-image program
    in the request's thread, on the handler's device, the bytes of the
    batched answer, counted once; with the fallback off, 503."""
    from flyimg_tpu_torch.entry import skin_ellipse_image
    from flyimg_tpu_torch.service.handler import ImageHandler

    img = skin_ellipse_image(np.random.default_rng(5), 120, 160, 2)
    path = tmp_path / "src.png"
    path.write_bytes(png.encode(img))
    opts = {"smartcrop": "w_60,h_40,c_1,smc_1,o_png", "faces": "w_160,fb_1,o_png"}[stage]

    def handler(name, ctl, **extra):
        # 1 s: the transform's own wait must not run out under a loaded host
        conf = {"upload_dir": str(tmp_path / name / "u"), "tmp_dir": str(tmp_path / name / "t"),
                "face_backend": "facefind", "device_result_timeout_s": 1.0}
        conf.update(extra)
        return ImageHandler(AppParameters(conf), device="cpu", batcher=ctl)

    clean_ctl = _ctl(lone_flush=True)
    try:
        batched = handler("clean", clean_ctl).process_image(opts, str(path)).content
        assert ("aux", 1, 1) in clean_ctl.launch_log
    finally:
        clean_ctl.close()
    wedge = threading.Event()

    def aux_wedge(key=None, **_ctx):
        if key and key[0] == "aux":
            wedge.wait(timeout=30)
        return faults.PASS

    faults.install(faults.FaultInjector()).plan("batcher.execute", aux_wedge)
    ctl = _ctl(lone_flush=True)
    try:
        h = handler("wedged", ctl, wedged_executor_fallback=fallback)
        if fallback:
            assert h.process_image(opts, str(path)).content == batched
            assert h.wedged_fallbacks == 1
        else:
            with pytest.raises(ServiceUnavailableException, match=stage):
                h.process_image(opts, str(path))
            assert h.wedged_fallbacks == 0
    finally:
        wedge.set()
        ctl.close()


@pytest.mark.parametrize("fallback", [True, False])
def test_wedged_fallback_answers_as_the_jax_app(serve, source, tmp_path, fallback):
    """A wedged executor through the JAX package's aiohttp app and through
    the port's server, the fallback on and off: the same status (200 and
    503)."""
    import asyncio

    from tests.test_resilience import _serve as jserve

    statuses = []
    for port in (True, False):
        wedge = threading.Event()
        if port:
            injector = faults.FaultInjector()
            injector.plan("batcher.execute", faults.wedge_until(wedge))
            try:
                _server, base = serve(fault_injector=injector, device_result_timeout_s=0.3,
                                      wedged_executor_fallback=fallback,
                                      upload_dir=str(tmp_path / "port"))
                statuses.append(_get(f"{base}/upload/w_24,o_png/{source}")[0])
            finally:
                wedge.set()
                faults.clear()
            continue
        from flyimg_tpu.testing import faults as jfaults

        jinjector = jfaults.FaultInjector()
        jinjector.plan("batcher.execute", jfaults.wedge_until(wedge))

        async def scenario(client):
            resp = await client.get(f"/upload/w_24,o_png/{source}")
            await resp.read()
            wedge.set()
            await asyncio.sleep(0)
            return resp.status

        try:
            statuses.append(jserve(tmp_path / "jax", scenario, fault_injector=jinjector,
                                   device_result_timeout_s=0.3,
                                   wedged_executor_fallback=fallback))
        finally:
            wedge.set()
            jfaults.clear()
    assert statuses == ([200, 200] if fallback else [503, 503])


def test_http_full_queue_returns_503_with_retry_after(serve, source):
    wedge = threading.Event()
    injector = faults.FaultInjector()
    injector.plan("batcher.execute", faults.wedge_until(wedge))
    _server, base = serve(fault_injector=injector, batch_max_queue_depth=1,
                          shed_retry_after_s=3.0)
    first = {}
    thread = threading.Thread(target=lambda: first.update(
        r=_get(f"{base}/upload/w_20,o_png,rf_1/{source}")))
    thread.start()
    try:
        for _ in range(200):
            if injector.fired.get("batcher.execute"):
                break
            time.sleep(0.02)
        status, headers, body = _get(f"{base}/upload/w_21,o_png,rf_1/{source}")
    finally:
        wedge.set()
        thread.join(timeout=120)
    assert status == 503 and headers["Retry-After"] == "3"
    assert b"ServiceUnavailableException" in body
    assert first["r"][0] == 200     # the admitted request still completed


def test_http_exhausted_deadline_returns_504_fast(serve):
    injector = faults.FaultInjector()
    injector.plan("fetch.http", faults.latency_spike(0.3, TimeoutError("slow")))
    _server, base = serve(fault_injector=injector, request_deadline_s=0.15,
                          retry_max_attempts=1, device_result_timeout_s=30.0)
    t0 = time.perf_counter()
    status, _h, body = _get(f"{base}/upload/w_20,o_png,rf_1/http://slow.example.com/img.png")
    assert status == 504 and b"DeadlineExceededException" in body
    assert time.perf_counter() - t0 < 5.0


def test_fetch_fails_twice_then_succeeds(serve):
    body = png.encode(_img(3))
    injector = faults.FaultInjector()
    injector.plan("fetch.http", faults.fail_n_then_succeed(
        2, lambda: urllib.error.URLError(ConnectionRefusedError("refused")), result=body))
    _server, base = serve(fault_injector=injector, retry_base_backoff_s=0.001)
    status, _h, _b = _get(f"{base}/upload/w_20,o_png/http://flaky.example.com/a.png")
    assert status == 200 and injector.fired["fetch.http"] == 3


def test_fetch_deterministic_http_error_no_retry(serve):
    injector = faults.FaultInjector()
    injector.plan("fetch.http", faults.fail_n_then_succeed(
        10, lambda: urllib.error.HTTPError("http://gone.example.com/a.png", 404,
                                           "Not Found", {}, None)))
    _server, base = serve(fault_injector=injector)
    status, _h, _b = _get(f"{base}/upload/w_20,o_png/http://gone.example.com/a.png")
    assert status == 404 and injector.fired["fetch.http"] == 1


def test_fetch_breaker_opens_origin_and_sheds(serve):
    injector = faults.FaultInjector()
    injector.plan("fetch.http", faults.fail_n_then_succeed(
        100, lambda: urllib.error.HTTPError("http://down.example.com/", 503,
                                            "Unavailable", {}, None)))
    _server, base = serve(fault_injector=injector, retry_max_attempts=1,
                          breaker_failure_threshold=2, breaker_recovery_s=30.0)
    for i in range(2):
        assert _get(f"{base}/upload/w_20,o_png/http://down.example.com/{i}.png")[0] == 404
    status, headers, body = _get(f"{base}/upload/w_20,o_png/http://down.example.com/9.png")
    assert status == 503 and b"CircuitOpenException" in body
    assert int(headers["Retry-After"]) >= 1 and injector.fired["fetch.http"] == 2
