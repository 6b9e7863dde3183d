"""The port's policy autotuner (flyimg_tpu_torch/runtime/autotuner.py), its
signal window (runtime/observatory.py) and the batcher's live policy
(runtime/batcher.py ``policy``/``apply_policy``) held against the JAX
package's (flyimg_tpu/runtime/autotuner.py, observatory.py, batcher.py) on
the CPU:

- ``DecisionEngine.propose``, ``objective`` and ``freeze_pressure`` give
  the same answers in both packages on 240 signal windows and policies
  made from a numpy seed;
- two ``PolicyAutotuner``s over the same injected clock and signal
  sequence, with fake knobs, end with the same history (action, knob,
  from, to, reason), the same known-good table and the same knob values;
- ``apply_policy`` clamps as the JAX batcher's does, a group flushes at the
  new ``max_batch``, a shorter deadline re-arms the executor's wait, and a
  concurrent reader never sees a torn pair;
- twins of tests/test_autotuner.py's cases that touch no JAX-only module
  (envelopes, each rule, the state machine, metrics, the fault point, the
  stage pools' resize, the reuse signal), and the server: off by default
  (no ``flyimg_autotune`` family, ``/debug/autotune`` the JAX app's
  document), 404 without debug, and on, its knobs bound live.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.runtime import autotuner as jat
from flyimg_tpu.runtime.batcher import BatchController as JBatchController
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.ops import resample
from flyimg_tpu_torch.runtime import autotuner as at
from flyimg_tpu_torch.runtime.autotuner import (
    DOWN,
    ENVELOPES,
    UP,
    DecisionEngine,
    Envelope,
    PolicyAutotuner,
    default_envelopes,
    reuse_signal_fn,
)
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.runtime.hostpipeline import HostPipeline, StagePool
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.runtime.observatory import SignalWindow
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
from flyimg_tpu_torch.testing import faults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.clear()
    resample.set_auto_band_frac(1.0)


class FakeClock:
    def __init__(self, start: float = 1000.0) -> None:
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


def _ctrl(window=20, occ=0.5, wait=0.0, pad=None, per_miss=10.0):
    return {
        "window_batches": window,
        "mean_occupancy": occ,
        "queue_wait_share": wait,
        "padding_waste": pad if pad is not None else 1.0 - occ,
        "batches_per_compile_miss": per_miss,
    }


DEVICE_POLICY = {
    "device.max_batch": 64.0,
    "device.deadline_ms": 4.0,
    "codec.max_batch": 32.0,
    "codec.deadline_ms": 1.0,
    "host.fetch_workers": 4.0,
    "host.decode_workers": 2.0,
    "host.encode_workers": 2.0,
    "reuse.min_scale": 2.0,
    "resample.auto_band_frac": 1.0,
}


# ---------------------------------------------------------------------------
# held against the JAX package


def test_tables_equal_the_jax_tables():
    assert ENVELOPES == {k: Envelope(v.lo, v.hi, v.step, v.kind)
                         for k, v in jat.ENVELOPES.items()}
    assert (at.UP, at.DOWN, at.REVERT) == (jat.UP, jat.DOWN, jat.REVERT)
    for name in ("MIN_WINDOW_BATCHES", "OCC_FULL", "OCC_SPARSE", "WAIT_HIGH", "WAIT_LOW",
                 "PAD_HIGH", "POOL_SATURATED", "POOL_COLD_SAT", "POOL_COLD_BUSY",
                 "REUSE_MIN_ATTEMPTS", "REUSE_LOW_RATIO", "COMPILE_CHURN", "COMPILE_WARM"):
        assert getattr(DecisionEngine, name) == getattr(jat.DecisionEngine, name), name


def _random_window(rng):
    """One signal window with every source the rules read, values spread
    over each rule's thresholds."""
    controllers = {}
    for name in ("device", "codec"):
        if rng.random() < 0.8:
            occ = float(rng.choice([0.05, 0.2, 0.35, 0.5, 0.7, 0.9, 0.95, 1.0, rng.random()]))
            stats = _ctrl(window=int(rng.choice([0, 3, 8, 20, 64])), occ=occ,
                          wait=float(rng.choice([0.0, 0.04, 0.05, 0.1, 0.25, 0.5])),
                          pad=float(rng.choice([1.0 - occ, 0.5, 0.6, 0.1])),
                          per_miss=float(rng.choice([0.0, 1.0, 3.9, 10.0, 40.0])))
            if rng.random() < 0.6:
                stats["launches_delta"] = float(rng.choice([0.0, 4.0, 8.0, 30.0]))
            controllers[name] = stats
    host = {}
    for stage in ("fetch", "decode", "encode"):
        if rng.random() < 0.5:
            host[stage] = {"saturation": float(rng.choice([0.0, 0.04, 0.3, 0.75, 0.9])),
                           "busy_frac": float(rng.choice([0.0, 0.1, 0.5, 1.0]))}
    window = {"controllers": controllers, "host": host,
              "kernel_mode": str(rng.choice(["dense", "banded", "auto"]))}
    if rng.random() < 0.5:
        window["reuse"] = {"attempts": float(rng.choice([0, 10, 32, 100])),
                           "hit_ratio": (None if rng.random() < 0.2
                                         else float(rng.choice([0.0, 0.2, 0.3, 0.8])))}
    if rng.random() < 0.4:
        window["burn_fast_norm"] = float(rng.choice([0.0, 0.5, 0.9, 1.0, 1.6, 3.0]))
    if rng.random() < 0.3:
        window["burn_slow_norm"] = float(rng.choice([0.0, 0.74, 1.2]))
    if rng.random() < 0.3:
        window["brownout_level"] = int(rng.integers(0, 4))
    return window


def _random_policy(rng):
    policy = {}
    for name, env in ENVELOPES.items():
        if rng.random() < 0.85:
            policy[name] = float(rng.choice([env.lo, env.hi, env.clamp(
                env.lo + rng.integers(0, 8) * env.step)]))
    return policy


def test_decision_engine_matches_the_jax_engine_on_seeded_windows():
    rng = np.random.default_rng(2026)
    ours, theirs = DecisionEngine(), jat.DecisionEngine()
    proposals = 0
    for _ in range(240):
        window, policy = _random_window(rng), _random_policy(rng)
        blocked = {k for k in policy if rng.random() < 0.1}
        got = ours.propose(window, policy, ENVELOPES, blocked=blocked)
        want = theirs.propose(window, policy, jat.ENVELOPES, blocked=blocked)
        assert (got is None) == (want is None)
        if got is not None:
            proposals += 1
            assert (got.knob, got.target, got.direction, got.reason) == (
                want.knob, want.target, want.direction, want.reason)
        assert ours.objective(window) == theirs.objective(window)
        assert ours.freeze_pressure(window) == theirs.freeze_pressure(window)
    assert proposals >= 60     # the windows exercise the rules, not just None


def _knobbed(module, clock, signals):
    boxes = dict(DEVICE_POLICY)
    tuner = module.PolicyAutotuner(
        enabled=True, interval_s=10.0, regression_margin=0.05, cooldown_periods=2,
        freeze_at=1.0, unfreeze_hysteresis=0.75, freeze_dwell_s=30.0, clock=clock,
        metrics=(MetricsRegistry() if module is at else None))
    tuner._signals = lambda: signals[0]
    for name in DEVICE_POLICY:
        tuner.bind(name, lambda n=name: boxes[n], lambda v, n=name: boxes.__setitem__(n, v))
    return tuner, boxes


def test_tuner_history_equals_the_jax_tuner():
    rng = np.random.default_rng(7)
    clock, signals = FakeClock(), [None]
    ours, our_knobs = _knobbed(at, clock, signals)
    theirs, their_knobs = _knobbed(jat, clock, signals)
    for step in range(160):
        signals[0] = _random_window(rng)
        if step % 40 in range(10, 14):
            signals[0]["burn_fast_norm"] = 2.0       # a burn that freezes tuning
        ours.evaluate()
        theirs.evaluate()
        clock.advance(float(rng.choice([3.0, 11.0, 11.0, 31.0])))

    def rows(tuner):
        return [(h["action"], h["knob"], h["from"], h["to"], h["reason"])
                for h in tuner.snapshot()["history"]]

    assert rows(ours) == rows(theirs)
    actions = {row[0] for row in rows(ours)}
    assert {"adjust", "freeze", "unfreeze"} <= actions
    assert ours.known_good() == theirs.known_good()
    assert our_knobs == their_knobs
    a, b = ours.snapshot(), theirs.snapshot()
    for key in ("frozen", "policy", "known_good", "envelopes", "pending", "cooldown",
                "adjustments_total"):
        assert a[key] == b[key], key


def test_apply_policy_clamps_as_the_jax_batcher():
    ours = BatchController(max_batch=8, deadline_ms=2.0, lone_flush=False, device="cpu")
    theirs = JBatchController(max_batch=8, deadline_ms=2.0, lone_flush=False)
    try:
        for kw in ({"max_batch": 10_000}, {"max_batch": 0, "deadline_ms": -5.0},
                   {"deadline_ms": 7.5}, {"max_batch": 17}, {}, {"max_batch": 64.9}):
            assert ours.apply_policy(**kw) == theirs.apply_policy(**kw), kw
            assert ours.policy() == theirs.policy()
            assert (ours.max_batch, ours.deadline_s) == (theirs.max_batch, theirs.deadline_s)
    finally:
        ours.close()
        theirs.close()


def test_apply_policy_clamps_and_notifies():
    ctrl = BatchController(max_batch=8, deadline_ms=2.0, lone_flush=False, device="cpu")
    try:
        assert ctrl.apply_policy(max_batch=10_000) == (64, 0.002)
        assert ctrl.apply_policy(max_batch=0, deadline_ms=-5.0) == (1, 0.0)
        assert ctrl.policy() == (1, 0.0)
        assert ctrl.max_batch == 1 and ctrl.deadline_s == 0.0
    finally:
        ctrl.close()


def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, (48, 64, 3), dtype=np.uint8)


def test_a_group_flushes_at_the_new_max_batch():
    plan = build_plan(OptionsBag("w_16,h_12,c_1"), 64, 48)
    ctrl = BatchController(max_batch=8, deadline_ms=60_000.0, lone_flush=False, device="cpu")
    try:
        ctrl.apply_policy(max_batch=3)
        futures = [ctrl.submit(_img(i), plan) for i in range(6)]
        for fut in futures:
            fut.result(timeout=60)
        assert list(ctrl.launch_log) == [("transform", 3, 4), ("transform", 3, 4)]
        # a lone member waits out the long deadline until a shorter one
        # re-arms the executor's wait
        lone = ctrl.submit(_img(9), plan)
        time.sleep(0.05)
        assert not lone.done()
        t0 = time.monotonic()
        ctrl.apply_policy(deadline_ms=1.0)
        lone.result(timeout=10)
        assert time.monotonic() - t0 < 5.0
        assert list(ctrl.launch_log)[-1] == ("transform", 1, 1)
    finally:
        ctrl.close()


def _echo_runner(payloads):
    return list(payloads)


def test_batcher_policy_pair_never_tears_under_churn():
    ctrl = BatchController(max_batch=8, deadline_ms=2.0, lone_flush=False, device="cpu")
    pairs = {(8, 0.002), (16, 0.004)}
    torn = []
    stop = threading.Event()

    def writer():
        flip = False
        while not stop.is_set():
            if flip:
                ctrl.apply_policy(max_batch=8, deadline_ms=2.0)
            else:
                ctrl.apply_policy(max_batch=16, deadline_ms=4.0)
            flip = not flip

    def reader():
        while not stop.is_set():
            pair = ctrl.policy()
            if pair not in pairs:
                torn.append(pair)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        futures = [ctrl.submit_aux(("torn",), i, _echo_runner) for i in range(200)]
        assert [f.result(timeout=60) for f in futures] == list(range(200))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        ctrl.close()
    assert torn == []


# ---------------------------------------------------------------------------
# envelopes and rules (twins)


def test_envelope_clamp_move_and_int_kind():
    env = Envelope(4, 64, 8, "int")
    assert env.clamp(100) == 64
    assert env.clamp(-3) == 4
    assert env.move(60, UP) == 64
    assert env.move(4, DOWN) == 4
    f = Envelope(0.5, 20.0, 1.0)
    assert f.move(4.0, DOWN) == 3.0
    assert f.move(0.9, DOWN) == 0.5


def test_default_envelopes_overrides_and_malformed_fallback():
    overrides = {
        "device.deadline_ms": {"lo": 1.0, "hi": 8.0, "step": 0.5},
        "device.max_batch": {"lo": "garbage"},
        "not.a.knob": {"lo": 0, "hi": 1, "step": 1},
    }
    envs = default_envelopes(overrides)
    assert envs["device.deadline_ms"] == Envelope(1.0, 8.0, 0.5)
    assert envs["device.max_batch"] == ENVELOPES["device.max_batch"]
    assert "not.a.knob" not in envs
    theirs = jat.default_envelopes(overrides)
    assert {k: (e.lo, e.hi, e.step, e.kind) for k, e in envs.items()} == \
        {k: (e.lo, e.hi, e.step, e.kind) for k, e in theirs.items()}


RULES = [
    # (window, policy overrides, blocked, (knob, direction, target) or None)
    ({"controllers": {"device": _ctrl(occ=0.95)}}, {"device.max_batch": 32.0}, None,
     ("device.max_batch", UP, 40.0)),
    ({"controllers": {"device": _ctrl(occ=0.6, wait=0.4)}}, {}, None,
     ("device.deadline_ms", DOWN, 3.0)),
    ({"controllers": {"device": _ctrl(occ=0.1, wait=0.0)}}, {}, None,
     ("device.deadline_ms", DOWN, 3.0)),
    ({"controllers": {"device": _ctrl(occ=0.45, wait=0.0, pad=0.55)}}, {}, None,
     ("device.deadline_ms", UP, 5.0)),
    ({"controllers": {"device": _ctrl(window=3, occ=0.95)}}, {}, None, None),
    ({"controllers": {}, "host": {"decode": {"saturation": 0.9, "busy_frac": 1.0}}}, {},
     None, ("host.decode_workers", UP, 3.0)),
    ({"controllers": {}, "reuse": {"attempts": 100, "hit_ratio": 0.1}}, {}, None,
     ("reuse.min_scale", DOWN, 1.75)),
    ({"controllers": {}, "reuse": {"attempts": 5, "hit_ratio": 0.0}}, {}, None, None),
    ({"controllers": {"device": _ctrl(occ=0.6, wait=0.1, per_miss=2.0)},
      "kernel_mode": "auto"}, {}, None, ("resample.auto_band_frac", DOWN, 0.75)),
    ({"controllers": {"device": _ctrl(occ=0.6, wait=0.1, per_miss=64.0)},
      "kernel_mode": "auto"}, {"resample.auto_band_frac": 0.5}, None,
     ("resample.auto_band_frac", UP, 0.75)),
    ({"controllers": {"device": _ctrl(occ=0.6, wait=0.1, per_miss=2.0)},
      "kernel_mode": "dense"}, {}, None, None),
    ({"controllers": {"device": _ctrl(occ=0.1, wait=0.0)}}, {"device.deadline_ms": 0.5},
     None, None),
    ({"controllers": {"device": _ctrl(occ=0.1, wait=0.0)}}, {}, {"device.deadline_ms"},
     None),
]


@pytest.mark.parametrize("window,over,blocked,want", RULES)
def test_rules(window, over, blocked, want):
    policy = dict(DEVICE_POLICY, **over)
    got = DecisionEngine().propose(window, policy, ENVELOPES, blocked=blocked)
    if want is None:
        assert got is None
    else:
        assert (got.knob, got.direction, got.target) == want
    theirs = jat.DecisionEngine().propose(window, policy, jat.ENVELOPES, blocked=blocked)
    assert (None if got is None else (got.knob, got.target, got.reason)) == \
        (None if theirs is None else (theirs.knob, theirs.target, theirs.reason))


def test_cold_pool_shed_requires_recent_traffic_evidence():
    eng = DecisionEngine()
    cold = {"host": {"fetch": {"saturation": 0.0, "busy_frac": 0.0}}}
    assert eng.propose({"controllers": {}, **cold}, dict(DEVICE_POLICY), ENVELOPES) is None
    stale = _ctrl(occ=0.6, wait=0.1)
    stale["launches_delta"] = 0.0
    assert eng.propose({"controllers": {"device": stale}, **cold},
                       dict(DEVICE_POLICY), ENVELOPES) is None
    live = _ctrl(occ=0.6, wait=0.1)
    live["launches_delta"] = 20.0
    got = eng.propose({"controllers": {"device": live}, **cold}, dict(DEVICE_POLICY),
                      ENVELOPES)
    assert got.knob == "host.fetch_workers" and got.direction == DOWN
    got = eng.propose({"controllers": {"device": _ctrl(occ=0.6, wait=0.1)}, **cold},
                      dict(DEVICE_POLICY), ENVELOPES)
    assert got is not None


def test_freeze_pressure_from_burn_and_brownout_level():
    eng = DecisionEngine()
    assert eng.freeze_pressure({"burn_fast_norm": 1.3}) == 1.3
    assert eng.freeze_pressure({"burn_fast_norm": 0.2, "burn_slow_norm": 0.9}) == 0.9
    assert eng.freeze_pressure({"brownout_level": 2}) >= 1.0
    assert eng.freeze_pressure({"brownout_level": 1}) == 0.0


def test_signal_assembly_stamps_launch_recency():
    metrics = MetricsRegistry()
    tuner = PolicyAutotuner(enabled=True, metrics=metrics)
    tuner.attach_signals(metrics=metrics)
    for _ in range(10):
        metrics.record_batch_launch("device", images=2, capacity=16, queue_wait_s=0.0,
                                    device_s=0.01, compile_hit=True)
    assert tuner._signals()["controllers"]["device"]["launches_delta"] == 0.0
    for _ in range(6):
        metrics.record_batch_launch("device", images=2, capacity=16, queue_wait_s=0.0,
                                    device_s=0.01, compile_hit=True)
    assert tuner._signals()["controllers"]["device"]["launches_delta"] == 6.0
    assert tuner._signals()["controllers"]["device"]["launches_delta"] == 0.0
    # one window a reader: a second one counts the same launches again
    other = SignalWindow()
    other.attach(metrics=metrics)
    other.assemble()
    metrics.record_batch_launch("device", images=2, capacity=16, queue_wait_s=0.0,
                                device_s=0.01, compile_hit=True)
    assert other.assemble()["controllers"]["device"]["launches_delta"] == 1.0
    assert tuner._signals()["controllers"]["device"]["launches_delta"] == 1.0


# ---------------------------------------------------------------------------
# the state machine (twins; fake knobs, injected signals and clock)


class _Box:
    def __init__(self, v: float) -> None:
        self.v = float(v)


def _tuner(clock, sig_box, metrics=None, **over):
    kw = dict(enabled=True, interval_s=10.0, regression_margin=0.05, cooldown_periods=2,
              freeze_at=1.0, unfreeze_hysteresis=0.75, freeze_dwell_s=30.0,
              metrics=metrics or MetricsRegistry(), clock=clock)
    kw.update(over)
    tuner = PolicyAutotuner(**kw)
    tuner._signals = lambda: sig_box[0]
    return tuner


def _bound(tuner, v=4.0):
    box = _Box(v)
    tuner.bind("device.deadline_ms", lambda: box.v, lambda x: setattr(box, "v", x))
    return box


SPARSE = {"controllers": {"device": _ctrl(occ=0.1, wait=0.0)}}


def test_rate_limit_under_injected_clock():
    clock = FakeClock()
    tuner = _tuner(clock, [SPARSE])
    box = _bound(tuner)
    tuner.evaluate()
    assert box.v == 3.0
    tuner.evaluate()
    assert box.v == 3.0
    clock.advance(11.0)
    tuner.evaluate()
    assert box.v == 2.0


def test_surviving_adjustment_commits_to_known_good():
    clock = FakeClock()
    tuner = _tuner(clock, [SPARSE])
    _bound(tuner)
    tuner.evaluate()
    assert tuner.snapshot()["known_good"]["device.deadline_ms"] == 4.0
    clock.advance(11.0)
    tuner.evaluate()
    assert tuner.snapshot()["known_good"]["device.deadline_ms"] == 3.0


def test_regression_reverts_and_cools_down():
    clock = FakeClock()
    sig = [SPARSE]
    tuner = _tuner(clock, sig)
    box = _bound(tuner)
    tuner.evaluate()
    assert box.v == 3.0
    sig[0] = {"controllers": {"device": _ctrl(occ=0.05, wait=0.6)}}
    clock.advance(11.0)
    tuner.evaluate()
    assert box.v == 4.0
    assert [h["action"] for h in tuner.snapshot()["history"]] == ["adjust", "revert"]
    sig[0] = SPARSE
    for want in (4.0, 4.0, 3.0):
        clock.advance(11.0)
        tuner.evaluate()
        assert box.v == want


def test_burn_freeze_reverts_to_known_good_and_dwells():
    clock = FakeClock()
    sig = [SPARSE]
    metrics = MetricsRegistry()
    tuner = _tuner(clock, sig, metrics=metrics)
    tuner.register_metrics(metrics)
    box = _bound(tuner)
    tuner.evaluate()
    assert box.v == 3.0
    sig[0] = {"controllers": {}, "burn_fast_norm": 1.5}
    clock.advance(11.0)
    tuner.evaluate()
    assert tuner.frozen and box.v == 4.0
    assert "flyimg_autotune_frozen 1" in metrics.render_prometheus()
    sig[0] = dict(SPARSE, burn_fast_norm=1.5)
    clock.advance(11.0)
    tuner.evaluate()
    assert box.v == 4.0 and tuner.frozen
    sig[0] = dict(SPARSE, burn_fast_norm=0.1)
    clock.advance(11.0)
    tuner.evaluate()
    assert tuner.frozen
    clock.advance(31.0)
    tuner.evaluate()
    assert not tuner.frozen
    clock.advance(11.0)
    tuner.evaluate()
    assert box.v == 3.0
    assert [h["action"] for h in tuner.snapshot()["history"]] == [
        "adjust", "freeze", "unfreeze", "adjust"]


def test_adjustment_counter_and_envelope_bound_in_metrics():
    clock = FakeClock()
    metrics = MetricsRegistry()
    tuner = _tuner(clock, [SPARSE], metrics=metrics)
    box = _bound(tuner)
    for _ in range(50):
        tuner.evaluate()
        clock.advance(11.0)
    assert box.v == ENVELOPES["device.deadline_ms"].lo
    assert ('flyimg_autotune_adjustments_total{knob="device.deadline_ms",'
            'direction="down"}') in metrics.render_prometheus()


def test_disabled_tuner_is_inert():
    metrics = MetricsRegistry()
    tuner = PolicyAutotuner(enabled=False, metrics=metrics, clock=FakeClock())
    tuner.register_metrics(metrics)
    box = _bound(tuner)
    tuner._signals = lambda: SPARSE
    tuner.evaluate()
    assert box.v == 4.0
    assert "flyimg_autotune" not in metrics.render_prometheus()
    assert tuner.snapshot()["enabled"] is False


def test_bind_rejects_envelope_less_knob():
    with pytest.raises(ValueError):
        PolicyAutotuner(enabled=True).bind("made.up", lambda: 1.0, lambda v: None)


def test_fault_point_overrides_signals_and_rate_limit():
    tuner = _tuner(FakeClock(), [{"controllers": {}}])
    box = _bound(tuner)
    injector = faults.install(faults.FaultInjector())
    injector.plan("autotune.signal", lambda **_: SPARSE)
    tuner.evaluate()
    tuner.evaluate()
    assert box.v == 2.0


def test_stagepool_resize_grows_and_shrinks_under_load():
    pool = StagePool("decode", workers=2, queue_depth=4, wedge_timeout_s=0.0)
    try:
        gate = threading.Event()
        blocked = [pool.submit(lambda: (gate.wait(30), "slow")[1]) for _ in range(2)]
        assert pool.resize(4) == 4
        assert pool.stats()["workers"] == 4.0
        assert pool.admission.max_pending == 4 + 4
        for fut in [pool.submit(lambda: "fast") for _ in range(2)]:
            assert fut.result(timeout=10) == "fast"
        gate.set()
        for fut in blocked:
            assert fut.result(timeout=10) == "slow"
        assert pool.resize(1) == 1
        assert pool.stats()["workers"] == 1.0
        assert pool.admission.max_pending == 1 + 4
        assert pool.submit(lambda: "after").result(timeout=10) == "after"
        assert pool.resize(0) == 1
    finally:
        pool.close()


def test_host_pipeline_apply_policy_roundtrip():
    pipeline = HostPipeline(enabled=True, fetch_workers=4, decode_workers=2,
                            encode_workers=2, queue_depth=4)
    try:
        assert pipeline.policy() == {"fetch": 4, "decode": 2, "encode": 2}
        assert pipeline.apply_policy({"decode": 3, "nope": 9}) == {"decode": 3}
        assert pipeline.policy()["decode"] == 3
    finally:
        pipeline.close()


def test_auto_band_frac_steers_selection_not_identity():
    geometry = ("auto", "lanczos3", (60, 60), (0.0, 60.0), (0.0, 60.0), (30.0, 30.0))
    assert resample.set_auto_band_frac(1.0) == 1.0
    banded = resample.select_band_taps(*geometry)
    assert banded == (16, 16)
    assert resample.set_auto_band_frac(0.25) == 0.25
    assert resample.select_band_taps(*geometry) is None
    from flyimg_tpu_torch.runtime.batcher import build_batched_program

    plan = build_plan(OptionsBag("w_30,h_30,c_1"), 60, 60).device_plan()
    resample.set_auto_band_frac(1.0)
    h1 = build_batched_program(1, (60, 60), (30, 30), None, (0, 0), plan, "cpu", False, banded)
    resample.set_auto_band_frac(0.5)
    h2 = build_batched_program(1, (60, 60), (30, 30), None, (0, 0), plan, "cpu", False, banded)
    assert h1 is h2
    h3 = build_batched_program(1, (60, 60), (30, 30), None, (0, 0), plan, "cpu", False, None)
    assert h3 is not h1
    assert resample.set_auto_band_frac(0.0) == 0.1
    assert resample.set_auto_band_frac(7.0) == 1.0


def test_reuse_signal_fn_windows_per_read():
    metrics = MetricsRegistry()

    def bump(outcome, n):
        metrics.counter(f'flyimg_reuse_hits_total{{outcome="{outcome}"}}',
                        "Cache-miss reuse-rewriter decisions by outcome").inc(n)

    read = reuse_signal_fn(metrics)
    bump("miss", 40)
    assert read() == {"attempts": 40, "hit_ratio": 0.0}
    bump("hit", 40)
    assert read() == {"attempts": 40, "hit_ratio": 1.0}
    assert read() == {"attempts": 0, "hit_ratio": None}


def test_stagepool_retiree_never_swallows_a_stop_sentinel():
    pool = StagePool("decode", workers=2, queue_depth=4, wedge_timeout_s=0.0)
    assert pool.submit(lambda: "warm").result(timeout=10) == "warm"
    pool.resize(1)
    time.sleep(0.1)
    t0 = time.monotonic()
    pool.close(drain_timeout_s=10.0)
    assert time.monotonic() - t0 < 5.0


def test_reuse_min_scale_applier_is_a_plain_store():
    class H:
        reuse_enable = True
        reuse_min_scale = 2.0

    tuner = PolicyAutotuner(enabled=True)
    handler = H()
    tuner.register_knobs(handler=handler, resample=False)
    tuner._knobs["reuse.min_scale"].applier(1.75)
    assert handler.reuse_min_scale == 1.75


# ---------------------------------------------------------------------------
# the server


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _serve(tmp_path, **extra):
    src = tmp_path / "src.png"
    Image.fromarray(np.random.default_rng(5).integers(0, 255, (48, 64, 3),
                                                      dtype=np.uint8)).save(src)
    server = make_server(AppParameters({"upload_dir": str(tmp_path / "u"),
                                        "tmp_dir": str(tmp_path / "t"), **extra}),
                         device="cpu")
    thread = serve_in_thread(server)
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}", str(src)


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_default_off_no_metrics_and_debug_document(tmp_path):
    resample.set_auto_band_frac(0.5)     # a previous server's tuned value
    server, thread, base, src = _serve(tmp_path, debug=True)
    try:
        assert resample.auto_band_frac() == 1.0
        assert _get(f"{base}/upload/w_32,o_png/{src}")[0] == 200
        assert "flyimg_autotune" not in _get(f"{base}/metrics")[1].decode()
        status, body = _get(f"{base}/debug/autotune")
        doc = json.loads(body)
        assert status == 200 and doc["enabled"] is False
        assert doc["history"] == [] and doc["policy"] == {}
    finally:
        _stop(server, thread)


def test_debug_autotune_is_404_without_debug(tmp_path):
    server, thread, base, _src = _serve(tmp_path, debug=False, autotune_enable=True)
    try:
        assert _get(f"{base}/debug/autotune")[0] == 404
    finally:
        _stop(server, thread)


def test_enabled_tuner_binds_live_knobs_in_the_app(tmp_path):
    clock = FakeClock()
    server, thread, base, src = _serve(
        tmp_path, debug=True, autotune_enable=True, autotune_interval_s=5.0,
        autotune_clock=clock, slo_latency_p99_ms=60000.0)
    try:
        assert _get(f"{base}/upload/w_32,o_png/{src}")[0] == 200
        doc = json.loads(_get(f"{base}/debug/autotune")[1])
        assert doc["enabled"] is True
        for name, value in doc["policy"].items():
            env = doc["envelopes"][name]
            assert env["lo"] <= value <= env["hi"], (name, value)
        for name in ("device.deadline_ms", "device.max_batch", "codec.deadline_ms",
                     "host.decode_workers"):
            assert name in doc["policy"], name
        for _ in range(24):
            server.metrics.record_batch_launch("device", images=2, capacity=16,
                                               queue_wait_s=0.0, device_s=0.01,
                                               compile_hit=True)
        clock.advance(11.0)
        assert _get(f"{base}/upload/w_32,o_png/{src}")[0] == 200
        doc = json.loads(_get(f"{base}/debug/autotune")[1])
        assert doc["policy"]["device.deadline_ms"] == 3.0
        assert server.batcher.policy()[1] == 0.003
        assert server.autotuner.snapshot()["adjustments_total"] == 1
        assert "flyimg_autotune_frozen 0" in _get(f"{base}/metrics")[1].decode()
    finally:
        _stop(server, thread)
