"""The SLO engine of the PyTorch package held against the JAX package's:
with one injected clock, the same seeded stream of request outcomes gives
equal snapshots, summary fields, breach listeners' payloads and
``flyimg_slo_*`` renders at every step."""

import random

import pytest

from flyimg_tpu.runtime import metrics as jm
from flyimg_tpu.runtime import slo as js
from flyimg_tpu.runtime import tracing as jt
from flyimg_tpu_torch.runtime import metrics as tm
from flyimg_tpu_torch.runtime import slo as ts
from flyimg_tpu_torch.runtime import tracing as tt

CONFIGS = [
    dict(latency_p99_ms=150.0, availability=99.9),
    dict(latency_p99_ms=20.0, availability=99.0, window_fast_s=60.0,
         window_slow_s=600.0, burn_threshold_fast=2.0, burn_threshold_slow=1.0),
    dict(enabled=False),
]


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _engine(mod, metrics_mod, config):
    clock = Clock()
    registry = metrics_mod.MetricsRegistry()
    engine = mod.SloEngine(clock=clock, metrics=registry, **config)
    engine.register_metrics(registry)
    breaches = []
    engine.add_breach_listener(lambda info: breaches.append(dict(info)))
    return engine, clock, registry, breaches


def _uptime_free(text):
    return "\n".join(l for l in text.splitlines() if "uptime" not in l)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", range(4))
def test_same_outcomes_give_equal_state(config, seed):
    je, jc, jr, jb = _engine(js, jm, config)
    te, tc, tr, tb = _engine(ts, tm, config)
    rng = random.Random(seed)
    for step in range(400):
        dt = rng.random() * rng.choice([0.05, 2.0, 30.0])
        jc.now += dt
        tc.now += dt
        duration = rng.random() * rng.choice([0.01, 0.2, 1.0])
        ok = rng.random() > rng.choice([0.001, 0.05, 0.4])
        trace_id = "%032x" % rng.getrandbits(128)
        jtrace, ttrace = jt.Trace(trace_id), tt.Trace(trace_id)
        je.record(duration, ok, trace=jtrace)
        te.record(duration, ok, trace=ttrace)
        assert ttrace.force_keep == jtrace.force_keep
        assert [e["name"] for e in ttrace.root.events] == \
            [e["name"] for e in jtrace.root.events]
        if step % 25 == 0:
            assert te.snapshot() == je.snapshot()
            assert te.summary_fields() == je.summary_fields()
            assert _uptime_free(tr.render_prometheus()) == _uptime_free(jr.render_prometheus())
    assert te.snapshot() == je.snapshot()
    assert tb == jb
