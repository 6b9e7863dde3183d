"""The metrics registry of the PyTorch package held against the JAX
package's: one seeded sequence of ``record_*`` calls into both registries
renders byte-equal, in Prometheus text 0.0.4 and in OpenMetrics with
exemplars (the uptime line, a wall-clock reading, is pinned by giving both
registries one start time), and ``summary``, ``perf_snapshot`` and the
batch-efficiency windows are equal."""

import random

import pytest

from flyimg_tpu.runtime import metrics as jm
from flyimg_tpu.runtime import tracing as jt
from flyimg_tpu_torch.runtime import metrics as tm
from flyimg_tpu_torch.runtime import tracing as tt


def _drive(mod, tracing_mod, seed, registry):
    rng = random.Random(seed)
    routes = ["upload", "path", "metrics", 'we"ird\\route\n', "index"]
    for i in range(rng.randrange(20, 60)):
        op = rng.randrange(14)
        trace_id = "%032x" % rng.getrandbits(128) if rng.random() < 0.5 else None
        if op == 0:
            registry.record_request(rng.choice(routes), rng.choice([200, 304, 403, 500, 503]))
        elif op == 1:
            trace = tracing_mod.Trace(trace_id) if trace_id else None
            with tracing_mod.activate(trace):
                registry.record_stage(rng.choice(["fetch", "decode", "encode", "total"]),
                                      rng.random() * rng.choice([0.001, 0.1, 10.0]))
        elif op == 2:
            registry.record_device_batch_seconds(rng.random() / 10, trace_id=trace_id)
        elif op == 3:
            registry.record_device_split(h2d_s=rng.random() / 1000,
                                         dispatch_s=rng.random() / 1000,
                                         sync_s=rng.random() / 100, trace_id=trace_id)
        elif op == 4:
            registry.record_compile_event(rng.random() < 0.8)
        elif op == 5:
            registry.record_cache(rng.random() < 0.5)
        elif op == 6:
            registry.record_retry(rng.choice(["fetch", "storage.read"]))
        elif op == 7:
            registry.record_breaker(rng.choice(["a.com", "b.org:8080"]),
                                    rng.choice(["open", "closed", "half_open"]))
        elif op == 8:
            registry.record_shed(rng.choice(["batch queue", "host fetch pool"]))
        elif op == 9:
            registry.record_deadline_hit(rng.choice(["fetch", "encode"]))
        elif op == 10:
            n = rng.randrange(1, 9)
            registry.record_batch_launch(
                rng.choice(["device", "codec"]), images=n, capacity=max(n, 8),
                queue_wait_s=rng.random() / 100, device_s=rng.random() / 10,
                compile_hit=rng.choice([True, False, None]), trace_id=trace_id,
                aux=rng.random() < 0.3)
        elif op == 11:
            registry.record_batch_retry()
            registry.record_poison_isolated()
            registry.record_quarantine_hit()
            registry.record_executor_restart(rng.choice(["dead", "wedged"]))
            registry.record_cache_corrupt()
        elif op == 12:
            registry.gauge("flyimg_inflight_requests", "HTTP requests currently in flight").inc()
            registry.gauge('flyimg_host_pool_queue_depth{pool="decode"}',
                           "Pending (queued or executing) tasks per host stage pool",
                           fn=lambda v=i: float(v))
        else:
            registry.histogram("flyimg_custom_seconds", "A custom family",
                               bounds=(0.1, 1.0)).observe(rng.random() * 2, trace_id=trace_id)


def _registries(seed, exemplars=True):
    regs = []
    for mod, tracing_mod in ((jm, jt), (tm, tt)):
        reg = mod.MetricsRegistry(exemplars=exemplars)
        reg.started_at = 1_700_000_000.0
        _drive(mod, tracing_mod, seed, reg)
        regs.append(reg)
    return regs


def _pin_times(text):
    # exemplar timestamps are the wall clock of each observation
    import re

    text = re.sub(r"(# \{trace_id=\"[0-9a-f]+\"\} \S+) \d+\.\d{3}", r"\1 T", text)
    return re.sub(r"flyimg_uptime_seconds \S+", "flyimg_uptime_seconds U", text)


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("openmetrics", [False, True])
def test_render_is_byte_equal(seed, openmetrics):
    jreg, treg = _registries(seed)
    assert _pin_times(treg.render_prometheus(openmetrics=openmetrics)) == \
        _pin_times(jreg.render_prometheus(openmetrics=openmetrics))


@pytest.mark.parametrize("seed", range(6))
def test_summary_and_perf_snapshot_are_equal(seed):
    jreg, treg = _registries(seed, exemplars=False)
    assert treg.perf_snapshot() == jreg.perf_snapshot()
    tsum, jsum = treg.summary(), jreg.summary()
    # the ledgers are each package's own process-wide table
    assert {k: v for k, v in tsum.items() if not k.startswith("plan_ledger:")} == \
        {k: v for k, v in jsum.items() if not k.startswith("plan_ledger:")}
    for family in ("flyimg_requests_total", "flyimg_cache_total", "flyimg_shed_total"):
        assert treg.family_total(family) == jreg.family_total(family)


@pytest.mark.parametrize("value", ["plain", 'q"uote', "back\\slash", "new\nline"])
def test_label_escaping_is_the_same(value):
    assert tm.escape_label_value(value) == jm.escape_label_value(value)


def test_quantile_rule_is_the_same():
    rng = random.Random(3)
    for _ in range(50):
        counts = [rng.randrange(0, 5) for _ in range(len(tm.BUCKET_BOUNDS) + 1)]
        for q in (0.5, 0.9, 0.99):
            assert tm.quantile_from_counts(counts, tm.BUCKET_BOUNDS, q) == \
                jm.quantile_from_counts(counts, jm.BUCKET_BOUNDS, q)
