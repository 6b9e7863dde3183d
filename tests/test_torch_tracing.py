"""Request tracing of the PyTorch package held against the JAX package's
module: ``traceparent`` parse and format over a corpus of valid and
malformed headers, ``server_timing`` and ``as_dict`` of span trees built
alike, tail-sampling keep decisions under the same seeded ``random``, the
ambient span stack, and the shared batch span's attachment (exact
equality; wall times are set, not measured)."""

import random

import pytest

from flyimg_tpu.runtime import tracing as jt
from flyimg_tpu_torch.runtime import tracing as tt

_HEX = "0123456789abcdef"


def _headers():
    rng = random.Random(7)

    def hx(n):
        return "".join(rng.choice(_HEX) for _ in range(n))

    out = [
        None, "", "garbage", "00-" + "0" * 32 + "-" + hx(16) + "-01",
        "00-" + hx(32) + "-" + "0" * 16 + "-01", "ff-" + hx(32) + "-" + hx(16) + "-01",
        "00-" + hx(31) + "-" + hx(16) + "-01", "00-" + hx(32) + "-" + hx(15) + "-01",
        "00-" + hx(32) + "-" + hx(16) + "-1", "00_" + hx(32) + "_" + hx(16) + "_01",
        "  00-" + hx(32) + "-" + hx(16) + "-01  ", ("00-" + hx(32) + "-" + hx(16) + "-01").upper(),
        "01-" + hx(32) + "-" + hx(16) + "-00-extra", "00-" + hx(32) + "-" + hx(16) + "-0g",
        "zz-" + hx(32) + "-" + hx(16) + "-01",
    ]
    for _ in range(40):
        out.append(f"{hx(2)}-{hx(32)}-{hx(16)}-{hx(2)}")
    return out


@pytest.mark.parametrize("header", _headers())
def test_traceparent_parse_and_format(header):
    assert tt.parse_traceparent(header) == jt.parse_traceparent(header)
    parsed = jt.parse_traceparent(header)
    if parsed is not None:
        for sampled in (True, False):
            assert tt.format_traceparent(parsed["trace_id"], parsed["parent_id"], sampled) == \
                jt.format_traceparent(parsed["trace_id"], parsed["parent_id"], sampled)


def _build(mod, seed):
    """One span tree from a seeded recipe: nested spans, a shared device
    span with the h2d/dispatch/sync split, events, fixed ids and times."""
    rng = random.Random(seed)
    trace = mod.Trace("%032x" % rng.getrandbits(128))
    trace.root.span_id = "%016x" % rng.getrandbits(64)
    trace.root.start_s = 1_700_000_000.0
    names = ["fetch", "storage", "decode", "batch_wait", "smartcrop",
             "encode", "storage", "faces", "weird name!"]
    for i in range(rng.randrange(2, 9)):
        sp = trace.start_span(names[rng.randrange(len(names))])
        sp.span_id = "%016x" % rng.getrandbits(64)
        sp.start_s = 1_700_000_000.0 + i
        sp.duration_s = rng.random() / 10
        sp.set_attribute("i", i)
        sp.add_event("cache.hit", key=f"k{i}")
        for ev in sp.events:
            ev["t_s"] = 1_700_000_001.0
        if rng.random() < 0.5:
            shared = mod.Span("device_execute", span_id="%016x" % rng.getrandbits(64))
            shared.start_s = 1_700_000_000.5
            shared.duration_s = rng.random() / 100
            shared.set_attribute("batch.id", i)
            shared.set_attribute("device.h2d_s", rng.random() / 1000)
            shared.set_attribute("device.dispatch_s", rng.random() / 1000)
            shared.set_attribute("device.sync_s", rng.random() / 1000)
            trace.attach_shared(shared, sp.span_id)
    trace.root.duration_s = 0.75 + rng.random()
    return trace


@pytest.mark.parametrize("seed", range(12))
def test_server_timing_and_tree_of_alike_traces(seed):
    jtrace, ttrace = _build(jt, seed), _build(tt, seed)
    assert tt.server_timing(ttrace) == jt.server_timing(jtrace)
    assert tt.server_timing(ttrace, max_entries=3) == jt.server_timing(jtrace, max_entries=3)
    assert ttrace.as_dict() == jtrace.as_dict()
    assert ttrace.summary() == jtrace.summary()


@pytest.mark.parametrize("rate,slow", [(0.0, 0.5), (0.3, 0.5), (0.7, 0.2), (1.0, 0.5)])
def test_tail_sampling_decisions_under_one_seed(rate, slow):
    decisions = []
    for mod in (jt, tt):
        tracer = mod.Tracer(sample_rate=rate, slow_threshold_s=slow,
                            buffer_size=16, rng=random.Random(99))
        plan = random.Random(5)
        out = []
        for i in range(200):
            trace = tracer.start(None)
            trace.trace_id = "%032x" % i
            kind = plan.random()
            if kind < 0.05:
                trace.add_event("deadline.exceeded", stage="fetch")
            elif kind < 0.1:
                trace.force_keep = True
            trace.root._t0 -= plan.random() * 0.6
            status = "error" if plan.random() < 0.05 else "ok"
            trace.root.duration_s = plan.random() * 0.6
            trace.finished = False
            tracer.finish(trace, status)
            out.append(trace.root.attributes.get("sampling.keep_reason"))
        out.append([s["trace_id"] for s in tracer.list(limit=100)])
        out.append(len(tracer))
        decisions.append(out)
    assert decisions[1] == decisions[0]


def test_ambient_spans_and_events_nest_alike():
    trees = []
    for mod in (jt, tt):
        trace = mod.Trace("ab" * 16)
        with mod.activate(trace):
            assert mod.current_trace() is trace
            with mod.span("fetch", op="x") as outer:
                mod.add_event("retry", attempt=1)
                with mod.span("decode") as inner:
                    assert mod.current_span() is inner
                assert mod.current_span() is outer
        assert mod.current_trace() is None
        with mod.span("orphan") as none_span:
            assert none_span is None
        mod.add_event("lost")   # no ambient trace: a no-op
        trees.append([(s.name, s.parent_id == trace.root.span_id, s.attributes,
                       [e["name"] for e in s.events]) for s in trace.spans])
    assert trees[1] == trees[0]
