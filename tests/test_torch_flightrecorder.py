"""The batch flight recorder of the PyTorch package held against the JAX
package's: with one injected clock, the same seeded records and dump
triggers give equal snapshots, ``recent_summary``, rate-limited dump
decisions, retention, and dump documents (their wall-clock ``at_s``
stamps aside)."""

import json
import os
import random

import pytest

from flyimg_tpu.runtime import flightrecorder as jf
from flyimg_tpu.runtime import metrics as jm
from flyimg_tpu_torch.runtime import flightrecorder as tf
from flyimg_tpu_torch.runtime import metrics as tm


class Clock:
    def __init__(self):
        self.now = 50.0

    def __call__(self):
        return self.now


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k != "at_s"}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _record(rng, i):
    kind = rng.choice(["primary", "primary", "aux", "recovery", "host_stage"])
    n = rng.randrange(1, 9)
    return dict(
        controller=rng.choice(["device", "codec", "host:decode"]),
        batch_id=i if kind != "host_stage" else None,
        plan_key=rng.choice(["abc123", "aux:find_best_crops_batched", None]),
        occupancy=n, capacity=max(n, rng.choice([1, 8, 16])),
        queue_wait_s=rng.random() / 10,
        h2d_s=rng.choice([None, rng.random() / 1000]),
        dispatch_s=rng.choice([None, rng.random() / 1000]),
        sync_s=rng.choice([None, rng.random() / 100]),
        device_s=rng.choice([None, rng.random() / 10]),
        compile_hit=rng.choice([True, False, None]), kind=kind,
        trace_id=rng.choice([None, "%032x" % rng.getrandbits(128)]),
        error=rng.choice([None, None, "RuntimeError"]),
        stage="decode" if kind == "host_stage" else None,
        mem_event=rng.choice([None, None, "presplit", "oversize"]),
        predicted_bytes=rng.choice([None, 1e6]), budget_bytes=rng.choice([None, 4e6]),
    )


@pytest.mark.parametrize("seed", range(6))
def test_same_records_give_equal_state_and_dumps(seed, tmp_path):
    rng = random.Random(seed)
    recorders = []
    size = rng.choice([8, 32])
    for mod, metrics_mod, tag in ((jf, jm, "jax"), (tf, tm, "torch")):
        clock = Clock()
        registry = metrics_mod.MetricsRegistry()
        rec = mod.FlightRecorder(size=size, dump_dir=str(tmp_path / tag),
                                 min_dump_interval_s=5.0, max_dumps=3,
                                 metrics=registry, clock=clock)
        recorders.append((rec, clock, registry, tag))
    plan = [(_record(rng, i), rng.random() < 0.08, rng.random() * 4) for i in range(150)]
    outcomes = []
    for rec, clock, registry, tag in recorders:
        out = []
        for fields, dump, dt in plan:
            clock.now += dt
            rec.record(**fields)
            if dump:
                path = rec.dump("slo_breach", context={"burn": 3.5})
                out.append(path is not None)
                if path is not None:
                    with open(path) as fh:
                        out.append(_strip(json.load(fh)))
        out.append(_strip(rec.snapshot(limit=64)["records"]))
        out.append(rec.snapshot()["summary"])
        out.append({k: v for k, v in rec.snapshot()["dumps"].items()
                    if k not in ("files", "dir")})
        out.append(rec.recent_summary(limit=16))
        out.append(len(rec))
        # dump files are named by the wall-clock second: two dumps in one
        # second share a name, so only the retention bound is comparable
        assert not (tmp_path / tag).exists() or len(os.listdir(tmp_path / tag)) <= 3
        out.append([l for l in registry.render_prometheus().splitlines()
                    if "flightrecorder" in l])
        outcomes.append(out)
    assert outcomes[1] == outcomes[0]


def test_empty_ring_never_dumps(tmp_path):
    for mod in (jf, tf):
        rec = mod.FlightRecorder(dump_dir=str(tmp_path / mod.__name__), clock=Clock())
        assert rec.dump("slo_breach") is None
        assert rec.recent_summary() == {"records": 0}
