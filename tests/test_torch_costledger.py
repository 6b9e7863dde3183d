"""The PyTorch package's cost ledger (flyimg_tpu_torch/runtime/
costledger.py) against the JAX package's (flyimg_tpu/runtime/
costledger.py; tests/test_costledger.py is the JAX side's own).

- the same ``record_compile`` / ``record_launch`` sequences through both
  ledgers give equal ``entries()``, ``aggregates()`` and ``snapshot()``,
  and evict the same least-recently-launched entries (one shared fake
  clock);
- ``normalize_cost_analysis`` and ``key_digest`` give the JAX answers;
- the port's batcher and its direct program account their launches: the
  first launch of a program key as its build (nulled FLOPs and bytes; no
  measured peak off a card), then every launch's seconds and images.
"""

import itertools

import numpy as np
import pytest
import torch

from flyimg_tpu.runtime import costledger as jcl
from flyimg_tpu_torch.ops.compose import run_plan
from flyimg_tpu_torch.runtime import costledger as cl
from flyimg_tpu_torch.runtime.batcher import BatchController
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan

torch.set_num_threads(1)


@pytest.fixture
def clock(monkeypatch):
    """A shared wall clock ticking one second a read (both modules read
    ``time.time``)."""
    ticks = itertools.count(1_000)
    monkeypatch.setattr(cl.time, "time", lambda: float(next(ticks)))


def _run(mod, ops, max_entries=256):
    ledger = mod.PlanCostLedger(max_entries=max_entries)
    for op, key, kw in ops:
        getattr(ledger, op)(key, **kw)
    return ledger


def _compare(ops, max_entries=256):
    ours, theirs = _run(cl, ops, max_entries), _run(jcl, ops, max_entries)
    assert ours.entries() == theirs.entries()
    assert ours.aggregates() == theirs.aggregates()
    assert ours.snapshot(limit=3) == theirs.snapshot(limit=3)
    for key in {k for _op, k, _kw in ops} | {"absent"}:
        assert ours.peak_memory(key) == theirs.peak_memory(key)
    return ours


COST = {"flops": 2.0e9, "bytes_accessed": 3.0e8}


@pytest.mark.parametrize("ops", [
    # a costed build, launches; an uncosted (nulled) build with a peak
    [("record_compile", ("k", 1), dict(descriptor={"batch": 1}, compile_s=0.5, cost=COST)),
     ("record_launch", ("k", 1), dict(device_s=0.01, images=1)),
     ("record_launch", ("k", 1), dict(device_s=0.02, images=3)),
     ("record_compile", ("k", 8), dict(compile_s=1.25, peak_memory_bytes=4.0e6)),
     ("record_launch", ("k", 8), dict(device_s=0.004, images=8))],
    # a launch with no build record, a launch with no seconds, a rebuild
    [("record_launch", "deadbeef00112233", dict(device_s=None, images=2)),
     ("record_launch", ("x",), dict(device_s=0.5, images=1)),
     ("record_compile", ("x",), dict(compile_s=None, cost=None, peak_memory_bytes=None)),
     ("record_compile", ("x",), dict(descriptor={"ops": ["resample"]}, compile_s=0.1,
                                      cost={"flops": 5.0})),
     ("record_launch", ("x",), dict(device_s=0.25, images=4))],
])
def test_sequences_match_jax(clock, ops):
    _compare(ops)


def test_lru_eviction_matches_jax(clock):
    """Past ``max_entries`` (at least 8) the least recently launched entry
    goes; never-launched entries by build time; totals survive."""
    ops = []
    for i in range(12):
        ops.append(("record_compile", ("p", i), dict(compile_s=0.1 * i, cost=COST)))
        if i % 3 == 0:
            ops.append(("record_launch", ("p", i), dict(device_s=0.01, images=1)))
    ops.append(("record_launch", ("p", 0), dict(device_s=0.01, images=1)))
    ours = _compare(ops, max_entries=8)
    assert len(ours.entries()) == 8 and ours.aggregates()["compiles"] == 12.0


def test_launch_at_capacity_does_not_evict_itself(clock):
    ops = [("record_compile", ("c", i), dict(compile_s=0.1)) for i in range(8)]
    ops.append(("record_launch", ("new",), dict(device_s=0.5, images=1)))
    ours = _compare(ops, max_entries=8)
    assert any(e["key"] == cl.key_digest(("new",)) for e in ours.entries())


@pytest.mark.parametrize("raw", [
    None, [], {}, [{"flops": 1.0}, {"flops": 2.0, "bytes accessed": 5.0}],
    {"flops": 3.0, "transcendentals": 1.0, "bytes accessed0{}": 9.0},
    ["junk", {"bytes accessed": 4.0}], {"other": 1.0},
])
def test_normalize_matches_jax(raw):
    assert cl.normalize_cost_analysis(raw) == jcl.normalize_cost_analysis(raw)


@pytest.mark.parametrize("key", [("a", 1, (2, 3), None), "s", (1.5, ("x", True))])
def test_key_digest_matches_jax(key):
    assert cl.key_digest(key) == jcl.key_digest(key)


def test_first_launch_is_claimed_once():
    key = ("first-launch-test", object.__name__)
    assert not cl.launched(key)
    assert cl.first_launch(key) and cl.launched(key)
    assert not cl.first_launch(key)


def test_batcher_and_direct_program_account_their_launches():
    ledger = cl.get_ledger()
    src = (37, 29)
    plan = build_plan(OptionsBag("w_13,h_11,c_1"), *src)
    imgs = [np.random.default_rng(i).integers(0, 256, (src[1], src[0], 3), dtype=np.uint8)
            for i in range(3)]
    ctl = BatchController(device="cpu", max_batch=4, deadline_ms=10_000.0, lone_flush=False)
    try:
        futures = [ctl.submit(img, plan) for img in imgs[:2]]
        ctl.close(drain_timeout_s=10.0)
        for fut in futures:
            fut.result(timeout=0)
    finally:
        ctl.close()
    assert list(ctl.launch_log) == [("transform", 2, 2)]
    batched = [r for r in ledger.entries()
               if r["descriptor"].get("batch") == 2 and r["descriptor"].get("device") == "cpu"
               and r["descriptor"].get("resample_out") == [11, 13]]
    assert len(batched) == 1
    row = batched[0]
    assert row["launches"] >= 1 and row["images"] >= 2 and row["device_s"] > 0
    assert row["compile_s"] is not None and row["flops"] is None and not row["costed"]
    assert row["peak_memory_bytes"] is None      # measured on a card only
    before = ledger.aggregates()["device_seconds"]
    run_plan(imgs[2], plan, device="cpu")
    assert ledger.aggregates()["device_seconds"] > before
