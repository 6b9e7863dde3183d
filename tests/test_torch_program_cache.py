"""The port's program caches (flyimg_tpu_torch/ops/compose.py
``ProgramHandle``, ``build_program``, ``program_cache_info``,
``invalidate_program_caches``; runtime/batcher.py ``build_batched_program``)
held against the JAX package's on the CPU:

- the same plan sequence through each package's ``BatchController`` and
  ``run_plan`` (a repeat, a second batch size, a dense and a banded
  variant) leaves the same entries, hits and misses in both caches, and
  ``invalidate_program_caches`` empties both in both packages;
- a handle is compiled once its first launch completed or once
  ``precompile`` ran it: a precompiled program's first launch is a cache
  hit with no second build record, and ``precompile`` runs every kind of
  program on a zero batch of its padded shape;
- the batcher's compile-hit signal (metrics, the flight record) is the
  handle's, and a failover empties both caches;
- the kernels a program's stages launch on the card, by name.
"""

import numpy as np
import pytest
import torch

from flyimg_tpu.ops import compose as jcompose
from flyimg_tpu.ops import resample as jresample
from flyimg_tpu.runtime.batcher import BatchController as JBatchController
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu_torch.ops import compose
from flyimg_tpu_torch.ops import resample
from flyimg_tpu_torch.runtime import costledger
from flyimg_tpu_torch.runtime.batcher import (
    BatchController,
    build_batched_program,
    transform_group,
)
from flyimg_tpu_torch.runtime.flightrecorder import FlightRecorder
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan, rotated_bounds

torch.set_num_threads(1)

SRC = (64, 48)
OPTS = "w_16,h_12,c_1"


@pytest.fixture(autouse=True)
def _reset():
    compose.invalidate_program_caches()
    jcompose.invalidate_program_caches()
    yield
    resample.set_kernel_mode("dense")
    jresample.set_kernel_mode("dense")
    compose.invalidate_program_caches()
    jcompose.invalidate_program_caches()


def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, (SRC[1], SRC[0], 3), dtype=np.uint8)


def _sequence(pkg):
    """The plan sequence, through one package's batcher and run_plan:
    batch 1 twice, batch 2, run_plan twice (dense), then a banded batch 1
    and a banded run_plan. Returns the outputs."""
    if pkg == "jax":
        plan = jbuild_plan(JOptionsBag(OPTS), *SRC)
        ctl = JBatchController(max_batch=1, deadline_ms=60_000.0, lone_flush=False)
        run, mode = jcompose.run_plan, jresample.set_kernel_mode
    else:
        plan = build_plan(OptionsBag(OPTS), *SRC)
        ctl = BatchController(max_batch=1, deadline_ms=60_000.0, lone_flush=False,
                              device="cpu")
        run = lambda image, p: compose.run_plan(image, p, device="cpu")  # noqa: E731
        mode = resample.set_kernel_mode
    outs = []
    try:
        mode("dense")
        for seed in (0, 1):
            outs.append(ctl.submit(_img(seed), plan).result(timeout=120))
        ctl.apply_policy(max_batch=2)
        pair = [ctl.submit(_img(seed), plan) for seed in (2, 3)]
        outs += [f.result(timeout=120) for f in pair]
        outs += [run(_img(4), plan), run(_img(5), plan)]
        mode("banded")
        ctl.apply_policy(max_batch=1)
        outs.append(ctl.submit(_img(6), plan).result(timeout=120))
        outs.append(run(_img(7), plan))
    finally:
        ctl.close()
    return outs


def test_cache_counts_equal_the_jax_cache():
    ours = _sequence("torch")
    info = compose.program_cache_info()
    theirs = _sequence("jax")
    jinfo = jcompose.program_cache_info()
    for kind in ("single", "batched"):
        assert info[kind] == jinfo[kind], kind
    # 3 batched programs (dense 1 and 2, banded 1) and 2 single ones
    assert info["batched"] == {"entries": 3, "hits": 1, "misses": 3, "maxsize": 256}
    assert info["single"] == {"entries": 2, "hits": 1, "misses": 2, "maxsize": 256}
    assert compose.program_cache_entries() == jcompose.program_cache_entries() == 5.0
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1
    compose.invalidate_program_caches()
    jcompose.invalidate_program_caches()
    for doc in (compose.program_cache_info(), jcompose.program_cache_info()):
        assert doc["single"]["entries"] == doc["batched"]["entries"] == 0


def _handle(opts="w_16,h_12,c_1", batch=2):
    plan = build_plan(OptionsBag(opts), *SRC)
    group, _true, _slice = transform_group(plan, (SRC[1], SRC[0]))
    return build_batched_program(batch, group.in_shape, group.resample_out,
                                 group.pad_canvas, group.pad_offset, group.device_plan,
                                 "cpu", group.rotate_dynamic, group.band_taps), plan


def test_precompiled_program_launches_as_a_hit():
    handle, plan = _handle()
    assert not handle.is_compiled
    ledger = costledger.get_ledger()

    def row():
        rows = [r for r in ledger.entries() if r["key"] == handle.ledger_key]
        return rows[0] if rows else {"launches": 0, "images": 0}

    launches, images = row()["launches"], row()["images"]
    compiles = ledger.aggregates()["compiles"]
    handle.precompile()
    assert handle.is_compiled and not handle.claim_build()
    assert row()["compile_s"] > 0 and row()["launches"] == launches
    assert ledger.aggregates()["compiles"] == compiles + 1
    compiles += 1
    metrics, recorder = MetricsRegistry(), FlightRecorder()
    ctl = BatchController(max_batch=2, deadline_ms=60_000.0, lone_flush=False,
                          device="cpu", metrics=metrics, flight_recorder=recorder)
    try:
        futures = [ctl.submit(_img(s), plan) for s in (0, 1)]
        for fut in futures:
            fut.result(timeout=120)
    finally:
        ctl.close()
    assert build_batched_program.cache_info().hits == 1
    summary = metrics.summary()
    assert summary.get('flyimg_compile_events_total{result="hit"}') == 1
    assert 'flyimg_compile_events_total{result="miss"}' not in summary
    records = [r for r in recorder.snapshot()["records"] if r["kind"] == "primary"]
    assert [r["compile_hit"] for r in records] == [True]
    assert records[0]["plan_key"] == handle.ledger_key
    assert ledger.aggregates()["compiles"] == compiles      # no second build
    assert row()["launches"] == launches + 1 and row()["images"] == images + 2


def test_a_cold_program_is_a_miss_then_a_hit():
    _handle_, plan = _handle(batch=1)
    metrics = MetricsRegistry()
    ctl = BatchController(max_batch=1, deadline_ms=60_000.0, lone_flush=False,
                          device="cpu", metrics=metrics)
    try:
        for seed in (0, 1):
            ctl.submit(_img(seed), plan).result(timeout=120)
    finally:
        ctl.close()
    summary = metrics.summary()
    assert summary['flyimg_compile_events_total{result="miss"}'] == 1
    assert summary['flyimg_compile_events_total{result="hit"}'] == 1
    assert _handle_.is_compiled


@pytest.mark.parametrize("opts", [
    "w_16,h_12,c_1", "w_40,ett_60x50,bg_%23ff0000", "w_20,r_30",
    "w_20,r_90,blr_1", "clsp_Gray,mnchr_1", "w_24,unsh_0.5x0.5+1+0.05", "r_-15",
])
def test_precompile_runs_every_kind_of_program(opts):
    """``precompile`` runs the program on zeros at its padded shape with the
    whole frame as geometry; its output is the program's own output on that
    input."""
    handle, plan = _handle(opts, batch=1)
    handle.precompile()
    assert handle.is_compiled
    b, h, w = handle.shape
    group, _t, _s = transform_group(plan, (SRC[1], SRC[0]))
    row = compose.frame_geometry((h, w), group.resample_out, plan.rotate,
                                 group.rotate_dynamic)
    assert list(row[:6]) == [h, w, 0.0, h, 0.0, w]
    out = handle(torch.zeros((b, h, w, 3), dtype=torch.uint8),
                 *compose.program_args(torch.from_numpy(row[None])))
    assert out.dtype == torch.uint8 and out.shape[0] == 1
    if group.rotate_dynamic:
        fh, fw = row[6:8]
        rw, rh = rotated_bounds(int(fw), int(fh), plan.rotate)
        assert tuple(row[8:10]) == (rh, rw)


def test_failover_empties_both_caches():
    plan = build_plan(OptionsBag(OPTS), *SRC)
    ctl = BatchController(max_batch=1, deadline_ms=60_000.0, lone_flush=False, device="cpu")
    try:
        ctl.submit(_img(0), plan).result(timeout=120)
        compose.run_plan(_img(1), plan, device="cpu")
        assert compose.program_cache_entries() == 2.0
        ctl.failover_backend("cpu", drain_timeout_s=1.0, reason="device_failover")
        info = compose.program_cache_info()
        assert info["single"]["entries"] == info["batched"]["entries"] == 0
        ctl.submit(_img(2), plan).result(timeout=120)
        assert compose.program_cache_info()["batched"]["entries"] == 1
    finally:
        ctl.close()


@pytest.mark.parametrize("opts,mode,kernels", [
    ("w_300,h_250,c_1", "banded", ("resample_banded",)),
    ("w_300,h_250,c_1", "dense", ()),
    ("w_300,h_250,c_1,clsp_Gray", "banded", ("resample_banded", "pixel_pass")),
    ("w_300,r_90", "dense", ("rotate",)),
    ("w_300,r_90,blr_1", "dense", ("separable",)),
    ("w_300,r_30", "dense", ("rotate",)),
    ("r_30", "dense", ("rotate",)),
    ("w_600,ett_800x800", "dense", ("pixel_pass",)),
])
def test_program_kernels(opts, mode, kernels):
    resample.set_kernel_mode(mode)
    plan = build_plan(OptionsBag(opts), 1920, 1080)
    group, _t, _s = transform_group(plan, (1080, 1920))
    assert compose.program_kernels(group.resample_out, group.pad_canvas, group.device_plan,
                                   group.rotate_dynamic, group.band_taps) == kernels
