"""Data-parallel serving batches of the PyTorch package (the ``data`` mesh),
against the JAX package's, on the CPU.

The counterparts of ``tests/test_batcher.py``'s mesh tests run the port's
``BatchController(mesh=...)`` on virtual CPU meshes (n ranks, one device:
``parallel/mesh.py virtual_mesh``), where the JAX tests run on the
conftest's 8 virtual CPU devices. Also: the padded batch against the JAX
controller's, the memory governor's prediction, program identities, warm
start, the device supervisor's failover and re-promotion, the shard
helpers, and the two controllers' ``stats()`` (ROADMAP C25).

The transform tests run K1's form (``resample_kernel`` banded, the form
the card serves in ``chip_smoke.py`` phase 21), whose arithmetic for a
member does not depend on the launch's batch. The dense form's batched
``torch.matmul`` does on the CPU: one value of a 1024x768 source's
``w_300,h_250,c_1`` answer rounds one level apart at a batch of 2 and of 1
(ROADMAP C26), so a sharded chunk's smaller batch could move it.

Bounds, each stated where it is checked:
- a sharded launch against the unsharded controller: equal bytes (each
  member's program is the same arithmetic on the same values);
- the port's sharded answers against the JAX sharded batcher's: within 1
  u8 level (the port's program against XLA's: sums in other orders);
- ``_padded_batch``: equal to the JAX controller's for every n in 1..64 on
  1 to 8 ranks.
"""

import logging
import types

import jax
import numpy as np
import pytest
import torch

from flyimg_tpu.parallel.mesh import make_mesh as jmake_mesh
from flyimg_tpu.runtime import batcher as jbatcher
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.ops import compose, resample
from flyimg_tpu_torch.parallel.mesh import (
    gather_shards,
    leading_shards,
    make_mesh,
    replicate,
    shard_leading,
    shard_size,
    virtual_mesh,
)
from flyimg_tpu_torch.runtime import costledger
from flyimg_tpu_torch.runtime import devicesupervisor as sup_mod
from flyimg_tpu_torch.runtime import warmstart as ws
from flyimg_tpu_torch.runtime.batcher import (
    BatchController,
    ShardedProgramHandle,
    build_batched_program,
    transform_group,
)
from flyimg_tpu_torch.runtime.memgovernor import MemoryGovernor
from flyimg_tpu_torch.runtime.metrics import MetricsRegistry
from flyimg_tpu_torch.runtime.resilience import TRANSIENT
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
from flyimg_tpu_torch.storage.local import LocalStorage

torch.set_num_threads(2)

#: the port's sharded answers against the JAX sharded batcher's, u8 levels
JAX_TOL = 1


def data_mesh(n):
    return virtual_mesh(n, "cpu", ("data",))


@pytest.fixture(autouse=True)
def _banded_fresh_caches():
    mode = resample.kernel_mode()
    resample.set_kernel_mode("banded")
    compose.invalidate_program_caches()
    yield
    ws.uninstall()
    resample.set_kernel_mode(mode)
    compose.invalidate_program_caches()


def _images(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


def _serve(ctl, imgs, opts):
    h, w = imgs[0].shape[:2]
    futures = [ctl.submit(im, build_plan(OptionsBag(opts), w, h)) for im in imgs]
    return [f.result(timeout=60) for f in futures]


def test_mesh_sharded_batch_matches_unsharded():
    """An 8-rank data mesh batcher returns the unsharded controller's bytes,
    and pixels within JAX_TOL of the JAX sharded batcher's."""
    imgs = _images(5, 8, 96, 128)
    plain = BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False, device="cpu")
    sharded = BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False,
                              device="cpu", mesh=data_mesh(8))
    jsharded = jbatcher.BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False,
                                        mesh=jmake_mesh())
    try:
        want = _serve(plain, imgs, "w_64,h_48,c_1")
        got = _serve(sharded, imgs, "w_64,h_48,c_1")
        plans = [jbuild_plan(JOptionsBag("w_64,h_48,c_1"), 128, 96) for _ in imgs]
        theirs = [f.result(timeout=120) for f in
                  [jsharded.submit(im, pl) for im, pl in zip(imgs, plans)]]
    finally:
        for ctl in (plain, sharded, jsharded):
            ctl.close()
    assert [n for k, n, _b in sharded.launch_log if k == "transform"] == [8]
    for w, g, t in zip(want, got, theirs):
        np.testing.assert_array_equal(w, g)
        assert np.abs(g.astype(int) - np.asarray(t).astype(int)).max() <= JAX_TOL


@pytest.mark.parametrize("ranks,opts", [(2, "w_300,h_250,c_1"), (3, "w_300,h_250,c_1"),
                                        (4, "w_160,r_30"), (3, "w_200,blr_0x2")])
def test_sharded_stages_equal_unsharded(ranks, opts):
    """Rotates, filters and an odd rank count: five members padded to the
    mesh's multiple, each answer equal to the unsharded controller's."""
    imgs = _images(ranks, 5, 200, 240)
    plain = BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False, device="cpu")
    sharded = BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False,
                              device="cpu", mesh=data_mesh(ranks))
    try:
        want = _serve(plain, imgs, opts)
        got = _serve(sharded, imgs, opts)
    finally:
        plain.close()
        sharded.close()
    assert [b for k, _n, b in sharded.launch_log if k == "transform"] == [
        sharded._padded_batch(5)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_mesh_single_item_pads_to_device_count():
    ctl = BatchController(max_batch=8, deadline_ms=2.0, device="cpu", mesh=data_mesh(8))
    try:
        img = _images(6, 1, 64, 64)[0]
        out = ctl.submit(img, build_plan(OptionsBag("w_32,h_32,rz_1"), 64, 64)).result(
            timeout=60)
        assert out.shape == (32, 32, 3)
        stats = ctl.stats()
        # 1 real image in an 8-slot (device-count) batch
        assert stats["images"] == 1
        assert stats["mean_occupancy"] == pytest.approx(1 / 8)
    finally:
        ctl.close()


def test_mesh_without_data_axis_rejected():
    with pytest.raises(ValueError, match="data"):
        BatchController(device="cpu", mesh=virtual_mesh(4, "cpu", ("sp",)))
    ctl = BatchController(device="cpu", mesh=data_mesh(2))
    try:
        thread = ctl._thread
        with pytest.raises(ValueError, match="data"):
            ctl.failover_backend("cpu", mesh=virtual_mesh(2, "cpu", ("sp",)))
        # nothing changed: the mesh, the executor
        assert ctl.mesh == data_mesh(2) and ctl._thread is thread
    finally:
        ctl.close()


def test_mesh_on_another_kind_of_device_rejected():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    meshless = make_mesh((2,), ("data",), ["cpu", "cpu"])
    assert BatchController(device="cpu", mesh=meshless).mesh == meshless
    cuda_mesh = types.SimpleNamespace(
        axis_names=("data",), shape={"data": 1},
        axis_devices=lambda axis: (torch.device("cuda", 0),))
    with pytest.raises(ValueError, match="cuda"):
        BatchController(device="cpu", mesh=cuda_mesh)


def test_mesh_nonpow2_device_count_rounds_batch():
    """A 6-rank data axis gets divisible batches (5 -> 12)."""
    ctl = BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False, device="cpu",
                          mesh=data_mesh(6))
    try:
        outs = _serve(ctl, _images(7, 5, 64, 64), "w_32,h_32,rz_1")
        assert all(o.shape == (32, 32, 3) for o in outs)
        assert [(n, b) for k, n, b in ctl.launch_log if k == "transform"] == [(5, 12)]
    finally:
        ctl.close()


def test_padded_batch_equals_jax():
    """The ladder rounded up to the data axis, for n in 1..64 on 1 to 8
    ranks, against the JAX controller's method (it reads only the rank
    count)."""
    for ranks in range(1, 9):
        ours = types.SimpleNamespace(_n_devices=ranks)
        theirs = types.SimpleNamespace(_n_devices=ranks)
        for n in range(1, 65):
            assert BatchController._padded_batch(ours, n) == \
                jbatcher.BatchController._padded_batch(theirs, n), (ranks, n)


def test_governor_predicts_the_padded_batch():
    """The memory governor's admission sizes a launch by ``_padded_batch``:
    on 6 ranks with a budget of 8 members' bytes, a take of 8 members pads
    to 12 and does not fit, so it caps at 4 (padded to 6), where the bare
    ladder's 8 would have fitted and launched 12 slots."""
    per_member = 1_000_000
    governor = MemoryGovernor(enabled=True, device_budget_bytes=8 * per_member)
    governor.predict_bytes = lambda family, batch, in_shape: batch * per_member
    ctl = BatchController(max_batch=8, deadline_ms=300.0, lone_flush=False, device="cpu",
                          mesh=data_mesh(6), governor=governor)
    seen = []
    member_cap = governor.member_cap

    def spy(family, in_shape, requested, pad_fn):
        seen.append([pad_fn(n) for n in range(1, 9)])
        return member_cap(family, in_shape, requested, pad_fn)

    governor.member_cap = spy
    try:
        _serve(ctl, _images(8, 8, 64, 64), "w_32,h_32,rz_1")
    finally:
        ctl.close()
    assert seen[0] == [6, 6, 6, 6, 12, 12, 12, 12]
    transforms = [(n, b) for k, n, b in ctl.launch_log if k == "transform"]
    assert transforms == [(4, 6), (4, 6)]


def test_sharded_and_unsharded_handles_never_collide():
    plan = build_plan(OptionsBag("w_32,h_24,c_1"), 64, 48)
    group, _t, _s = transform_group(plan, (48, 64))
    args = (8, group.in_shape, group.resample_out, group.pad_canvas, group.pad_offset,
            group.device_plan, "cpu", group.rotate_dynamic, group.band_taps)
    plain = build_batched_program(*args)
    two = build_batched_program(*args, data_mesh(2))
    four = build_batched_program(*args, data_mesh(4))
    two_again = build_batched_program(*args[:7], rotate_dynamic=group.rotate_dynamic,
                                      band_taps=group.band_taps, mesh=data_mesh(2))
    assert plain is build_batched_program(*args, None)
    assert two is two_again
    assert isinstance(two, ShardedProgramHandle) and not isinstance(plain, ShardedProgramHandle)
    keys = {h.ledger_key for h in (plain, two, four)}
    assert len(keys) == 3
    # an equal mesh made anew is the same program
    other = make_mesh((2,), ("data",), ["cpu", "cpu"])
    assert build_batched_program(*args, other) is two
    assert two.descriptor["mesh"] == {"data": 2, "devices": ["cpu", "cpu"]}
    assert [p for _d, p in two.ranks][0].shape == (4, *group.in_shape)
    with pytest.raises(ValueError, match="shard"):
        build_batched_program(6, *args[1:], data_mesh(4))
    # launches land on separate ledger rows
    ledger = costledger.get_ledger()
    imgs = _images(9, 8, 48, 64)
    for mesh in (None, data_mesh(2)):
        ctl = BatchController(max_batch=8, deadline_ms=5.0, lone_flush=False,
                              device="cpu", mesh=mesh)
        try:
            _serve(ctl, imgs, "w_32,h_24,c_1")
        finally:
            ctl.close()
    rows = {r["key"]: r for r in ledger.entries()}
    assert plain.ledger_key in rows and two.ledger_key in rows


def test_warm_start_records_sharded_and_seeds_against_a_mesh(tmp_path):
    store = LocalStorage(AppParameters({"upload_dir": str(tmp_path / "shared")}))
    publisher = ws.WarmStartCache(store, enabled=True).install()
    try:
        for mesh in (None, data_mesh(2)):
            ctl = BatchController(max_batch=2, deadline_ms=5.0, lone_flush=False,
                                  device="cpu", mesh=mesh)
            try:
                _serve(ctl, _images(10, 2, 48, 64), "w_32,h_24,c_1")
            finally:
                ctl.close()
        entries = publisher.recorder.drain()
        assert sorted(e["sharded"] for e in entries) == [False, True]
        publisher.publish()
    finally:
        ws.uninstall()
    compose.invalidate_program_caches()
    seeder = ws.WarmStartCache(store, enabled=True)
    assert seeder.seed_programs("cpu", data_mesh(2))["seeded"] == 2
    info = compose.program_cache_info()["batched"]
    assert info["entries"] == 2
    plan = build_plan(OptionsBag("w_32,h_24,c_1"), 64, 48)
    group, _t, _s = transform_group(plan, (48, 64))
    handle = build_batched_program(2, group.in_shape, group.resample_out, group.pad_canvas,
                                   group.pad_offset, group.device_plan, "cpu",
                                   group.rotate_dynamic, group.band_taps, data_mesh(2))
    assert isinstance(handle, ShardedProgramHandle) and handle.is_compiled
    assert compose.program_cache_info()["batched"]["entries"] == 2
    # without a mesh a sharded entry seeds unsharded
    compose.invalidate_program_caches()
    assert ws.WarmStartCache(store, enabled=True).seed_programs("cpu")["seeded"] == 2
    assert compose.program_cache_info()["batched"]["entries"] == 1


def _supervised(mesh, factory):
    ctl = BatchController(max_batch=4, deadline_ms=2.0, device="cpu", mesh=mesh)
    sup = sup_mod.DeviceSupervisor(enabled=True, storm_threshold=1, probe_hysteresis=1,
                                   failover_drain_s=1.0, metrics=MetricsRegistry())
    sup._spawn = lambda target, name="t": target()
    sup._ensure_prober = lambda: None
    sup.attach(batchers=(ctl,), mesh_factory=factory)
    return ctl, sup


def test_failover_drops_the_mesh_and_repromotion_rebuilds_it():
    ctl, sup = _supervised(data_mesh(3), lambda: data_mesh(3))
    imgs = _images(11, 3, 48, 64)
    try:
        clean = _serve(ctl, imgs, "w_32,h_24,c_1")
        sup.record_batch_failure(TRANSIENT)
        assert sup.state() == sup_mod.CPU_FALLBACK
        assert ctl.mesh is None and ctl._padded_batch(3) == 4
        assert all(np.array_equal(a, b) for a, b in
                   zip(_serve(ctl, imgs, "w_32,h_24,c_1"), clean))
        assert sup.probe_and_handle()
        assert sup.state() == sup_mod.DEVICE
        assert ctl.mesh == data_mesh(3)
        assert all(np.array_equal(a, b) for a, b in
                   zip(_serve(ctl, imgs, "w_32,h_24,c_1"), clean))
        assert ctl.launch_log[-1][2] == 6
    finally:
        ctl.close()


def test_repromotion_serves_unsharded_when_the_factory_raises(caplog):
    def broken():
        raise RuntimeError("no cards listed")

    ctl, sup = _supervised(data_mesh(2), broken)
    try:
        sup.record_batch_failure(TRANSIENT)
        with caplog.at_level(logging.WARNING, logger=sup_mod.SUPERVISOR_LOGGER):
            assert sup.probe_and_handle()
        assert sup.state() == sup_mod.DEVICE and ctl.mesh is None
        assert any("serving unsharded" in r.getMessage() for r in caplog.records)
        out = _serve(ctl, _images(12, 1, 48, 64), "w_32,h_24,c_1")
        assert out[0].shape == (24, 32, 3)
    finally:
        ctl.close()


def test_shard_helpers_match_jax_shard_shapes():
    """``tests/test_parallel.py``'s placement: a [16, 8, 8, 3] batch over 8
    data ranks is 8 shards of [2, 8, 8, 3]; a replicated [4] is [4] on
    every device; the shards gather back to the batch."""
    mesh = data_mesh(8)
    batch = torch.arange(16 * 8 * 8 * 3, dtype=torch.float32).reshape(16, 8, 8, 3)
    shards = shard_leading(batch, mesh)
    assert {tuple(s.shape) for s in shards} == {(2, 8, 8, 3)} and len(shards) == 8
    jmesh = jmake_mesh()
    from flyimg_tpu.parallel.mesh import batch_sharding, replicated

    jsharded = jax.device_put(np.zeros((16, 8, 8, 3), np.float32), batch_sharding(jmesh))
    assert {tuple(s.shape) for s in shards} == {s.data.shape for s in
                                                jsharded.addressable_shards}
    repl = replicate(torch.zeros(4), mesh)
    jrepl = jax.device_put(np.zeros((4,), np.float32), replicated(jmesh))
    assert [tuple(r.shape) for r in repl] == [s.data.shape for s in jrepl.addressable_shards]
    assert torch.equal(gather_shards(shards), batch)
    two_d = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    assert [tuple(s.shape) for s in shard_leading(batch, two_d, "model")] == [(8, 8, 8, 3)] * 2
    assert len(replicate(torch.zeros(4), two_d)) == 8
    with pytest.raises(ValueError, match="shard"):
        shard_leading(torch.zeros(10, 3), mesh)


@pytest.mark.parametrize("ranks", [1, 3, 6])
def test_leading_shards_cut_in_rank_order(ranks):
    """The cut every sharded caller shares (the batcher's launch and
    programs, the DP x TP step): ``ranks`` equal views in rank order that
    join back to the tensor; ``shard_size`` refuses a size the ranks do not
    divide; ``replicate`` over one axis puts a copy on each of its ranks."""
    x = torch.arange(12 * 5, dtype=torch.int32).reshape(12, 5)
    cuts = leading_shards(x, ranks)
    assert len(cuts) == ranks and shard_size(12, ranks) == 12 // ranks
    assert all(c.data_ptr() == x[r * (12 // ranks)].data_ptr() for r, c in enumerate(cuts))
    assert torch.equal(gather_shards(cuts), x)
    with pytest.raises(ValueError, match="does not shard over"):
        shard_size(12 + 1, ranks) if ranks > 1 else shard_size(12, 5)
    two_d = make_mesh((ranks, 2), ("data", "model"), ["cpu"] * (2 * ranks))
    assert len(replicate(x, two_d, "data")) == ranks
    assert len(replicate(x, two_d, "model")) == 2


@pytest.mark.parametrize("mesh_ranks", [0, 8])
def test_stats_keys_and_counts_equal_jax(mesh_ranks):
    """ROADMAP C25: ``stats()`` is a method with the JAX keys, and on the
    same eight submissions (one launch of 8) ``images`` and ``batches``
    agree."""
    imgs = _images(13, 8, 96, 128)
    mesh = data_mesh(mesh_ranks) if mesh_ranks else None
    ours = BatchController(max_batch=8, deadline_ms=5_000.0, lone_flush=False,
                           device="cpu", mesh=mesh)
    theirs = jbatcher.BatchController(max_batch=8, deadline_ms=5_000.0, lone_flush=False,
                                      mesh=jmake_mesh() if mesh_ranks else None)
    try:
        _serve(ours, imgs, "w_64,h_48,c_1")
        plans = [jbuild_plan(JOptionsBag("w_64,h_48,c_1"), 128, 96) for _ in imgs]
        [f.result(timeout=120) for f in [theirs.submit(im, pl) for im, pl in zip(imgs, plans)]]
        a, b = ours.stats(), theirs.stats()
    finally:
        ours.close()
        theirs.close()
    assert set(a) == set(b)
    assert a["images"] == b["images"] == 8 and a["batches"] == b["batches"] == 1
    assert a["mean_occupancy"] == b["mean_occupancy"] == 1.0
    assert a["cumulative_occupancy"] == b["cumulative_occupancy"] == 1.0
    assert ours.containment_counts == {"retries": 0, "poison_isolated": 0,
                                       "quarantine_hits": 0}
