"""The port's warm start (flyimg_tpu_torch/runtime/warmstart.py, the
recorder hooks in ``build_program`` / ``build_batched_program``, the
server's wiring) held against the JAX package's
(flyimg_tpu/runtime/warmstart.py) on the CPU:

- for the same recorded build sequence, the port's programs manifest
  equals the JAX package's, entry for entry and digest for digest;
- twins of tests/test_fleet_membership.py's warm-start cases, each run in
  both packages with the same outcome: seeding makes the next build a hit
  (and the port's handle compiled, its first launch a hit), a tampered
  entry is a ``mismatch``, an unknown kind is skipped and an unknown plan
  field fails, publish merges by digest, the policy table is clamped to
  the local envelopes, and a policy digest mismatch discards the whole
  table;
- a server restarted on the same ``upload_dir`` seeds every entry of the
  first one's manifest before it serves, and its first flagship request
  of a new source is a program-cache hit; its policy table comes back.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.ops import compose as jcompose
from flyimg_tpu.runtime import autotuner as jat
from flyimg_tpu.runtime import batcher as jbatcher
from flyimg_tpu.runtime import warmstart as jws
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu.spec.plan import build_plan as jbuild_plan
from flyimg_tpu.storage.local import LocalStorage as JLocalStorage
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.ops import compose
from flyimg_tpu_torch.ops import resample
from flyimg_tpu_torch.runtime import autotuner as at
from flyimg_tpu_torch.runtime import costledger
from flyimg_tpu_torch.runtime import warmstart as ws
from flyimg_tpu_torch.runtime.batcher import build_batched_program, transform_group
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.spec.options import OptionsBag
from flyimg_tpu_torch.spec.plan import build_plan
from flyimg_tpu_torch.storage.local import LocalStorage

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset():
    compose.invalidate_program_caches()
    jcompose.invalidate_program_caches()
    yield
    ws.uninstall()
    jws.uninstall()
    resample.set_kernel_mode("dense")
    compose.invalidate_program_caches()
    jcompose.invalidate_program_caches()


def _stores(tmp_path, sub="shared"):
    return (LocalStorage(AppParameters({"upload_dir": str(tmp_path / "t" / sub)})),
            JLocalStorage(JAppParameters({"upload_dir": str(tmp_path / "j" / sub)})))


#: (options, source w, h, batch, kernel mode) of the recorded sequence
SEQUENCE = [
    ("w_16,h_12,c_1", 64, 48, 1, "dense"),
    ("w_16,h_12,c_1", 64, 48, 2, "dense"),
    ("w_16,h_12,c_1", 64, 48, 1, "banded"),
    ("w_20,r_30", 64, 48, 1, "dense"),
    ("w_40,ett_60x50,bg_%23ff0000", 64, 48, 4, "dense"),
    ("clsp_Gray,blr_1", 40, 30, 1, "dense"),
]


def _args(opts, w, h, mode):
    """The build arguments of one program: the port's group fields, and
    the same plan in each package."""
    resample.set_kernel_mode(mode)
    plan = build_plan(OptionsBag(opts), w, h)
    group, _t, _s = transform_group(plan, (h, w))
    jplan = jbuild_plan(JOptionsBag(opts), w, h).device_plan()
    return group, jplan


def _record(pkg_ws, build_single, build_batched, which):
    for opts, w, h, batch, mode in SEQUENCE:
        group, jplan = _args(opts, w, h, mode)
        plan = group.device_plan if which == "torch" else jplan
        if which == "torch":
            build_single(group.in_shape, group.resample_out, group.pad_canvas,
                           group.pad_offset, plan, group.band_taps, "cpu")
            build_batched(batch, group.in_shape, group.resample_out, group.pad_canvas,
                            group.pad_offset, plan, "cpu", group.rotate_dynamic,
                            group.band_taps)
        else:
            build_single(group.in_shape, group.resample_out, group.pad_canvas,
                           group.pad_offset, plan, group.band_taps)
            build_batched(batch, group.in_shape, group.resample_out, group.pad_canvas,
                            group.pad_offset, plan, None, group.rotate_dynamic,
                            group.band_taps)


def test_programs_manifest_equals_the_jax_manifest(tmp_path):
    store, jstore = _stores(tmp_path)
    ours = ws.WarmStartCache(store, enabled=True).install()
    try:
        _record(ours, compose.build_program, build_batched_program, "torch")
    finally:
        ws.uninstall()
    theirs = jws.WarmStartCache(jstore, enabled=True).install()
    try:
        _record(theirs, jcompose.build_program, jbatcher.build_batched_program, "jax")
    finally:
        jws.uninstall()
    # a repeat of every build records nothing more (the lru body runs once)
    ours.install()
    try:
        _record(ours, compose.build_program, build_batched_program, "torch")
    finally:
        ws.uninstall()
    # batch 1 and 2 of the first plan share one single-image program
    assert len(ours.recorder) == len(theirs.recorder) == 2 * len(SEQUENCE) - 1
    ours.publish()
    theirs.publish()
    a = json.loads(store.read(ws.PROGRAMS_MANIFEST))
    b = json.loads(jstore.read(jws.PROGRAMS_MANIFEST))
    assert a == b
    assert [e["digest"] for e in a["entries"]] == [e["digest"] for e in b["entries"]]
    assert any(e["band_taps"] for e in a["entries"])
    assert any(e.get("rotate_dynamic") for e in a["entries"])


def _flagship(pkg):
    if pkg == "torch":
        plan = build_plan(OptionsBag("w_16,h_12"), 64, 48)
        layout = compose.plan_layout(plan)
    else:
        plan = jbuild_plan(JOptionsBag("w_16,h_12"), 64, 48)
        layout = jcompose.plan_layout(plan)
    return plan.device_plan(), layout


def _single(pkg, in_shape, dp, layout):
    if pkg == "torch":
        return compose.build_program(in_shape, layout.resample_out, layout.pad_canvas,
                                     layout.pad_offset, dp, None, "cpu")
    return jcompose.build_program(in_shape, layout.resample_out, layout.pad_canvas,
                                  layout.pad_offset, dp, None)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_recorder_captures_and_seeding_warms_the_program_cache(tmp_path, pkg):
    mod, comp = (ws, compose) if pkg == "torch" else (jws, jcompose)
    store = _stores(tmp_path)[0 if pkg == "torch" else 1]
    dp, layout = _flagship(pkg)
    publisher = mod.WarmStartCache(store, enabled=True).install()
    try:
        _single(pkg, (48, 64), dp, layout)
        assert len(publisher.recorder) == 1
        publisher.publish()
    finally:
        mod.uninstall()
    assert len(json.loads(store.read(mod.PROGRAMS_MANIFEST))["entries"]) == 1
    comp.invalidate_program_caches()
    seeder = mod.WarmStartCache(store, enabled=True)
    stats = seeder.seed_programs("cpu") if pkg == "torch" else seeder.seed_programs()
    assert stats["seeded"] == 1 and stats["mismatch"] == 0
    assert comp.program_cache_info()["single"]["entries"] == 1
    hits = comp.build_program.cache_info().hits
    handle = _single(pkg, (48, 64), dp, layout)
    assert comp.build_program.cache_info().hits == hits + 1
    assert handle.is_compiled


def test_a_seeded_batched_program_launches_as_a_hit(tmp_path):
    """The port: a seeded batched entry is precompiled (its ledger build
    recorded), so the batcher's first launch of it is a compile hit."""
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.runtime.metrics import MetricsRegistry

    store = _stores(tmp_path)[0]
    group, _jplan = _args("w_16,h_12,c_1", 64, 48, "dense")
    publisher = ws.WarmStartCache(store, enabled=True)
    publisher.note_batched(1, group.in_shape, group.resample_out, group.pad_canvas,
                           group.pad_offset, group.device_plan, group.rotate_dynamic,
                           False, group.band_taps)
    publisher.publish()
    compiles = costledger.get_ledger().aggregates()["compiles"]
    assert ws.WarmStartCache(store, enabled=True).seed_programs("cpu")["seeded"] == 1
    assert costledger.get_ledger().aggregates()["compiles"] == compiles + 1
    metrics = MetricsRegistry()
    ctl = BatchController(max_batch=1, deadline_ms=60_000.0, lone_flush=False,
                          device="cpu", metrics=metrics)
    try:
        image = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
        ctl.submit(image, build_plan(OptionsBag("w_16,h_12,c_1"), 64, 48)).result(timeout=60)
    finally:
        ctl.close()
    assert metrics.summary().get('flyimg_compile_events_total{result="hit"}') == 1
    assert costledger.get_ledger().aggregates()["compiles"] == compiles + 1


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_corrupted_manifest_entry_recompiles_not_executes(tmp_path, pkg):
    mod, comp = (ws, compose) if pkg == "torch" else (jws, jcompose)
    store = _stores(tmp_path)[0 if pkg == "torch" else 1]
    dp, layout = _flagship(pkg)
    publisher = mod.WarmStartCache(store, enabled=True)
    publisher.note_single((48, 64), layout.resample_out, layout.pad_canvas,
                          layout.pad_offset, dp, None)
    publisher.publish()
    doc = json.loads(store.read(mod.PROGRAMS_MANIFEST))
    doc["entries"][0]["in_shape"] = [4096, 4096]      # tampered, stale digest
    store.write(mod.PROGRAMS_MANIFEST, json.dumps(doc).encode())
    comp.invalidate_program_caches()
    seeder = mod.WarmStartCache(store, enabled=True)
    stats = seeder.seed_programs("cpu") if pkg == "torch" else seeder.seed_programs()
    assert stats["mismatch"] == 1 and stats["seeded"] == 0
    assert comp.program_cache_info()["single"]["entries"] == 0


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_unknown_kind_and_unknown_plan_fields_are_skipped(tmp_path, pkg):
    mod, comp = (ws, compose) if pkg == "torch" else (jws, jcompose)
    store = _stores(tmp_path)[0 if pkg == "torch" else 1]
    alien = {"kind": "single", "in_shape": [8, 8], "resample_out": None,
             "pad_canvas": None, "pad_offset": [0, 0],
             "plan": {"not_a_field": 1}, "band_taps": None}
    alien["digest"] = mod._entry_digest(alien)
    store.write(mod.PROGRAMS_MANIFEST, json.dumps({
        "version": 1, "entries": [{"kind": "mystery", "digest": "x"}, alien]}).encode())
    comp.invalidate_program_caches()
    seeder = mod.WarmStartCache(store, enabled=True)
    stats = seeder.seed_programs("cpu") if pkg == "torch" else seeder.seed_programs()
    assert stats["skipped"] == 1 and stats["failed"] == 1 and stats["seeded"] == 0


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_publish_merges_by_digest_across_replicas(tmp_path, pkg):
    mod = ws if pkg == "torch" else jws
    store = _stores(tmp_path)[0 if pkg == "torch" else 1]
    dp, layout = _flagship(pkg)
    a = mod.WarmStartCache(store, enabled=True)
    a.note_single((48, 64), layout.resample_out, layout.pad_canvas, layout.pad_offset, dp,
                  None)
    a.publish()
    b = mod.WarmStartCache(store, enabled=True)
    for shape in ((96, 128), (48, 64)):
        b.note_single(shape, layout.resample_out, layout.pad_canvas, layout.pad_offset, dp,
                      None)
    b.publish()
    assert len(json.loads(store.read(mod.PROGRAMS_MANIFEST))["entries"]) == 2


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_policy_seeding_clamps_to_local_envelopes(tmp_path, pkg):
    mod, tmod = (ws, at) if pkg == "torch" else (jws, jat)
    store = _stores(tmp_path)[0 if pkg == "torch" else 1]
    tuner = tmod.PolicyAutotuner(enabled=True)
    current = {"value": 8.0}
    tuner.bind("device.max_batch", lambda: current["value"],
               lambda v: current.update(value=v))
    env = tuner.envelopes["device.max_batch"]
    doc = {"version": 1, "policy": {"device.max_batch": env.hi * 100.0,
                                    "codec.max_batch": 4.0}}
    doc["digest"] = mod._entry_digest(doc)
    store.write(mod.POLICY_MANIFEST, json.dumps(doc, sort_keys=True).encode())
    applied = mod.WarmStartCache(store, enabled=True).seed_policy(tuner)
    assert applied == {"device.max_batch": env.hi} == {"device.max_batch": 64.0}
    assert current["value"] == env.hi
    assert tuner.known_good()["device.max_batch"] == env.hi


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_policy_digest_mismatch_discards_whole_table(tmp_path, pkg):
    mod, tmod = (ws, at) if pkg == "torch" else (jws, jat)
    store = _stores(tmp_path)[0 if pkg == "torch" else 1]
    tuner = tmod.PolicyAutotuner(enabled=True)
    current = {"value": 8.0}
    tuner.bind("device.max_batch", lambda: current["value"],
               lambda v: current.update(value=v))
    store.write(mod.POLICY_MANIFEST, json.dumps({
        "version": 1, "policy": {"device.max_batch": 16.0},
        "digest": "torn-write"}).encode())
    assert mod.WarmStartCache(store, enabled=True).seed_policy(tuner) == {}
    assert current["value"] == 8.0 and tuner.known_good() == {}


def test_disabled_warm_start_is_inert(tmp_path):
    store = _stores(tmp_path)[0]
    cache = ws.WarmStartCache(store, enabled=False).install()
    assert ws._active is None
    group, _jplan = _args("w_16,h_12,c_1", 64, 48, "dense")
    compose.build_program(group.in_shape, group.resample_out, group.pad_canvas,
                          group.pad_offset, group.device_plan, group.band_taps, "cpu")
    assert len(cache.recorder) == 0
    cache.maybe_publish()
    assert cache.seed_programs("cpu") == {}
    assert not store.has(ws.PROGRAMS_MANIFEST)


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as resp:
        return resp.status, resp.read()


def test_a_restarted_server_serves_its_first_request_as_a_hit(tmp_path):
    """Server A records the flagship's programs and publishes at close (its
    policy table too); server B on the same upload_dir seeds every entry
    before it serves, and its first flagship request of a new source is a
    program-cache hit with no new build in the ledger."""
    rng = np.random.default_rng(11)
    srcs = []
    for i in range(2):
        srcs.append(tmp_path / f"src{i}.png")
        Image.fromarray(rng.integers(0, 255, (180, 240, 3), dtype=np.uint8)).save(srcs[-1])
    params = {"upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t"),
              "warmstart_enable": True, "autotune_enable": True, "debug": True,
              "resample_kernel": "banded"}
    opts = "w_30,h_25,c_1,smc_1,o_png"
    a = make_server(AppParameters(params), device="cpu")
    thread = serve_in_thread(a)
    try:
        base = f"http://127.0.0.1:{a.server_address[1]}"
        assert a.warmstart.seed_programs("cpu")["seeded"] == 0
        first_a = _get(f"{base}/upload/{opts}/{srcs[0]}")
        assert first_a[0] == 200
        # a known-good table to publish: the tuner's first evaluation
        a.autotuner.evaluate()
        assert a.autotuner.known_good()
    finally:
        a.shutdown()
        a.server_close()
        thread.join(timeout=10)
    store = LocalStorage(AppParameters({"upload_dir": str(tmp_path / "u")}))
    manifest = json.loads(store.read(ws.PROGRAMS_MANIFEST))
    assert [e["kind"] for e in manifest["entries"]] == ["batched"]
    assert manifest["entries"][0]["band_taps"]
    assert store.has(ws.POLICY_MANIFEST)
    # a new process: empty caches
    compose.invalidate_program_caches()
    compiles = costledger.get_ledger().aggregates()["compiles"]
    b = make_server(AppParameters(params), device="cpu")
    thread = serve_in_thread(b)
    try:
        stats = b.warmstart.snapshot()["stats"]
        assert stats["seeded"] == len(manifest["entries"])
        assert stats["mismatch"] == stats["failed"] == stats["skipped"] == 0
        assert stats["policy_applied"] >= 1
        assert costledger.get_ledger().aggregates()["compiles"] == compiles + 1
        base = f"http://127.0.0.1:{b.server_address[1]}"
        assert _get(f"{base}/upload/{opts}/{srcs[1]}")[0] == 200
        summary = b.metrics.summary()
        assert summary.get('flyimg_compile_events_total{result="hit"}') == 1
        assert 'flyimg_compile_events_total{result="miss"}' not in summary
        assert costledger.get_ledger().aggregates()["compiles"] == compiles + 1
        plans = json.loads(_get(f"{base}/debug/plans")[1])
        assert plans["program_cache"]["batched"]["hits"] == 1
        assert plans["program_cache"]["batched"]["misses"] == 1   # the seeding build
        text = _get(f"{base}/metrics")[1].decode()
        assert 'flyimg_warmstart_programs_total{outcome="seeded"} 1' in text
        assert "flyimg_program_cache_entries 1" in text
    finally:
        b.shutdown()
        b.server_close()
        thread.join(timeout=10)
