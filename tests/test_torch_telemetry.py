"""The PyTorch package's telemetry warehouse (flyimg_tpu_torch/runtime/
telemetry.py: ``TelemetryArchive``, ``TrafficMixClassifier``,
``TelemetryPipeline``, ``SignalWindow``) held against the JAX package's
(flyimg_tpu/runtime/telemetry.py, ``SignalWindow`` of
flyimg_tpu/runtime/observatory.py) on the CPU:

- the record vocabulary (``RECORD_SCHEMAS``), the centroids, weights and
  labels are the JAX package's;
- ``request_features`` and the classifier give the same features, raw and
  adopted labels, beat by beat, for one seeded feature stream;
- the archive, driven by the same operations on the same injected clock in
  two directories, holds the same records and inventory: validation,
  rotation by size and by age, retention, reopening, and the recovery of a
  torn last line (unterminated, and terminated garbage);
- the pipeline writes the same boot, window and launch records from the
  same flight records (the launch records carry the flight recorder's
  batch ids), beats at most every interval, counts the beat's outcomes,
  and puts the flight recorder's dumps under its retention;
- the server with ``telemetry_enable``: ``/debug/telemetry`` answers, a wave
  leaves window and launch records whose batch ids are the flight
  recorder's, and a fresh archive on the directory recovers a cut line.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flyimg_tpu.runtime import telemetry as jtelemetry
from flyimg_tpu.runtime.flightrecorder import FlightRecorder as JFlightRecorder
from flyimg_tpu.spec.options import OptionsBag as JOptionsBag
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.runtime import telemetry
from flyimg_tpu_torch.runtime.flightrecorder import FlightRecorder
from flyimg_tpu_torch.service.app import make_server, serve_in_thread
from flyimg_tpu_torch.spec.options import OptionsBag

torch.set_num_threads(1)


class Clock:
    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now


def test_vocabulary_is_the_jax_package_s():
    assert telemetry.RECORD_SCHEMAS == jtelemetry.RECORD_SCHEMAS
    assert telemetry.SCHEMA_VERSION == jtelemetry.SCHEMA_VERSION
    assert telemetry.MIX_LABELS == jtelemetry.MIX_LABELS
    assert telemetry.MIX_FEATURES == jtelemetry.MIX_FEATURES
    assert telemetry.MIX_WEIGHTS == jtelemetry.MIX_WEIGHTS
    assert telemetry.MIX_CENTROIDS == jtelemetry.MIX_CENTROIDS
    assert telemetry.MIX_RADIUS == jtelemetry.MIX_RADIUS


FEATURE_OPTIONS = ["", "w_300", "w_300,h_250,c_1", "h_2000", "w_520,h_0",
                   "e_1,p1x_10,p1y_20,p2x_300,p2y_400,w_64", "w_abc", "w_9999999",
                   "c_1,w_16,h_16,smc_1"]


@pytest.mark.parametrize("opts", FEATURE_OPTIONS)
@pytest.mark.parametrize("source", [None, "original-abc"])
def test_request_features_match_jax(opts, source):
    assert telemetry.request_features(OptionsBag(opts), source) == \
        jtelemetry.request_features(JOptionsBag(opts), source)
    plain = {"width": "300", "crop": opts.startswith("c_1")}
    assert telemetry.request_features(plain, source) == \
        jtelemetry.request_features(plain, source)


def _stream(seed, n):
    """A seeded stream of (features, outcome) that drifts between shapes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phase = (i // 40) % 4
        family = "crop" if (phase in (1, 3) and rng.random() < 0.9) else "resize"
        bucket = int(rng.integers(5, 9) if phase == 0 else rng.integers(6, 13))
        source = f"s{int(rng.integers(0, 3 if phase >= 2 else 30))}"
        sig = f"{family}:{bucket}:{int(rng.integers(0, 8)) if phase == 3 else ''}"
        outcome = str(rng.choice(["hit", "miss", "reuse", "stale", "coalesced",
                                  "degraded", "shed"]))
        out.append(({"family": family, "bucket": bucket, "sig": sig, "source": source},
                    outcome))
    return out


@pytest.mark.parametrize("seed,hysteresis,window", [(0, 2, 64), (1, 1, 32), (2, 3, 128),
                                                    (3, 2, 8)])
def test_classifier_labels_match_jax(seed, hysteresis, window):
    ours = telemetry.TrafficMixClassifier(window=window, min_samples=8, hysteresis=hysteresis)
    theirs = jtelemetry.TrafficMixClassifier(window=window, min_samples=8,
                                             hysteresis=hysteresis)
    labels = set()
    for k, (features, outcome) in enumerate(_stream(seed, 320)):
        ours.record(features, outcome)
        theirs.record(features, outcome)
        if k % 10 == 9:
            a, b = ours.classify(), theirs.classify()
            assert a == b, k
            labels.add(a["raw"])
    assert ours.snapshot() == theirs.snapshot()
    for label, centroid in telemetry.MIX_CENTROIDS.items():
        features = dict(zip(telemetry.MIX_FEATURES, centroid))
        assert telemetry.TrafficMixClassifier.nearest(features) == \
            jtelemetry.TrafficMixClassifier.nearest(features) == (label, 0.0)
    assert len(labels) > 1


# ---------------------------------------------------------------------------
# the archive


def _archives(tmp_path, clock, **kw):
    return (telemetry.TelemetryArchive(str(tmp_path / "t"), clock=clock, **kw),
            jtelemetry.TelemetryArchive(str(tmp_path / "j"), clock=clock, **kw))


def _same(ours, theirs):
    a, b = ours.inventory(), theirs.inventory()
    for doc in (a, b):
        doc.pop("dir")
    assert a == b
    ra = telemetry.read_archive(ours.directory)
    rb = jtelemetry.read_archive(theirs.directory)
    assert ra == rb


ARCHIVE_SCRIPTS = {
    "validate": [("append", "launch", {"batch_id": 1, "bogus": 2}), ("append", "nope", {}),
                 ("append", "window", {"mix": "thumbnail", "window_s": 1.0})],
    "rotate_size": [("fill", 900)] * 12,
    "rotate_age": [("fill", 100), ("tick", 11.0), ("fill", 100), ("tick", 3.0),
                   ("fill", 100), ("tick", 8.0), ("fill", 100)],
    "retention": [("fill", 3000)] * 40,
    "reopen": [("fill", 500), ("reopen",), ("fill", 500), ("fill", 500), ("reopen",)],
    "torn_unterminated": [("fill", 200), ("tear", b'{"schema":1,"kind":"launch","bat'),
                          ("reopen",), ("fill", 200)],
    "torn_garbage": [("fill", 200), ("tear", b"garbage{\n"), ("reopen",), ("fill", 200)],
}


@pytest.mark.parametrize("script", sorted(ARCHIVE_SCRIPTS))
def test_archive_matches_jax(tmp_path, script):
    clock = Clock()
    kw = dict(segment_max_bytes=4096, segment_max_age_s=10.0,
              retention_max_bytes=16384, retention_max_segments=3)
    pair = list(_archives(tmp_path, clock, **kw))
    for step in ARCHIVE_SCRIPTS[script]:
        op = step[0]
        for i, archive in enumerate(pair):
            if op == "append":
                archive.append(step[1], dict(step[2]))
            elif op == "fill":
                archive.append("launch", {"plan_key": "x" * step[1], "batch_id": 7})
            elif op == "tick":
                pass
            elif op == "tear":
                archive.close()
                path = os.path.join(archive.directory, archive.inventory()["active_segment"])
                with open(path, "ab") as fh:
                    fh.write(step[1])
            elif op == "reopen":
                archive.close()
                cls = (telemetry if i == 0 else jtelemetry).TelemetryArchive
                pair[i] = cls(archive.directory, clock=clock, **kw)
        if op == "tick":
            clock.now += step[1]
        _same(*pair)
    if script.startswith("torn"):
        assert pair[0].torn_recovered == 1


# ---------------------------------------------------------------------------
# the pipeline


def _records(recorder, n, start=1):
    for i in range(n):
        recorder.record(controller="device" if i % 3 else "codec", batch_id=start + i,
                        plan_key=f"k{i % 2}", occupancy=i % 4 + 1, capacity=4,
                        queue_wait_s=0.001 * i, h2d_s=0.0002, dispatch_s=0.0003,
                        sync_s=0.001, device_s=0.002, compile_hit=bool(i % 2),
                        kind="primary" if i % 5 else "aux", trace_id=None, error=None)


def test_pipeline_records_match_jax(tmp_path):
    clock = Clock()
    pipes = []
    for mod, recorder_cls, sub in ((telemetry, FlightRecorder, "t"),
                                   (jtelemetry, JFlightRecorder, "j")):
        archive = mod.TelemetryArchive(str(tmp_path / sub), clock=clock)
        pipe = mod.TelemetryPipeline(
            enabled=True, directory=str(tmp_path / sub), interval_s=10.0, archive=archive,
            classifier=mod.TrafficMixClassifier(window=32, min_samples=4, hysteresis=1),
            clock=clock)
        recorder = recorder_cls(size=64, dump_dir=str(tmp_path / sub / "dumps"))
        pipe.attach(flight_recorder=recorder)
        pipes.append((pipe, recorder))
    beats = []
    for step in range(6):
        for pipe, recorder in pipes:
            _records(recorder, 3 + step, start=100 * step)
            for features, outcome in _stream(step, 5):
                pipe.classifier.record(features, outcome)
                with pipe._lock:
                    pipe._beat_outcomes[outcome] = pipe._beat_outcomes.get(outcome, 0) + 1
        beats.append([pipe.evaluate() for pipe, _r in pipes])
        clock.now += 4.0
    assert [b[0] for b in beats] == [b[1] for b in beats] == [True, False, False, True,
                                                             False, False]
    ra, rb = (telemetry.read_archive(str(tmp_path / "t")),
              jtelemetry.read_archive(str(tmp_path / "j")))
    strip = ("kernel_mode",)
    for a, b in zip(ra["records"], rb["records"]):
        assert {k: v for k, v in a.items() if k not in strip} == \
            {k: v for k, v in b.items() if k not in strip}
    assert len(ra["records"]) == len(rb["records"])
    kinds = {r["kind"] for r in ra["records"]}
    assert kinds == {"boot", "window", "launch"}
    for rec in ra["records"]:
        assert set(rec) <= set(telemetry.RECORD_SCHEMAS[rec["kind"]])
    launched = [r["batch_id"] for r in ra["records"] if r["kind"] == "launch"]
    assert launched == sorted(launched) and len(launched) == len(set(launched))


def test_pipeline_off_is_inert(tmp_path):
    pipe = telemetry.TelemetryPipeline.from_params(AppParameters({"tmp_dir": str(tmp_path)}))
    assert not pipe.enabled and pipe.evaluate() is False
    pipe.record_request(options=OptionsBag("w_10"), source_key="x", outcome="hit")
    assert pipe.snapshot() == {"enabled": False}
    assert not os.path.exists(tmp_path / "telemetry")


def test_adopt_dump_retention_as_jax(tmp_path):
    kept = []
    for mod, recorder_cls, sub in ((telemetry, FlightRecorder, "t"),
                                   (jtelemetry, JFlightRecorder, "j")):
        recorder = recorder_cls(size=16, dump_dir=str(tmp_path / sub), max_dumps=16,
                                min_dump_interval_s=0.0)
        _records(recorder, 4)
        for i in range(6):
            recorder.dump(f"case{i}", context={"i": i})
        pipe = mod.TelemetryPipeline(enabled=True, archive=mod.TelemetryArchive(
            str(tmp_path / sub / "archive")),
            classifier=mod.TrafficMixClassifier())
        pipe.adopt_dump_retention(recorder, 3)
        kept.append((recorder.max_dumps, len(recorder.dump_files()),
                     set(pipe.snapshot()) - {"archive"}))
    assert kept[0] == kept[1]
    assert kept[0][:2] == (3, 3)


# ---------------------------------------------------------------------------
# the server


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as resp:
        return resp.status, resp.read()


def test_server_archives_windows_and_launches(tmp_path):
    src = tmp_path / "src.png"
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)).save(src)
    clock = Clock()
    server = make_server(AppParameters({
        "upload_dir": str(tmp_path / "u"), "tmp_dir": str(tmp_path / "t"), "debug": True,
        "telemetry_enable": True, "telemetry_snapshot_interval_s": 1.0,
        "telemetry_clock": clock, "telemetry_mix_min_samples": 2}), device="cpu")
    thread = serve_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for opts in ("w_64,o_png", "w_48,h_48,c_1,o_png", "w_64,o_png", "w_32,smc_1,o_png"):
            assert _get(f"{base}/upload/{opts}/{src}")[0] == 200
        clock.now += 2.0
        assert _get(f"{base}/upload/w_20,o_png/{src}")[0] == 200   # rides the beat
        status, body = _get(f"{base}/debug/telemetry")
        doc = json.loads(body)
        recorded = {r["batch_id"] for r in
                    server.flight_recorder.snapshot(limit=10_000)["records"]}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200 and doc["enabled"] and doc["mix"]["samples"] >= 4
    directory = os.path.join(str(tmp_path / "t"), "telemetry")
    records = telemetry.read_archive(directory)["records"]
    kinds = [r["kind"] for r in records]
    assert kinds[0] == "boot" and "window" in kinds and "launch" in kinds
    launches = [r for r in records if r["kind"] == "launch"]
    assert all(r["batch_id"] in recorded for r in launches)
    windows = [r for r in records if r["kind"] == "window"]
    assert sum(r["hits_delta"] + r["misses_delta"] for r in windows) == 5
    # a line cut by a crash: a fresh archive on the directory cuts it off
    segment = sorted(n for n in os.listdir(directory) if n.endswith(".jsonl"))[-1]
    with open(os.path.join(directory, segment), "ab") as fh:
        fh.write(b'{"schema":1,"kind":"wind')
    fresh = telemetry.TelemetryArchive(directory)
    assert fresh.torn_recovered == 1
    assert telemetry.read_archive(directory)["torn"] == 0
    assert len(telemetry.read_archive(directory)["records"]) == len(records)
