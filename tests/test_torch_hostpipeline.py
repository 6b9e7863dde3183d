"""The PyTorch package's host stage pools (flyimg_tpu_torch/runtime/
hostpipeline.py) against the JAX package's (flyimg_tpu/runtime/
hostpipeline.py; tests/test_host_pipeline.py is the JAX side's own).

Each test runs one script through both modules' ``StagePool`` or
``HostPipeline`` and compares what they did: results, the 503 shed at the
same pending count, the pressure, the heal of a dead and of a wedged
worker, the drain at close, resizes. Then the port's server with the
pipeline on and off answers the same bytes, and the handler's stage
fallbacks behave as the JAX handler's. Waits and wedge bounds stay under a
second; every blocking task is released in a ``finally``.
"""

import threading
import time

import numpy as np
import pytest

from flyimg_tpu.appconfig import AppParameters as JAppParameters
from flyimg_tpu.exceptions import ServiceUnavailableException as JUnavailable
from flyimg_tpu.runtime import hostpipeline as jhp
from flyimg_tpu_torch.appconfig import AppParameters
from flyimg_tpu_torch.codecs import png
from flyimg_tpu_torch.exceptions import ServiceUnavailableException
from flyimg_tpu_torch.runtime import hostpipeline as hp

MODULES = {"port": hp, "jax": jhp}
SHED = (ServiceUnavailableException, JUnavailable)


def _both(script):
    """``script(module)`` for the port and the JAX module: their outcomes."""
    return {name: script(mod) for name, mod in MODULES.items()}


def _same(script):
    got = _both(script)
    assert got["port"] == got["jax"], got
    return got["port"]


def test_results_and_errors_match_jax():
    def script(mod):
        pool = mod.StagePool("decode", workers=2, queue_depth=8)
        try:
            results = [f.result(timeout=10) for f in
                       [pool.submit(lambda i=i: i * i) for i in range(8)]]

            def boom():
                raise ValueError("bad bytes")

            try:
                pool.submit(boom).result(timeout=10)
                err = None
            except ValueError as exc:
                err = str(exc)
            after = pool.submit(lambda: 7).result(timeout=10)
            return results, err, after, pool.pending
        finally:
            pool.close()

    assert _same(script) == ([i * i for i in range(8)], "bad bytes", 7, 0)


@pytest.mark.parametrize("workers,queue_depth", [(1, 1), (2, 1), (1, 3)])
def test_shed_at_the_same_pending_count_as_jax(workers, queue_depth):
    def script(mod):
        pool = mod.StagePool("decode", workers=workers, queue_depth=queue_depth,
                             shed_retry_after_s=3.0)
        gate = threading.Event()
        try:
            admitted = []
            for _ in range(workers + queue_depth + 2):
                try:
                    admitted.append(pool.submit(gate.wait))
                except SHED as exc:
                    shed = (len(admitted), pool.pending, exc.retry_after_s)
                    break
            gate.set()
            for fut in admitted:
                fut.result(timeout=10)
            return shed, pool.stats()["bound"]
        finally:
            gate.set()
            pool.close()

    shed, bound = _same(script)
    assert shed == (workers + queue_depth, workers + queue_depth, 3)
    assert bound == workers + queue_depth


def test_pressure_tracks_the_worst_stage_as_jax():
    def script(mod):
        pipeline = mod.HostPipeline(enabled=True, fetch_workers=1, decode_workers=1,
                                    encode_workers=1, queue_depth=1)
        gate = threading.Event()
        try:
            seen = [pipeline.pressure()]
            pool = pipeline.pool("decode")
            pool.submit(gate.wait)
            seen.append(pipeline.pressure())
            pool.submit(lambda: 1)
            seen.append(pipeline.pressure())
            pipeline.pool("fetch").submit(gate.wait)
            seen.append(pipeline.pressure())
            snap = {k: sorted(v) for k, v in pipeline.snapshot().items()}
            return seen, pipeline.policy(), snap
        finally:
            gate.set()
            pipeline.close()

    seen, policy, _snap = _same(script)
    assert seen == [0.0, 0.5, 1.0, 1.0] and policy == {"fetch": 1, "decode": 1, "encode": 1}


def test_disabled_pipeline_is_inert_as_jax():
    def script(mod):
        pipeline = mod.HostPipeline(enabled=False)
        out = (pipeline.enabled, pipeline.pools(), pipeline.pressure(), pipeline.snapshot(),
               pipeline.run("decode", lambda: "inline", timeout=0.1))
        pipeline.close()
        return out

    assert _same(script) == (False, [], 0.0, {}, "inline")


def test_wedged_worker_healed_as_jax():
    """A worker in one task past the wedge bound is replaced at the next
    submit: the task fails with a TimeoutError, its slot frees, the stage
    keeps its workers."""
    def script(mod):
        pool = mod.StagePool("decode", workers=1, queue_depth=8, wedge_timeout_s=0.05)
        gate = threading.Event()
        try:
            wedged = pool.submit(gate.wait)
            time.sleep(0.15)
            after = pool.submit(lambda: 42).result(timeout=10)
            try:
                wedged.result(timeout=1)
                abandoned = None
            except TimeoutError as exc:
                abandoned = "wedged" in str(exc)
            pending = pool.pending
            gate.set()
            again = pool.submit(lambda: 1).result(timeout=10)
            return after, abandoned, pending, again, pool.stats()["workers"]
        finally:
            gate.set()
            pool.close()

    assert _same(script) == (42, True, 0, 1, 1.0)


def test_dead_worker_respawned_as_jax():
    def script(mod):
        pool = mod.StagePool("encode", workers=1, queue_depth=4)
        try:
            dead = threading.Thread(target=lambda: None)
            dead.start()
            dead.join()
            with pool._lock:
                pool._busy[dead] = None
            out = pool.submit(lambda: "alive").result(timeout=10)
            with pool._lock:
                gone = dead not in pool._busy
            return out, gone, pool.stats()["workers"]
        finally:
            pool.close()

    # the planted corpse is replaced: the live worker and its new peer
    assert _same(script) == ("alive", True, 2.0)


def test_port_counts_restarts_by_reason():
    pool = hp.StagePool("decode", workers=1, queue_depth=4, wedge_timeout_s=0.05)
    gate = threading.Event()
    try:
        pool.submit(gate.wait)
        time.sleep(0.15)
        assert pool.submit(lambda: 1).result(timeout=10) == 1
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join()
        with pool._lock:
            pool._busy[dead] = None
        assert pool.submit(lambda: 2).result(timeout=10) == 2
        assert pool.restarts == {"dead": 1, "wedged": 1}
        assert pool.waits >= 2 and pool.wait_s >= 0.0
    finally:
        gate.set()
        pool.close()


def test_close_drains_and_strands_as_jax():
    def script(mod):
        pool = mod.StagePool("decode", workers=1, queue_depth=16)
        done = []
        futs = [pool.submit(lambda i=i: done.append(i) or i) for i in range(6)]
        pool.close(drain_timeout_s=10.0)
        drained = [f.result(timeout=1) for f in futs]
        try:
            pool.submit(lambda: 1)
            closed = False
        except RuntimeError:
            closed = True
        pool = mod.StagePool("decode", workers=1, queue_depth=8)
        gate = threading.Event()
        try:
            pool.submit(gate.wait)
            stranded = pool.submit(lambda: "never")
            pool.close(drain_timeout_s=0.2)
            try:
                stranded.result(timeout=1)
                stamped = False
            except TimeoutError:
                stamped = True
        finally:
            gate.set()
        return drained, len(done), closed, stamped

    assert _same(script) == (list(range(6)), 6, True, True)


def test_resize_and_policy_match_jax():
    def script(mod):
        pipeline = mod.HostPipeline(enabled=True, fetch_workers=2, decode_workers=2,
                                    encode_workers=2, queue_depth=4)
        try:
            applied = pipeline.apply_policy({"decode": 4, "encode": 1, "nope": 3})
            time.sleep(0.05)
            out = [applied, pipeline.policy()]
            for stage in ("fetch", "decode", "encode"):
                pool = pipeline.pool(stage)
                out.append((pool.admission.max_pending,
                            pool.submit(lambda s=stage: s).result(timeout=10)))
            return out
        finally:
            pipeline.close()

    got = _same(script)
    assert got[0] == {"decode": 4, "encode": 1}
    assert got[1] == {"fetch": 2, "decode": 4, "encode": 1}


def test_from_params_defaults_match_jax():
    def script(mod):
        params = (AppParameters() if mod is hp else JAppParameters({}))
        pipeline = mod.HostPipeline.from_params(params)
        try:
            return (pipeline.enabled, pipeline.policy(),
                    {n: p.queue_depth for n, p in pipeline.pools()},
                    {n: p.wedge_timeout_s for n, p in pipeline.pools()})
        finally:
            pipeline.close()

    got = _same(script)
    assert got[0] is True and got[1] == {"fetch": 4, "decode": 2, "encode": 2}


# ---------------------------------------------------------------------------
# the handler's stages


def _serve(tmp_path, name, **extra):
    from flyimg_tpu_torch.service.app import make_server, serve_in_thread

    conf = {"tmp_dir": str(tmp_path / name / "t"), "upload_dir": str(tmp_path / name / "u"),
            "batch_deadline_ms": 1.0}
    conf.update(extra)
    server = make_server(AppParameters(conf), device="cpu")
    return server, serve_in_thread(server)


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_answers_with_the_pipeline_on_and_off_are_byte_equal(tmp_path):
    """16 concurrent requests (PNG and WebP answers of seeded PNGs) through
    a server with the stage pools on and one with them off: the same
    bytes; with them on, every stage ran on its pool."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    sources = []
    for i in range(4):
        path = tmp_path / f"src{i}.png"
        path.write_bytes(png.encode(np.random.default_rng(i).integers(
            0, 256, (48 + 8 * i, 64, 3), dtype=np.uint8)))
        sources.append(str(path))
    urls = [f"/upload/{opts}/{src}" for src in sources
            for opts in ("w_30,h_25,c_1,o_png", "w_40,o_png", "w_30,h_25,c_1,o_webp,webpl_1",
                         "r_15,o_png")]
    answers = {}
    for enabled in (True, False):
        server, thread = _serve(tmp_path, f"on{enabled}", host_pipeline_enable=enabled,
                                host_pipeline_decode_workers=2, host_pipeline_encode_workers=2)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with ThreadPoolExecutor(16) as pool:
                answers[enabled] = list(pool.map(
                    lambda u: urllib.request.urlopen(base + u, timeout=120).read(), urls))
            assert server.host_pipeline.enabled is enabled
            if enabled:
                waits = {n: p.waits for n, p in server.host_pipeline.pools()}
                assert waits == {"fetch": 16, "decode": 16, "encode": 16}
            assert server.handler.wedged_fallbacks == 0
        finally:
            _stop(server, thread)
    assert answers[True] == answers[False]


def test_handler_stage_fallbacks_match_jax(tmp_path):
    """A stage pool that does not answer within the device wait: decode and
    encode run inline (counted as a wedge), fetch answers 503; a pool at its
    bound sheds its 503 (the JAX handler's ``_stage``)."""
    from flyimg_tpu_torch.runtime.resilience import Deadline
    from flyimg_tpu_torch.service.handler import ImageHandler

    pipeline = hp.HostPipeline(enabled=True, fetch_workers=1, decode_workers=1,
                               encode_workers=1, queue_depth=1)
    handler = ImageHandler(AppParameters({"upload_dir": str(tmp_path / "u"),
                                          "tmp_dir": str(tmp_path / "t"),
                                          "device_result_timeout_s": 0.2}),
                           device="cpu", host_pipeline=pipeline)
    gate = threading.Event()
    try:
        pipeline.pool("decode").submit(gate.wait)
        assert handler._stage("decode", lambda: "inline", Deadline(0)) == "inline"
        assert handler.wedged_fallbacks == 1
        pipeline.pool("fetch").submit(gate.wait)
        with pytest.raises(ServiceUnavailableException, match="did not produce"):
            handler._stage("fetch", lambda: "x", Deadline(0), inline_fallback=False)
        assert handler.wedged_fallbacks == 2
        # the timed-out task still holds its slot: the stage is at its bound
        with pytest.raises(ServiceUnavailableException, match="host fetch pool is full"):
            handler._stage("fetch", lambda: "x", Deadline(0), inline_fallback=False)
        assert handler.wedged_fallbacks == 2
    finally:
        gate.set()
        pipeline.close()
