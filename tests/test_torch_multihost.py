"""Per-host serving of the PyTorch package across processes: the port's
counterpart of ``tests/test_multihost.py``. Two real processes join one
``gloo`` process group through a local TCP coordinator
(``parallel/dist.py initialize_multihost``); each serves one request with a
``BatchController`` over its own 4-rank ``data`` mesh (virtual CPU ranks),
as the port's app builds one over a host's cards, and its answer equals
``run_plan``'s. That pins the pod contract: a host's batcher touches only
its own devices, and every host serves correct pixels on its own.

The workers are separate interpreters (``tests/torch_multihost_worker.py``):
a process group is one a process. The test is bounded by
``communicate(timeout=WORKER_TIMEOUT_S)``; a worker past it is killed and
the test fails, so it cannot hang the suite.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_local_mesh_serving():
    coordinator = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(os.path.abspath(worker)))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, worker, coordinator, "2", str(pid)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                         text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        pytest.fail(f"multihost workers timed out; partial output: {outs}")
    for pid, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK process={pid}/2 local=4 global=8" in out, out
