"""One process of the port's two-process serving test
(``test_torch_multihost.py``): joins a ``gloo`` process group over a local
TCP coordinator (``parallel/dist.py initialize_multihost``), builds the
per-host serving stack as the port's app builds it with several cards (a
``data`` mesh, here 4 virtual CPU ranks, under a ``BatchController``),
serves one request, holds it to ``run_plan``, and prints a line the test
checks. It imports neither JAX nor the JAX package.

Run: python torch_multihost_worker.py <coordinator> <num_processes> <process_id>
"""

import sys

LOCAL_RANKS = 4


def main() -> int:
    coordinator, num_processes, process_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import numpy as np
    import torch
    import torch.distributed as dist

    from flyimg_tpu_torch.ops.compose import run_plan
    from flyimg_tpu_torch.parallel.dist import initialize_multihost, local_batch_slice
    from flyimg_tpu_torch.parallel.mesh import virtual_mesh
    from flyimg_tpu_torch.runtime.batcher import BatchController
    from flyimg_tpu_torch.spec.options import OptionsBag
    from flyimg_tpu_torch.spec.plan import build_plan

    torch.set_num_threads(1)
    assert initialize_multihost(coordinator, num_processes, process_id, device="cpu",
                                timeout_s=120.0)
    try:
        assert dist.get_world_size() == num_processes and dist.get_rank() == process_id
        # the global view: every process's local ranks, summed over the group
        ranks = torch.tensor([LOCAL_RANKS])
        dist.all_reduce(ranks)
        n_global = int(ranks.item())
        assert n_global == LOCAL_RANKS * num_processes, n_global
        assert local_batch_slice(2 * num_processes) == slice(2 * process_id,
                                                             2 * process_id + 2)
        # the per-host serving stack: a batcher over this host's own ranks
        mesh = virtual_mesh(LOCAL_RANKS, "cpu", ("data",))
        batcher = BatchController(max_batch=8, deadline_ms=2.0, mesh=mesh, device="cpu")
        try:
            rng = np.random.default_rng(100 + process_id)
            img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
            plan = build_plan(OptionsBag("w_64,h_48,c_1"), 128, 96)
            out = batcher.submit(img, plan).result(timeout=120)
            assert out.shape == (48, 64, 3), out.shape
            np.testing.assert_array_equal(out, run_plan(img, plan, device="cpu"))
            launches = [(n, b) for k, n, b in batcher.launch_log if k == "transform"]
            assert launches == [(1, LOCAL_RANKS)], launches
        finally:
            batcher.close()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"MULTIHOST_OK process={process_id}/{num_processes} "
          f"local={LOCAL_RANKS} global={n_global}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
