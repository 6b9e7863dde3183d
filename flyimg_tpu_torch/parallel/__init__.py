"""Parallelism of the PyTorch package: device meshes, spatial tiling,
multi-process initialisation.

The port of ``flyimg_tpu/parallel/``:

- ``mesh.py``: a ``Mesh`` of axis names and sizes over ``torch.device``s
  (a device may repeat: a virtual mesh);
- ``tiling.py``: very tall images split by height across ranks, with halo
  exchange (resample, filters) or a ring (rotate) — the tall-input path of
  the handler;
- ``dist.py``: ``torch.distributed`` initialisation across processes.

Data-parallel serving batches (``batch_sharding``) are not ported yet.
"""

from flyimg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    default_mesh,
    make_mesh,
)
from flyimg_tpu_torch.parallel.tiling import tiled_transform  # noqa: F401
