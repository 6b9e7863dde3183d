"""Parallelism of the PyTorch package: device meshes, spatial tiling,
multi-process initialisation.

The port of ``flyimg_tpu/parallel/``:

- ``mesh.py``: a ``Mesh`` of axis names and sizes over ``torch.device``s
  (a device may repeat: a virtual mesh), and the moves that place a tensor
  on it: a leading axis sharded over an axis, a copy on every rank, shards
  gathered in rank order;
- ``tiling.py``: very tall images split by height across ranks, with halo
  exchange (resample, filters) or a ring (rotate) — the tall-input path of
  the handler;
- ``dist.py``: ``torch.distributed`` initialisation across processes.

Data-parallel serving batches shard over a mesh's ``data`` axis in
``runtime/batcher.py`` (``BatchController(mesh=...)``), and the DP x TP
BlazeFace step over ``(data, model)`` in ``models/blazeface_train.py``
(``make_sharded_train_step``).
"""

from flyimg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    default_mesh,
    gather_shards,
    make_mesh,
    replicate,
    shard_leading,
)
from flyimg_tpu_torch.parallel.tiling import tiled_transform  # noqa: F401
