"""Device meshes of the PyTorch package.

The port of ``flyimg_tpu/parallel/mesh.py`` ``make_mesh``,
``default_mesh``, ``batch_sharding`` and ``replicated``. A ``Mesh`` is the
axis names, the axis sizes and the ordered list of ``torch.device``s
(row-major over the axes). A device may repeat in the list: n ranks on one
card (or on the CPU) is a virtual mesh, the counterpart of the JAX tests'
virtual CPU devices, and runs every kernel and the whole ring and halo
schedule of ``parallel/tiling.py``, and every shard of a data-parallel
batch, on that one device.

Where JAX places an array by a sharding, the port moves tensors itself:
``shard_leading`` cuts a tensor's leading axis into one equal shard a rank
of an axis, each on its rank's device (``batch_sharding``; the cut itself,
``leading_shards``, and its divisibility rule, ``shard_size``, serve
callers that move the shards on streams of their own); ``replicate`` puts
a copy on every device of the mesh or of one axis (``replicated``);
``gather_shards`` joins shards back in rank order. ``on_device`` makes a rank's card the
current one while its kernels launch (they launch on the current device).

Choosing the backend is ``device.py``'s (an entry point asks for
``"cuda"`` and raises without a card; a CPU mesh is asked for by name).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from flyimg_tpu_torch.device import resolve_device

DeviceLike = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over an ordered tuple of devices (row-major).
    Hashable, so tiled programs cache by it."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, every other axis at index 0: the
        ranks of a program sharded over ``axis`` alone."""
        k = self.axis_names.index(axis)
        stride = math.prod(self.axis_sizes[k + 1:])
        return tuple(self.devices[i * stride] for i in range(self.axis_sizes[k]))


def _rank_device(device: DeviceLike) -> torch.device:
    """``device`` resolved, a card named by its index ("cuda" is the
    current card), so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices() -> Tuple[torch.device, ...]:
    """Every CUDA card of this host; raises without CUDA."""
    resolve_device("cuda")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A Mesh over ``devices`` (default: every local card). Default: all of
    them on one axis. Raises ``ValueError`` when the axes want more devices
    than were given."""
    devs = tuple(_rank_device(d) for d in devices) if devices is not None \
        else local_devices()
    if axis_sizes is None:
        axis_sizes = (len(devs),)
    axis_sizes = tuple(int(v) for v in axis_sizes)
    axis_names = tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names for {len(axis_sizes)} sizes")
    n = math.prod(axis_sizes)
    if n > len(devs):
        raise ValueError(f"mesh wants {n} devices, only {len(devs)} available")
    return Mesh(axis_names, axis_sizes, devs[:n])


def default_mesh() -> Mesh:
    """Every local card on one 'data' axis; raises without CUDA."""
    return make_mesh()


def virtual_mesh(n: int, device: DeviceLike = "cuda",
                 axis_names: Sequence[str] = ("sp",)) -> Mesh:
    """n ranks, all on ``device``: one axis of size n."""
    return make_mesh((int(n),), axis_names, [device] * int(n))


def mesh_identity(mesh: Mesh) -> Tuple:
    """The mesh as a program identity carries it: its axes with their sizes
    and its devices (where the JAX key has ``mesh.shape``)."""
    return (tuple(mesh.shape.items()), tuple(str(d) for d in mesh.devices))


def on_device(dev: torch.device):
    """Make ``dev`` the current card while a rank launches its kernels (a
    no-op context on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def shard_size(n: int, ranks: int) -> int:
    """The size of each of ``ranks`` equal shards of a leading axis of
    ``n``. Raises ``ValueError`` when ``ranks`` does not divide ``n``."""
    if n % ranks:
        raise ValueError(f"a leading size of {n} does not shard over {ranks} ranks")
    return n // ranks


def leading_shards(x: torch.Tensor, ranks: int) -> List[torch.Tensor]:
    """``x``'s leading axis cut into ``ranks`` equal views, in rank order,
    where ``x`` lies (the caller moves each to its rank)."""
    per = shard_size(x.shape[0], ranks)
    return [x[r * per:(r + 1) * per] for r in range(ranks)]


def shard_leading(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """``x``'s leading axis cut into one equal shard a rank of ``axis``, in
    rank order, shard r on rank r's device (a view when that is ``x``'s).
    Raises ``ValueError`` when the axis does not divide the leading size."""
    devices = mesh.axis_devices(axis)
    return [s.to(dev) for s, dev in zip(leading_shards(x, len(devices)), devices)]


def replicate(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> List[torch.Tensor]:
    """A copy of ``x`` on every device of the mesh, in mesh order, or on
    each rank of ``axis`` alone (``x`` itself where it already lies
    there)."""
    devices = mesh.devices if axis is None else mesh.axis_devices(axis)
    return [x.to(dev) for dev in devices]


def gather_shards(shards: Sequence[torch.Tensor],
                  device: Optional[DeviceLike] = None) -> torch.Tensor:
    """The shards joined along the leading axis in rank order, on
    ``device`` (by default the first shard's)."""
    dev = shards[0].device if device is None else resolve_device(device)
    return torch.cat([s.to(dev) for s in shards])
