"""Device meshes of the PyTorch package.

The port of ``flyimg_tpu/parallel/mesh.py`` ``make_mesh`` and
``default_mesh``. A ``Mesh`` is the axis names, the axis sizes and the
ordered list of ``torch.device``s (row-major over the axes). A device may
repeat in the list: n ranks on one card (or on the CPU) is a virtual mesh,
the counterpart of the JAX tests' virtual CPU devices, and runs every
kernel and the whole ring and halo schedule of ``parallel/tiling.py`` on
that one device.

Choosing the backend is ``device.py``'s (an entry point asks for
``"cuda"`` and raises without a card; a CPU mesh is asked for by name).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

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
