"""Device meshes of the port.

Port of ``repro.launch.mesh``.  A mesh is a grid of devices with named
axes: the production mesh is (data=16, model=16), 256 devices; with
``multi_pod`` a leading "pod" axis of 2 makes 512.  The batch shards over
("pod", "data"), so traffic between pods is the gradient reduction alone.
These are functions, not module constants: importing this module touches
no device.

Three kinds of mesh:
- ``make_production_mesh`` takes that many CUDA devices and raises when the
  machine has fewer.  It never falls back to a smaller mesh.
- ``make_planning_mesh`` has the production shapes and no devices.  The dry
  run plans every cell's shardings on it; nothing can run on it.
- ``make_host_mesh`` is 1 x 1 on one device, the card unless the caller
  asks for the CPU.  Every spec resolves there to the whole tensor.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


def _production_axes(multi_pod: bool) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


class _Axes:
    axis_names: tuple

    @property
    def shape(self) -> OrderedDict:
        """Axis name -> size, in axis order."""
        return OrderedDict(zip(self.axis_names, self._sizes()))

    @property
    def size(self) -> int:
        return int(np.prod(self._sizes()))


@dataclass(frozen=True, eq=False)
class Mesh(_Axes):
    """``devices``: an array of ``torch.device`` of the mesh's shape."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices {self.devices.shape} vs axes "
                             f"{self.axis_names}")

    def _sizes(self) -> tuple:
        return self.devices.shape


@dataclass(frozen=True)
class PlanningMesh(_Axes):
    """A mesh's axes without devices: shardings can be planned on it and
    their shard shapes reckoned, but no tensor can be placed."""
    sizes: tuple
    axis_names: tuple

    def _sizes(self) -> tuple:
        return self.sizes


def _mesh(devs: list, shape: tuple, axes: tuple) -> Mesh:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape, axes = _production_axes(multi_pod)
    n = int(np.prod(shape))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} CUDA devices for the production mesh "
            f"{dict(zip(axes, shape))}, have {have}; plan its shardings on "
            "make_planning_mesh() instead")
    resolve_device("cuda")
    return _mesh([torch.device("cuda", i) for i in range(n)], shape, axes)


def make_planning_mesh(*, multi_pod: bool = False) -> PlanningMesh:
    shape, axes = _production_axes(multi_pod)
    return PlanningMesh(shape, axes)


def make_host_mesh(device="cuda") -> Mesh:
    """1 x 1 ("data", "model") on ``device`` (the current CUDA device when
    no index is given)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _mesh([dev], (1, 1), ("data", "model"))
