"""Meshes: named grids of ranks (port of ``repro/launch/mesh.py``).

A ``Mesh`` is the port's own small class: its axis names, ``shape`` (axis
name → size, in the axes' order) and ``devices``, the grid of rank ids
(``numpy.arange(size)`` laid out row-major over the axes, as JAX lays out
devices).  It needs no process group to exist, so the production meshes
(256 and 512 chips) are abstract: the specs of ``train/train_step.py``
read only their axes and sizes.  Once a process group of ``size`` ranks is
up, ``mesh.group(axis)`` gives this rank's group along ``axis``: the ranks
that share every other coordinate, made by ``torch.distributed.new_group``
on the default backend (gloo for the ranks of ``distributed/spawn.py``,
which share one card; NCCL refuses two ranks on one device).  ``with
mesh:`` makes it the current mesh of the thread (``current()``), as ``with
mesh:`` does in JAX, so a collective can name an axis
(``grad_compress.compress_gradients(..., pod_axis="pod")``).

``mesh.device_mesh_on(device_type)`` is the ``DeviceMesh`` of the mesh's
shape and axis names over the live process group, the mesh that DTensors
live on: the sharded train and decode steps' (``cpu`` for gloo ranks on
the CPU, ``cuda`` for gloo ranks sharing the card) and the dry-run's on
its fake group.

``make_production_mesh`` is a function, so importing this module touches
no process group.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class Mesh:
    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"do not match")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.devices = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))
        self._groups: Dict[str, object] = {}
        self._device_meshes: Dict[str, object] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_ranks(self, axis: str) -> List[List[int]]:
        """The groups along ``axis``: for each point of the other axes, the
        ranks that differ only in their ``axis`` coordinate."""
        rows = np.moveaxis(self.devices, self.axis_names.index(axis),
                           -1).reshape(-1, self.shape[axis])
        return [[int(r) for r in row] for row in rows]

    def group(self, axis: str):
        """This rank's process group along ``axis``.  Every rank of the
        world must call it for the same axis in the same order (each call
        of ``new_group`` is collective); the groups are kept."""
        import torch.distributed as dist
        if axis not in self._groups:
            if not dist.is_initialized() or dist.get_world_size() != self.size:
                raise RuntimeError(
                    f"{describe(self)}: group({axis!r}) needs a process "
                    f"group of {self.size} ranks")
            me = dist.get_rank()
            for ranks in self.axis_ranks(axis):
                g = dist.new_group(ranks)
                if me in ranks:
                    self._groups[axis] = g
        return self._groups[axis]

    def device_mesh_on(self, device_type: str = "cpu"):
        """The ``DeviceMesh`` of this mesh's shape and axis names over the
        live default process group of ``size`` ranks, for ``device_type``;
        kept, like the groups (``init_device_mesh`` is collective)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if device_type not in self._device_meshes:
            if not dist.is_initialized() or dist.get_world_size() != self.size:
                raise RuntimeError(
                    f"{describe(self)}: a DeviceMesh needs a process group "
                    f"of {self.size} ranks")
            self._device_meshes[device_type] = init_device_mesh(
                device_type, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)
        return self._device_meshes[device_type]

    def __enter__(self) -> "Mesh":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()


_STATE = threading.local()


def _stack():
    if not hasattr(_STATE, "meshes"):
        _STATE.meshes = []
    return _STATE.meshes


def current() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:`` in this thread."""
    stack = _stack()
    return stack[-1] if stack else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (16, 16) over ('data','model'): 256 chips.
    Multi-pod: (2, 16, 16) over ('pod','data','model'): 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (tests use tiny ones, e.g. (2,) over ('pod',) on 2
    ranks)."""
    return Mesh(shape, axes)


def mesh_for_plan(plan) -> Mesh:
    """The (data, model) mesh of an ``ElasticPlanner`` plan
    (``train/fault_tolerance.py``'s ``MeshPlan``): ``(plan.data,
    plan.model)`` over ``("data", "model")``, the mesh of a supervisor's
    segment."""
    return Mesh((plan.data, plan.model), ("data", "model"))


def batch_axes_of(mesh) -> Tuple[str, ...]:
    """All non-'model' axes carry the batch (pod composes with data)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def describe(mesh) -> str:
    return (f"mesh{tuple(mesh.devices.shape)} axes={mesh.axis_names} "
            f"chips={mesh.devices.size}")
