"""Meshes of the port (port of `repro/launch/mesh.py`).

A real mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dims over the ranks of the default process group; the caller initializes
the group and chooses its backend and device type, nothing here picks
either. The production mesh is abstract: names and sizes only (the
`Sharder` and its specs need no more), since its 256 or 512 ranks exist
on no machine the port runs on. Placing a tensor on it raises, as the
reference's `jax.make_mesh` fails on fewer devices than it names.

Functions, never module-level meshes, so importing this module touches no
process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

__all__ = ["make_production_mesh", "make_local_mesh", "make_abstract_mesh",
           "AbstractMesh", "batch_axes", "mesh_shape", "MODEL_AXIS"]

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks (the port's counterpart of
    `jax.sharding.AbstractMesh`)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def unplaced(self, world: int) -> RuntimeError:
        """The error of placing a tensor on this mesh from `world` ranks."""
        return RuntimeError(
            f"the mesh {self.shape} carries names and sizes only: placing "
            f"a tensor on it needs {self.size} ranks, and this world has "
            f"{world}")


def make_abstract_mesh(axis_sizes: Sequence[int],
                       axis_names: Sequence[str]) -> AbstractMesh:
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"got {len(sizes)} sizes for {len(names)} names")
    return AbstractMesh(sizes, names)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks)."""
    if multi_pod:
        return make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_abstract_mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1, *, device_type: str):
    """A ("data", "model") DeviceMesh over the first data * model ranks
    of the default process group, clamped as the reference clamps to the
    ranks there are. `device_type` is the type of the tensors it holds
    ("cuda" or "cpu")."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (pure DP): ('pod','data') when the
    pod axis exists, else ('data',)."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
