"""The ambient mesh that model code can ask about (port of
`repro/distributed/constraints.py`).

`use_mesh(mesh)` makes a DeviceMesh or an AbstractMesh the ambient mesh
for the code inside it (the port's counterpart of
`repro.compat.use_mesh`); `mesh_axes()` and `dp_axes()` read it, and
outside any `use_mesh` they return nothing, so single-device code is
unaffected.

The reference's `constrain` (a `with_sharding_constraint` hint to GSPMD
at the MoE dispatch and the residual stream) has no eager counterpart:
no compiler partitions the port's tensors, so there is nothing to hint.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Tuple

from repro_torch.launch.mesh import mesh_shape

__all__ = ["use_mesh", "mesh_axes", "dp_axes"]

_AMBIENT = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    token = _AMBIENT.set(mesh)
    try:
        yield
    finally:
        _AMBIENT.reset(token)


def mesh_axes() -> Dict[str, int]:
    """Axis name -> size of the ambient mesh, {} if none."""
    mesh = _AMBIENT.get()
    return {} if mesh is None else mesh_shape(mesh)


def dp_axes() -> Tuple[str, ...]:
    ax = mesh_axes()
    return tuple(a for a in ("pod", "data") if a in ax)
