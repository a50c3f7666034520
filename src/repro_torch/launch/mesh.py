"""Meshes for the launchers — the JAX package's ``repro.launch.mesh`` on one
device.

A mesh here is a :class:`~repro_torch.core.mesh.VirtualMesh`: axis names
and sizes, whose devices run as virtual shards on one card
(:mod:`repro_torch.core.mesh`, re-exported here with the helpers that
split a dimension over them).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..core.mesh import (VirtualMesh, dp_axes_of, merge, mesh_shards,
                         model_axis_of, split, virtual_pods)

__all__ = ["VirtualMesh", "make_production_mesh", "make_mesh", "dp_axes_of",
           "model_axis_of", "virtual_pods", "mesh_shards", "split", "merge"]


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """The JAX package's production TPU v5e layout, as a shape: one 16x16
    pod (256 chips) or two pods = 512 chips with a leading ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(shape, axes)


def make_mesh(shape: Tuple[int, ...],
              axes: Optional[Tuple[str, ...]] = None) -> VirtualMesh:
    """Arbitrary mesh helper, with the JAX package's axis defaults: the
    last ``len(shape)`` of ``("pod", "data", "model")``, or ``ax{i}`` for
    more than three axes."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):] if len(shape) <= 3 \
            else tuple(f"ax{i}" for i in range(len(shape)))
    return VirtualMesh(tuple(shape), tuple(axes))
