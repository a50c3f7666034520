"""Virtual meshes: a mesh's axis names and sizes, and its devices run as
virtual shards on one device.

A JAX mesh lays named axes over real devices.  The port runs a mesh's
devices as *virtual shards* on one card, so its mesh holds only the axis
names and their sizes, and no devices:

* ``pod`` — the cross-pod (DCN) axis the JAX package drives with explicit
  LPF supersteps (``bsp.pod_sync``, ``bsp.grad_sync``).  ``q`` pods are
  ``q`` virtual processes (``[q]``-stacked values), exactly as
  ``bsp_fft``'s 8 processes are (:func:`virtual_pods`);
* ``data`` and ``model`` — the GSPMD axes.  Where the JAX package only
  lays a tensor over them, the values do not change and the port holds
  the tensor whole.  Where a ``shard_map`` body computes per shard
  (``moe_apply``'s capacity per batch shard and experts per model shard,
  ``decode_attention``'s partial softmax per cache shard), a shard's view
  is one slice of the dimension split over the shards (:func:`split`), a
  ``psum``/``pmax`` over the axes a sum or max over that stacked
  dimension, in shard order, and :func:`merge` undoes the split.

The shard index over several axes is row-major in the order the axes are
named, as ``lax.axis_index`` of a tuple of axes and a
``PartitionSpec`` entry of several axes count it.  The model, runtime and
BSP layers import these helpers from here; the launchers' meshes
(:mod:`repro_torch.launch.mesh`) are built from :class:`VirtualMesh`.
A run over several cards (``torch.distributed``) waits for the multi-GPU
port (ROADMAP A10, its multi-GPU part).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from .errors import LPFFatalError

__all__ = ["VirtualMesh", "dp_axes_of", "model_axis_of", "virtual_pods",
           "mesh_shards", "split", "merge"]


class VirtualMesh:
    """Axis names and sizes of a mesh, without devices.  ``shape`` maps
    each name to its size in axis order, as ``jax.sharding.Mesh.shape``
    does."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise LPFFatalError(f"mesh shape {tuple(shape)} and axes "
                                f"{tuple(axis_names)} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise LPFFatalError(f"mesh axes {tuple(axis_names)} repeat")
        if any(int(s) < 1 for s in shape):
            raise LPFFatalError(f"mesh sizes must be >= 1, got "
                                f"{tuple(shape)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self._sizes = tuple(int(s) for s in shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._sizes))

    def __repr__(self) -> str:
        return f"VirtualMesh({self.shape})"


def dp_axes_of(mesh: VirtualMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_of(mesh: VirtualMesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def virtual_pods(mesh: Optional[VirtualMesh], pod_axis: str = "pod") -> int:
    """The number of pods a run on ``mesh`` holds as virtual processes on
    one device (1 without a mesh or a pod axis)."""
    if mesh is None:
        return 1
    return mesh.shape.get(pod_axis, 1)


def mesh_shards(mesh: VirtualMesh, axes: Iterable[str]) -> int:
    """The number of virtual shards over ``axes``: the product of their
    sizes (1 for no axes).  An axis the mesh does not have raises, as a
    ``PartitionSpec`` naming it fails in JAX."""
    sizes = mesh.shape
    n = 1
    for a in axes:
        if a not in sizes:
            raise LPFFatalError(f"mesh {sizes} has no axis {a!r}")
        n *= sizes[a]
    return n


def split(x: torch.Tensor, dim: int, n: int, what: str = "tensor"
          ) -> torch.Tensor:
    """``x`` with dimension ``dim`` viewed as ``[n, size / n]``: shard
    ``i``'s slice is index ``i`` of the new dimension ``dim``.  A size
    that ``n`` does not divide raises, naming ``what``: JAX cannot lay it
    over ``n`` devices either."""
    dim = dim % x.dim()
    size = x.shape[dim]
    if size % n:
        raise LPFFatalError(f"{what}: dimension {dim} of size {size} does "
                            f"not split over {n} virtual shards")
    return x.reshape(*x.shape[:dim], n, size // n, *x.shape[dim + 1:])


def merge(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of :func:`split`: dimensions ``dim`` (the shards) and
    ``dim + 1`` back into one."""
    dim = dim % x.dim()
    return x.reshape(*x.shape[:dim], x.shape[dim] * x.shape[dim + 1],
                     *x.shape[dim + 2:])
