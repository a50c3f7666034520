"""Virtual meshes — the JAX package's ``repro.launch.mesh`` on one device.

A JAX mesh lays named axes over real devices.  The port runs LPF
processes as *virtual processes* on one card (``[p]``-stacked values), so
its mesh holds only the axis names and their sizes, and no devices:

* ``pod`` — the cross-pod (DCN) axis the JAX package drives with explicit
  LPF supersteps (``bsp.pod_sync``, ``bsp.grad_sync``).  ``q`` pods are
  ``q`` virtual processes, exactly as ``bsp_fft``'s 8 processes are;
* ``data`` and ``model`` — GSPMD layouts over real devices.  One card has
  none to lay them over: a mesh that sizes either above 1 describes a
  multi-GPU run, and running on it raises :class:`LPFFatalError` naming
  ROADMAP A10's multi-GPU part (:func:`virtual_pods`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.errors import LPFFatalError

__all__ = ["VirtualMesh", "make_production_mesh", "make_mesh", "dp_axes_of",
           "model_axis_of", "virtual_pods"]

#: the GSPMD axes one card cannot hold above size 1
DEVICE_AXES = ("data", "model")


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


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    """The JAX package's production TPU v5e layout, as a shape: one 16x16
    pod (256 chips) or two pods = 512 chips with a leading ``pod`` axis.
    Its data and model axes need the multi-GPU port (A10)."""
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


def dp_axes_of(mesh: VirtualMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_of(mesh: VirtualMesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def virtual_pods(mesh: Optional[VirtualMesh], pod_axis: str = "pod") -> int:
    """The number of pods a run on ``mesh`` holds as virtual processes on
    one device (1 without a mesh or a pod axis).  A ``data`` or ``model``
    axis above 1 is a GSPMD layout over real devices and raises."""
    if mesh is None:
        return 1
    wide = {a: s for a, s in mesh.shape.items()
            if a in DEVICE_AXES and s > 1}
    if wide:
        raise LPFFatalError(
            f"mesh {mesh.shape}: the data and model axes are GSPMD layouts "
            f"over real devices ({wide}); one card runs only pods, as "
            f"virtual processes, and those axes wait for the multi-GPU "
            f"port (ROADMAP A10, its multi-GPU part)")
    return mesh.shape.get(pod_axis, 1)
