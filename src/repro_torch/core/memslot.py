"""Memory slots over a stacked store — ``lpf_register_{local,global}``,
``lpf_deregister``, ``lpf_resize_memory_register``.

The port runs ``p`` *virtual processes* in one device process, so a slot
names one 1-D array per process and the store keeps them stacked: every
slot value is a tensor ``[p, size]`` on the context's device, row ``s``
being process ``s``'s memory.  ``Slot.size`` counts per-process elements,
as in the paper (offsets and sizes are in elements).

**The process-axis rule.**  A value handed to :meth:`SlotRegistry.register`
must carry the process axis first: its leading dimension is ``p`` and is
never inferred from shapes.  A value that every process shares is made
explicit with :func:`replicate` (``LPFContext.replicate``).  With
``flatten=True`` the remaining dimensions are flattened per process; the
per-process shape is kept as ``Slot.orig_shape``.

The store is functional: supersteps write new tensors and never write
into a tensor the caller registered.

The capacity contract is the paper's: the number of simultaneously
registered slots must not exceed the reserved register size.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from .errors import LPFCapacityError, LPFFatalError

__all__ = ["Slot", "SlotRegistry", "as_torch_dtype", "dtype_name",
           "replicate"]

# Registration epochs are process-global so a handle minted by any
# registry can never collide with a later registration that reuses its
# slot id — the stale handle is detectable by generation alone.
_GENERATION = itertools.count(1)


def as_torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a torch dtype (accepts torch dtypes, numpy dtypes and
    numpy dtype names)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def dtype_name(dtype) -> str:
    """The numpy-style name of a slot dtype (``"float32"``, ...), so plan
    signatures spell dtypes as the JAX package's do."""
    return str(as_torch_dtype(dtype)).replace("torch.", "")


def replicate(value, p: int, device=None) -> torch.Tensor:
    """``value`` shared by every process: a new ``[p, *value.shape]``
    tensor whose rows are copies of ``value``."""
    v = torch.as_tensor(value, device=device)
    return v.unsqueeze(0).expand(p, *v.shape).clone()


@dataclasses.dataclass(frozen=True)
class Slot:
    """Handle to a registered memory area (``lpf_memslot_t``)."""

    sid: int
    name: str
    size: int            # elements per process
    dtype: Any           # torch dtype
    kind: str            # "global" | "local"
    orig_shape: tuple    # per-process shape for flatten-registered tensors
    gen: int = 0         # registration epoch; 0 = synthetic (tests)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (f"Slot<{self.name}#{self.sid} {self.kind} "
                f"{self.size}x{dtype_name(self.dtype)}>")


class SlotRegistry:
    """Tracks registered slots + their current stacked ``[p, size]``
    values on ``device``."""

    def __init__(self, p: int, device, capacity: int = 0):
        self.p = int(p)
        # normalised ("cuda" -> "cuda:0") so device equality checks hold
        self.device = torch.empty(0, device=device).device
        self.capacity = capacity
        self._slots: Dict[int, Slot] = {}
        self._values: Dict[int, torch.Tensor] = {}
        self._next_sid = 0
        self._free_sids: List[int] = []   # min-heap of deregistered ids

    # -- lpf_resize_memory_register -------------------------------------
    def resize(self, capacity: int) -> None:
        if capacity < len(self._slots):
            raise LPFCapacityError(
                f"cannot shrink register below {len(self._slots)} active slots",
                required=len(self._slots), capacity=capacity,
                kind="register")
        self.capacity = capacity

    # -- lpf_register_{local,global} -------------------------------------
    def register(self, name: str, value, kind: str, flatten: bool = True) -> Slot:
        if len(self._slots) >= self.capacity:
            raise LPFCapacityError(
                f"memory register full ({self.capacity}); call "
                f"resize_memory_register first",
                required=len(self._slots) + 1, capacity=self.capacity,
                kind="register")
        value = torch.as_tensor(value, device=self.device)
        if value.ndim == 0 or value.shape[0] != self.p:
            raise LPFFatalError(
                f"slot {name!r}: a registered value is stacked over the "
                f"processes, leading dimension p={self.p}; got shape "
                f"{tuple(value.shape)} (use replicate() for a value every "
                f"process shares)")
        orig_shape = tuple(value.shape[1:])
        if flatten:
            value = value.reshape(self.p, -1)
        elif value.ndim != 2:
            raise LPFFatalError("slots are 1-D per process; pass "
                                "flatten=True for tensors")
        if self._free_sids:
            sid = heapq.heappop(self._free_sids)
        else:
            sid = self._next_sid
            self._next_sid += 1
        slot = Slot(sid, name, int(value.shape[1]), value.dtype,
                    kind, orig_shape, next(_GENERATION))
        self._slots[slot.sid] = slot
        self._values[slot.sid] = value
        return slot

    # -- lpf_deregister ---------------------------------------------------
    def deregister(self, slot: Slot) -> None:
        self._check(slot)
        del self._slots[slot.sid]
        del self._values[slot.sid]
        heapq.heappush(self._free_sids, slot.sid)

    # -- value plumbing ----------------------------------------------------
    def _check(self, slot: Slot) -> None:
        if slot.sid not in self._slots:
            raise LPFFatalError(f"slot {slot} is not registered")
        live = self._slots[slot.sid]
        if live is not slot and live.gen != slot.gen:
            raise LPFFatalError(
                f"stale handle {slot}: slot id {slot.sid} was deregistered "
                f"and re-registered as {live}")

    def is_registered(self, slot: Slot) -> bool:
        """True iff *this exact handle* (id + generation) is live."""
        live = self._slots.get(slot.sid)
        return live is not None and (live is slot or live.gen == slot.gen)

    def value(self, slot: Slot) -> torch.Tensor:
        """The stacked ``[p, size]`` value."""
        self._check(slot)
        return self._values[slot.sid]

    def tensor(self, slot: Slot) -> torch.Tensor:
        """Current value reshaped to ``[p, *orig_shape]``."""
        return self.value(slot).reshape(self.p, *slot.orig_shape)

    def set_value(self, slot: Slot, value: torch.Tensor) -> None:
        self._check(slot)
        if tuple(value.shape) != (self.p, slot.size) \
                or value.dtype != slot.dtype or value.device != self.device:
            raise LPFFatalError(
                f"local write to {slot} with mismatched shape/dtype/device "
                f"{tuple(value.shape)}/{value.dtype}/{value.device}")
        self._values[slot.sid] = value

    @property
    def n_active(self) -> int:
        return len(self._slots)
