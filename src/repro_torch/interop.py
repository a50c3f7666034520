"""State carried between the JAX package and the port, as plain data.

The FFT slice has no weights: what crosses is the input layout, the
message tables and the machine model.  Everything here takes numpy arrays
and plain Python values (never a ``repro`` object), so a test can hand the
same data to both packages:

* :func:`cyclic_scatter` / :func:`cyclic_gather` — the BSP FFT's cyclic
  input layout (process ``s`` holds ``x[s::p]``);
* :func:`unordered_to_natural` — the host-side un-shuffle of the FFT's
  unordered output;
* :func:`msgs_from_table` — port :class:`~repro_torch.core.Msg` objects
  from ``(src_pid, dst_pid, src_sid, src_off, dst_sid, dst_off, size,
  dtype_name)`` rows;
* :func:`hardware_from_fields` — a port
  :class:`~repro_torch.core.HardwareModel` from another model's
  ``dataclasses.asdict``, so both packages' ledgers can be priced on one
  machine without the port holding that machine's constants;
* :func:`params_from_jax` / :func:`params_to_numpy` — a model's
  parameters between the JAX package's ``init_params`` tree, as numpy
  arrays (``jax.tree.map(np.asarray, tree)``), and the port's
  :class:`~repro_torch.models.lm.ParamTree`;
* :func:`opt_state_from_jax` — the JAX package's AdamW state
  (``{"m", "v", "step"}``, as numpy arrays) as the port's, so both
  packages can train on from one state;
* :func:`graph_from_fields` — the port's
  :class:`~repro_torch.algorithms.graphs.PartitionedGraph` from another
  partitioned graph's ``dataclasses.asdict`` (PageRank's "weights");
* :func:`slot_from_fields`, :func:`steps_from_fields` and
  :func:`program_from_fields` — a slot handle, a recorded
  trace (:class:`~repro_torch.core.ProgramStep` list) and an optimized
  :class:`~repro_torch.core.SuperstepProgram` from ``dataclasses.asdict``
  of objects with the same fields, so both packages' optimizers,
  verifiers and executors can be handed one trace or one schedule.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np

import torch

from .algorithms.graphs import PartitionedGraph
from .core.attrs import CompressSpec, SyncAttributes
from .core.context import resolve_device
from .core.cost import SuperstepCost
from .core.machine import HardwareModel, LinkModel
from .core.memslot import Slot, as_torch_dtype
from .core.program import OptimizedStep, ProgramStep, SuperstepProgram
from .core.sync import Msg, RoundPlan, SuperstepPlan
from .models.lm import ParamTree

__all__ = ["cyclic_scatter", "cyclic_gather", "unordered_to_natural",
           "msgs_from_table", "hardware_from_fields", "params_from_jax",
           "params_to_numpy", "opt_state_from_jax", "graph_from_fields",
           "slot_from_fields", "steps_from_fields", "program_from_fields"]

Row = Tuple[int, int, int, int, int, int, int, str]


def cyclic_scatter(x_np: np.ndarray, p: int) -> np.ndarray:
    """``[p, n/p]``: row ``s`` is the cyclic slice ``x[s::p]``."""
    x_np = np.asarray(x_np)
    n = x_np.shape[0]
    return np.ascontiguousarray(x_np.reshape(n // p, p).T)


def cyclic_gather(xc: np.ndarray) -> np.ndarray:
    """Inverse of :func:`cyclic_scatter`."""
    return np.ascontiguousarray(np.asarray(xc).T).reshape(-1)


def unordered_to_natural(y_np: np.ndarray, p: int) -> np.ndarray:
    """Natural order from the FFT's unordered output (process-major
    ``[s, k1, k2_local]`` blocks) — ``k1``-major, ``k2 = s*w + k2_local``."""
    y_np = np.asarray(y_np).reshape(-1)
    n = y_np.shape[0]
    return y_np.reshape(p, p, n // (p * p)).transpose(1, 0, 2).reshape(-1)


def msgs_from_table(rows: Iterable[Row],
                    slots: Mapping[int, Tuple[int, str]]) -> List[Msg]:
    """Port messages from plain rows ``(src_pid, dst_pid, src_sid,
    src_off, dst_sid, dst_off, size, dtype_name)``; ``slots`` maps each
    slot id to ``(size, kind)``.  One :class:`Slot` is built per id, with
    the dtype its rows name (a disagreement raises)."""
    made: Dict[int, Slot] = {}

    def slot(sid: int, dtype_name: str) -> Slot:
        dtype = as_torch_dtype(dtype_name)
        s = made.get(sid)
        if s is None:
            size, kind = slots[sid]
            s = made[sid] = Slot(sid=sid, name=f"s{sid}", size=int(size),
                                 dtype=dtype, kind=kind,
                                 orig_shape=(int(size),))
        elif s.dtype != dtype:
            raise ValueError(f"slot {sid} named as {s.dtype} and {dtype}")
        return s

    return [Msg(int(src), int(dst), slot(ssid, dt), int(soff),
                slot(dsid, dt), int(doff), int(size))
            for src, dst, ssid, soff, dsid, doff, size, dt in rows]


def hardware_from_fields(fields: Mapping[str, Any]) -> HardwareModel:
    """A port hardware model from ``dataclasses.asdict`` of a model with
    the same fields (links as nested ``{"bw": ..., "latency": ...}``)."""
    f = dict(fields)
    f["links"] = {k: LinkModel(**v) if isinstance(v, Mapping) else v
                  for k, v in f["links"].items()}
    return HardwareModel(**f)


def _tensors(tree: Mapping[str, Any], dev) -> Dict[str, Any]:
    return {k: _tensors(v, dev) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in tree.items()}


def params_from_jax(tree: Mapping[str, Any], *, device="cuda",
                    trainable: bool = False) -> ParamTree:
    """The port's parameters from the JAX package's ``init_params`` tree
    as numpy arrays: the same names, and each leaf copied as it is —
    group leaves stacked ``[repeats, ...]``, matrices ``[in, out]``.
    ``trainable`` makes them require gradients."""
    return ParamTree(_tensors(tree, resolve_device(device)), trainable)


def opt_state_from_jax(state: Mapping[str, Any], *, device="cuda"
                       ) -> Dict[str, Any]:
    """The port's AdamW state from the JAX package's ``adamw_init`` /
    ``adamw_update`` state as numpy arrays: the moments ``m`` and ``v``
    as trees of tensors, ``step`` as a Python int."""
    dev = resolve_device(device)
    return {"m": _tensors(state["m"], dev), "v": _tensors(state["v"], dev),
            "step": int(np.asarray(state["step"]))}


def params_to_numpy(params: ParamTree) -> Dict[str, Any]:
    """The nested dict of numpy arrays :func:`params_from_jax` takes."""
    def conv(t):
        return {k: conv(v) if isinstance(v, dict)
                else v.detach().cpu().numpy() for k, v in t.items()}
    return conv(params.tree())


def graph_from_fields(fields: Mapping[str, Any]) -> PartitionedGraph:
    """A port partitioned graph from ``dataclasses.asdict`` of one with the
    same fields: the shard arrays copied as numpy arrays, the halo plan as
    a list of int tuples."""
    f = dict(fields)
    for k in ("row_ids", "col_ext", "vals", "pack_idx", "dangling"):
        f[k] = np.array(f[k], copy=True)
    f["msgs"] = [tuple(int(v) for v in m) for m in f["msgs"]]
    return PartitionedGraph(**f)


def _attrs_from_fields(f: Mapping[str, Any]) -> SyncAttributes:
    f = dict(f)
    if f.get("compress") is not None:
        f["compress"] = CompressSpec(**f["compress"])
    return SyncAttributes(**f)


def slot_from_fields(f: Mapping[str, Any]) -> Slot:
    """A port slot handle from ``dataclasses.asdict`` of a slot with the
    same fields (the dtype as any numpy dtype or name)."""
    return Slot(sid=int(f["sid"]), name=f["name"], size=int(f["size"]),
                dtype=as_torch_dtype(f["dtype"]), kind=f["kind"],
                orig_shape=tuple(f["orig_shape"]), gen=int(f.get("gen", 0)))


def steps_from_fields(steps: Iterable[Mapping[str, Any]]
                      ) -> List[ProgramStep]:
    """A recorded trace from ``dataclasses.asdict`` of each step of a
    trace with the same fields (``msgs`` with their nested slots,
    ``attrs``, ``label``).  One :class:`Slot` is built per (sid,
    generation), with the dtype the fields name."""
    made: Dict[Tuple[int, int], Slot] = {}

    def slot(f: Mapping[str, Any]) -> Slot:
        key = (int(f["sid"]), int(f.get("gen", 0)))
        s = made.get(key)
        if s is None:
            s = made[key] = slot_from_fields(f)
        return s

    return [ProgramStep(
        tuple(Msg(int(m["src"]), int(m["dst"]), slot(m["src_slot"]),
                  int(m["src_off"]), slot(m["dst_slot"]), int(m["dst_off"]),
                  int(m["size"]), m["origin"]) for m in st["msgs"]),
        _attrs_from_fields(st["attrs"]), st["label"]) for st in steps]


def _plan_from_fields(f: Mapping[str, Any]) -> SuperstepPlan:
    f = dict(f)
    f["cost"] = SuperstepCost(**f["cost"])
    for k in ("rounds", "valiant_phase1", "valiant_phase2"):
        f[k] = tuple(RoundPlan(tuple(r["msg_idx"]), int(r["size"]),
                               r["static_src_off"]) for r in f[k])
    f["bruck_steps"] = tuple((int(step), tuple(rows))
                             for step, rows in f["bruck_steps"])
    return SuperstepPlan(**f)


def program_from_fields(fields: Mapping[str, Any]) -> SuperstepProgram:
    """An optimized program from ``dataclasses.asdict`` of one with the
    same fields: canonical tables, attrs, plans and overlap groups as
    they are (a certificate attached to the source is not carried)."""
    f = dict(fields)
    f["steps"] = tuple(OptimizedStep(
        table=tuple(tuple(row) for row in st["table"]),
        attrs=_attrs_from_fields(st["attrs"]), label=st["label"],
        plan=_plan_from_fields(st["plan"]),
        merged_from=tuple(st["merged_from"]), unchanged=st["unchanged"],
        rewrite=st["rewrite"]) for st in f["steps"])
    f["overlap_groups"] = tuple(tuple(g) for g in f["overlap_groups"])
    f["in_order_costs"] = tuple(SuperstepCost(**c)
                                for c in f["in_order_costs"])
    return SuperstepProgram(**f)
