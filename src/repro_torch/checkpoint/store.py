"""Checkpointing: atomic, async-capable — the JAX package's
``repro.checkpoint.store`` for the port's trees.

Layout::

    <dir>/step_<n>/
        manifest.json        leaf names, shapes, dtypes, meta
        leaf_<i>.npy         one array per leaf

A tree is any nesting of dicts, tuples, lists and ``ParamTree`` objects
over tensors and Python ints (a training state is ``(params, opt)``).
Leaves are named by their path (``0/embed``, ``1/m/embed``, ``1/step``).
bf16 tensors, which numpy lacks, are stored as their int16 bit patterns
and named ``bfloat16`` in the manifest.

Writes go to a temp dir and are renamed into place (atomic publish), so a
crash mid-save never corrupts the latest checkpoint; ``latest_step`` only
sees published steps, and every save sweeps ``.tmp_step_*`` dirs a crash
left behind.  ``AsyncCheckpointer`` copies the tree to the host on the
caller's thread and serialises it on a worker thread.  ``restore`` puts
the tensors on the caller's device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.context import resolve_device
from ..models.lm import ParamTree

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in a fixed order."""
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(like: Any, leaves: dict, prefix: str = "") -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    sub = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, ParamTree):
        trainable = any(p.requires_grad for p in like.parameters())
        return ParamTree(_unflatten(like.tree(), leaves, prefix), trainable)
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, sub(k)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, sub(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(int(leaf), np.int64), "int"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")


def _sweep_stale_tmp(directory: str, keep: Optional[str] = None) -> None:
    """Remove crash-abandoned ``.tmp_step_*`` staging dirs.  A temp dir
    only exists while a save is in flight (it is renamed into place on
    publish), so any found here — other than ``keep``, the one the
    caller is about to write — was orphaned by a crash and would
    otherwise accumulate forever (``_gc`` only matches ``step_*``)."""
    if not os.path.isdir(directory):
        return
    for d in os.listdir(directory):
        if d.startswith(".tmp_step_") and d != keep:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def save(directory: str, step: int, tree: Any, meta: Optional[dict] = None
         ) -> str:
    """Synchronous atomic save.  Returns the published path."""
    flat = _flatten(tree)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    _sweep_stale_tmp(directory, keep=os.path.basename(tmp))
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "n_leaves": len(flat), "leaves": [],
                "meta": meta or {}}
    for i, (name, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                   "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, step: int, like: Any, device=None) -> Any:
    """Restore onto the structure of ``like`` (tensors, possibly on the
    meta device, give names, shapes and dtypes).  Tensors land on
    ``device``, or where ``like``'s leaf lives when that is not meta."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like)
    names = [e["name"] for e in manifest["leaves"]]
    if names != [n for n, _ in flat_like]:
        raise ValueError(
            f"checkpoint has {len(names)} leaves, target structure has "
            f"{len(flat_like)}, or their names differ — config mismatch")
    leaves = {}
    for i, ((name, ref), entry) in enumerate(zip(flat_like,
                                                 manifest["leaves"])):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        if not isinstance(ref, torch.Tensor):
            leaves[name] = int(arr)
            continue
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {name}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        dev = resolve_device(device if device is not None else ref.device)
        if dev.type == "meta":
            raise ValueError("restore onto a meta-device structure needs "
                             "device=")
        leaves[name] = t.to(device=dev, dtype=ref.dtype)
    return _unflatten(like, leaves)


class AsyncCheckpointer:
    """Overlaps serialisation with training; keeps the last K steps."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        # copy to the host on the caller thread (device ordering), write
        # on a worker
        host = [(n, l.detach().to("cpu", copy=True)
                 if isinstance(l, torch.Tensor) else l)
                for n, l in _flatten(tree)]

        def work():
            try:
                save(self.directory, step, dict(host), meta)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like: Any, device=None):
        """Restore the newest *published* checkpoint: returns
        ``(step, tree)``, or ``(None, None)`` when the directory holds
        no published step.  Waits for any in-flight save first, so the
        recovery path (``train_loop``'s step supervisor) never races
        its own publisher."""
        self.wait()
        last = latest_step(self.directory)
        if last is None:
            return None, None
        return last, restore(self.directory, last, like, device=device)

    def _gc(self):
        _sweep_stale_tmp(self.directory)
        steps = sorted(int(d.split("_")[1])
                       for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        # NOT steps[:-self.keep]: with keep=0 that is the empty slice
        # (nothing would ever be deleted) instead of "keep none"; the
        # max() guard keeps the bound non-negative when fewer than
        # ``keep`` checkpoints exist (a negative bound would slice from
        # the end and delete the oldest ones)
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
