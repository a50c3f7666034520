"""Persistent, shareable program cache — pMR's persistent communication
objects taken literally.

Program signatures are canonical and process-independent (slots renamed
by first occurrence across the canonically ordered trace), so an
optimized :class:`repro_torch.core.program.SuperstepProgram` — the
searched schedule, every superstep's
:class:`repro_torch.core.sync.SuperstepPlan`, and the schedule verifier's
certificate — is valid in *any* process that records the same program.
This module serialises those cache entries to a directory so the
"proven optimal once, valid forever" wins survive restarts: a restarted
worker pays zero re-planning and zero schedule-search cost.

On-disk format (one file per entry, ``prog_<keyhash>.lpfc``), the JAX
package's, with the framework version under ``"torch"``::

    {"magic": ..., "format": 1, "torch": ..., "payload_bytes": N,
     "payload_sha256": ...}\\n
    <N bytes of JSON payload: {"key", "program", "certificate"}>

The entry filename and the payload encoding equal the JAX package's for
the same key; the header's framework field differs, so an entry written
by one package loads in the other as ``invalid`` (version skew), never
as a hit.

The payload is a *structured* encoding (tagged tuples + a closed
registry of the IR dataclasses), not a pickle: nothing executable is
ever loaded from the cache directory.  Writes are atomic (temp file +
``os.replace``), so a crash mid-write never corrupts an entry.

Trust model — a loaded entry is *advisory*, never authoritative:

* the header is validated before the payload is parsed — a format or
  torch version skew degrades to a cold miss (``invalidated`` counter);
* the payload checksum catches truncation and bit-flips;
* the stored key must equal the requested key (hash-collision /
  renamed-file defence);
* and above all, :class:`repro_torch.core.program.ProgramCache` re-runs
  ``verify_program`` on every loaded entry against the *actual* recorded
  trace before the program may execute or be captured — a stale or
  adversarial entry can cost a re-optimization, never a wrong schedule.

:func:`steps_from_signature` reconstructs a synthetic recorded trace
from a persisted canonical signature, which is what lets
``python -m repro_torch.analysis --cache-dir`` re-verify a cache
offline, with no recording process around.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Hashable, List, Optional, Tuple

from . import faultpoints as _fp
from .attrs import CompressSpec, SyncAttributes
from .cost import SuperstepCost
from .memslot import Slot, as_torch_dtype
from .sync import Msg, RoundPlan, SuperstepPlan

__all__ = ["FORMAT_VERSION", "MAGIC", "PersistError", "PersistentStore",
           "entry_filename", "steps_from_signature"]

#: bump on any change to the payload encoding or to the meaning of the
#: persisted IR; old entries then degrade to cold misses
FORMAT_VERSION = 1

MAGIC = "lpf-program-cache"

_SUFFIX = ".lpfc"


class PersistError(Exception):
    """An entry failed to encode/decode — callers degrade to a cold miss,
    they never propagate this to the execution path."""


def _torch_version() -> str:
    import torch
    return torch.__version__


# ==========================================================================
# the structured codec: tagged tuples + a closed dataclass registry
# ==========================================================================

def _codec_types():
    # program.py imports this module's consumers; resolve lazily to keep
    # the import graph acyclic
    from .program import OptimizedStep, SuperstepProgram
    from ..analysis.verifier import VerifierReport
    return {cls.__name__: cls for cls in (
        SyncAttributes, CompressSpec, SuperstepCost, SuperstepPlan,
        RoundPlan, OptimizedStep, SuperstepProgram, VerifierReport)}


def _encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (tuple, list)):
        return {"__t__": [_encode(x) for x in obj]}
    if dataclasses.is_dataclass(obj) and \
            type(obj).__name__ in _codec_types():
        fields = {}
        for f in dataclasses.fields(obj):
            if f.name == "diagnostics":
                # a persisted certificate is always a passing one (the
                # store refuses failed certs); Diagnostic carries live
                # Msg/Slot handles and has no business on disk
                fields[f.name] = {"__t__": []}
            else:
                fields[f.name] = _encode(getattr(obj, f.name))
        return {"__dc__": type(obj).__name__, "fields": fields}
    raise PersistError(f"cannot persist {type(obj).__name__}")


def _decode(doc: Any) -> Any:
    if doc is None or isinstance(doc, (bool, int, float, str)):
        return doc
    if isinstance(doc, dict) and "__t__" in doc and len(doc) == 1:
        return tuple(_decode(x) for x in doc["__t__"])
    if isinstance(doc, dict) and doc.keys() == {"__dc__", "fields"}:
        cls = _codec_types().get(doc["__dc__"])
        if cls is None:
            raise PersistError(f"unknown persisted type {doc['__dc__']!r}")
        kwargs = {f.name: _decode(doc["fields"][f.name])
                  for f in dataclasses.fields(cls)
                  if f.name in doc["fields"]}
        return cls(**kwargs)
    raise PersistError(f"malformed payload node {type(doc).__name__}")


def _key_text(obj: Any) -> str:
    """Deterministic textual form of a cache key (the canonical program
    signature plus the machine's (g, l)) — what the entry filename
    hashes.  Keys are nested tuples of primitives; the one structured
    leaf, :class:`CompressSpec`, is normalised explicitly."""
    if isinstance(obj, tuple):
        return "(" + ",".join(_key_text(x) for x in obj) + ")"
    if isinstance(obj, CompressSpec):
        return f"CompressSpec({obj.bits},{obj.stochastic})"
    if obj is None or isinstance(obj, (bool, int, str, float)):
        return repr(obj)
    raise PersistError(f"unsupported key element {type(obj).__name__}")


def entry_filename(key: Hashable) -> str:
    """Stable entry filename for a cache key: ``prog_<sha256/40>.lpfc``."""
    digest = hashlib.sha256(_key_text(key).encode()).hexdigest()[:40]
    return f"prog_{digest}{_SUFFIX}"


# ==========================================================================
# signature -> synthetic recorded trace (offline re-verification)
# ==========================================================================

def steps_from_signature(sig: Hashable):
    """Reconstruct ``(p, steps, scratch)`` from a canonical
    :func:`repro_torch.core.program.program_signature`.

    The signature *is* the recorded program in canonical form — p, the
    scratch descriptor, every slot's (size, dtype, kind), and each step's
    attributes + message table over canonical slot indices — so a
    synthetic trace built from it is signature-identical to the original
    recording.  That is what lets the analysis CLI re-run the schedule
    verifier over a persisted cache with no recording process around."""
    from .program import ProgramStep
    p, scratch_sig, descrs, step_sigs = sig
    slots = [Slot(sid=i, name=f"c{i}", size=size, dtype=as_torch_dtype(dt),
                  kind=kind, orig_shape=(size,))
             for i, (size, dt, kind) in enumerate(descrs)]
    scratch = None
    if scratch_sig is not None:
        size, dt = scratch_sig
        scratch = Slot(sid=len(slots), name="__scratch", size=size,
                       dtype=as_torch_dtype(dt), kind="global",
                       orig_shape=(size,))
    steps = []
    for i, (akey, table) in enumerate(step_sigs):
        method, no_conflict, reduce_op, compress, stale, seed = akey
        attrs = SyncAttributes(method=method, no_conflict=no_conflict,
                               reduce_op=reduce_op, compress=compress,
                               stale=stale, valiant_seed=seed)
        msgs = tuple(Msg(src, dst, slots[si], soff, slots[di], doff, sz,
                         origin=origin)
                     for (src, dst, si, soff, di, doff, sz, origin)
                     in table)
        steps.append(ProgramStep(msgs, attrs, f"step[{i}]"))
    return int(p), steps, scratch


# ==========================================================================
# the store
# ==========================================================================

class PersistentStore:
    """One directory of ``prog_*.lpfc`` entries with atomic writes and
    classified loads (``hit`` / ``miss`` / ``invalid`` / ``error``)."""

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: Hashable) -> str:
        return os.path.join(self.directory, entry_filename(key))

    def __len__(self) -> int:
        try:
            return len(self.filenames())
        except OSError:
            return 0

    def filenames(self) -> List[str]:
        """Sorted entry filenames currently on disk (the warm-load index:
        entries deserialize + re-verify lazily, on first use)."""
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("prog_") and f.endswith(_SUFFIX))

    # ------------------------------------------------------------------
    def save(self, key: Hashable, prog, cert) -> str:
        """Atomically persist one verified entry; returns its path.
        Refuses certificates that are missing or failed — the disk only
        ever holds schedules that verified in some process (and will be
        re-verified in every process that loads them)."""
        if cert is None or not getattr(cert, "ok", False):
            raise PersistError("refusing to persist an unverified or "
                               "failed-verification program")
        _fp.fire("persist_save", directory=self.directory)
        payload = json.dumps({
            "key": _encode(key),
            "program": _encode(prog),
            "certificate": _encode(cert),
        }, separators=(",", ":")).encode()
        header = json.dumps({
            "magic": MAGIC,
            "format": FORMAT_VERSION,
            "torch": _torch_version(),
            "payload_bytes": len(payload),
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
        }, separators=(",", ":")).encode()
        path = self._path(key)
        tmp = os.path.join(self.directory,
                           f".tmp_{os.path.basename(path)}.{os.getpid()}")
        try:
            with open(tmp, "wb") as fh:
                fh.write(header + b"\n" + payload)
            os.replace(tmp, path)
        except BaseException:
            # a failed write (full disk, read-only dir) must not strand a
            # temp file next to the live entries
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path

    # ------------------------------------------------------------------
    def _read(self, path: str, key: Optional[Hashable] = None
              ) -> Tuple[Hashable, Any, Any]:
        """Decode one entry file; raises :class:`PersistError` on any
        corruption, version skew, or (with ``key``) signature mismatch."""
        with open(path, "rb") as fh:
            blob = fh.read()
        # fault seam: an armed plan may raise OSError here (I/O error) or
        # hand back a truncated / bit-flipped blob, which the header and
        # checksum validation below must catch
        blob = _fp.corrupt("persist_load", blob)
        nl = blob.find(b"\n")
        if nl < 0:
            raise PersistError("truncated header")
        try:
            header = json.loads(blob[:nl])
        except ValueError as e:
            raise PersistError(f"malformed header: {e}")
        if not isinstance(header, dict) or header.get("magic") != MAGIC:
            raise PersistError("bad magic")
        if header.get("format") != FORMAT_VERSION:
            raise PersistError(
                f"format version skew: entry {header.get('format')!r}, "
                f"runtime {FORMAT_VERSION}")
        if header.get("torch") != _torch_version():
            raise PersistError(
                f"torch version skew: entry {header.get('torch')!r}, "
                f"runtime {_torch_version()!r}")
        payload = blob[nl + 1:]
        if len(payload) != header.get("payload_bytes"):
            raise PersistError(
                f"truncated payload: {len(payload)} bytes, header says "
                f"{header.get('payload_bytes')}")
        if hashlib.sha256(payload).hexdigest() != \
                header.get("payload_sha256"):
            raise PersistError("payload checksum mismatch")
        try:
            doc = json.loads(payload)
            stored_key = _decode(doc["key"])
            prog = _decode(doc["program"])
            cert = _decode(doc["certificate"])
        except (PersistError, KeyError, TypeError, ValueError) as e:
            raise PersistError(f"malformed payload: {e}")
        from .program import SuperstepProgram
        if not isinstance(prog, SuperstepProgram):
            raise PersistError("payload is not a SuperstepProgram entry")
        if entry_filename(stored_key) != os.path.basename(path):
            raise PersistError("entry filename does not match its key "
                               "(renamed or colliding entry)")
        if key is not None and stored_key != key:
            raise PersistError("signature mismatch: stored key differs "
                               "from the requested key")
        return stored_key, prog, cert

    def filename(self, key: Hashable) -> Optional[str]:
        """The entry filename ``key`` maps to, or ``None`` for a key that
        cannot be textualised (and so was never stored)."""
        try:
            return entry_filename(key)
        except PersistError:
            return None

    def load(self, key: Hashable) -> Tuple[str, Optional[Tuple[Any, Any]]]:
        """Classified lookup: ``("hit", (program, certificate))``,
        ``("miss", None)`` when no entry exists for the key,
        ``("invalid", None)`` when one exists but fails an integrity,
        version, or key check (the caller invalidates it and cold-builds),
        or ``("error", None)`` on a *transient* I/O failure — the entry
        itself may be fine, so the caller must NOT invalidate it; it
        retries or degrades to a cold miss."""
        try:
            path = self._path(key)
        except PersistError:
            return "miss", None     # unhashable-to-text key: never stored
        if not os.path.exists(path):
            return "miss", None
        try:
            _, prog, cert = self._read(path, key=key)
            return "hit", (prog, cert)
        except PersistError:
            return "invalid", None
        except OSError:
            return "error", None

    def invalidate(self, key: Hashable) -> bool:
        """Best-effort removal of a bad entry so it is not re-tried.
        Returns True iff the entry is gone afterwards — False (a
        read-only cache dir, say) tells the caller to poison the entry in
        memory instead, or it would re-pay decode + re-verify on every
        miss."""
        try:
            path = self._path(key)
        except PersistError:
            return True
        try:
            os.remove(path)
        except FileNotFoundError:
            return True
        except OSError:
            return not os.path.exists(path)
        return True

    def entries(self):
        """Iterate the whole store for offline analysis: yields
        ``(filename, error, key, program, certificate)`` — ``error`` is
        ``None`` for a well-formed entry, else the failure reason (and the
        remaining fields are ``None``)."""
        for fname in self.filenames():
            path = os.path.join(self.directory, fname)
            try:
                key, prog, cert = self._read(path)
                yield fname, None, key, prog, cert
            except (PersistError, OSError) as e:
                yield fname, str(e), None, None, None
