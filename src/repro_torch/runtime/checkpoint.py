"""Atomic, optionally-async checkpointing.

Port of ``repro.runtime.checkpoint``, in its layout, so a checkpoint
written by either package restores in the other:

    <dir>/step_00000420/
        manifest.json        — path -> (file, shape, dtype) + step
        <leaf-000>.npy ...   — one file per tree leaf, its raw bytes as uint8

Leaf paths are the reference's (``repro_torch.utils.tree``: dict keys,
list indices, a QTensor's ``0`` / ``1``).  Every leaf is written as its raw
bytes; a bf16 tensor is recorded under dtype ``"bfloat16"`` and read back
with ``torch.frombuffer`` — no ``ml_dtypes`` needed.  Writes go to
``<dir>/.tmp-<step>-<n>`` and are atomically renamed into place, so a crash
mid-save never corrupts the latest checkpoint.  ``save_checkpoint(...,
blocking=False)`` copies the leaves to the host in the caller and writes
the files on a background thread; ``wait_for_saves`` joins them.

Restore returns tensors on each template leaf's device (or ``device``):
the counterpart of the reference's restore-with-resharding on one card.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten_with_path, tree_unflatten

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "gc_checkpoints",
    "wait_for_saves",
]

_MANIFEST = "manifest.json"
_lock = threading.Lock()
_pending: list[tuple[threading.Thread, list]] = []  # (thread, error box)
_inflight: set[str] = set()                         # abs tmp dirs being written
_tmp_counter = itertools.count()

# manifest dtype names (numpy's, as the reference writes them) <-> torch
_DTYPES = {"float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
           "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
           "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _host_bytes(x) -> tuple[bytes, list[int], str]:
    """(raw bytes, shape, manifest dtype name) of a tensor or array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes(), list(t.shape), _NAMES[t.dtype]
    a = np.asarray(x)
    return a.tobytes(), list(a.shape), str(a.dtype)


def _write(
    dirpath: str, step: int, flat: list[tuple[str, tuple]], tmp: str | None = None
) -> str:
    # unique tmp per write: two saves of the same step (async + final
    # blocking, a retried save) must never share a staging dir
    tmp = tmp or os.path.join(dirpath, f".tmp-{step}-{next(_tmp_counter)}")
    final = os.path.join(dirpath, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for i, (name, (raw, shape, dtype)) in enumerate(flat):
        fname = f"leaf-{i:05d}.npy"
        np.save(os.path.join(tmp, fname), np.frombuffer(raw, np.uint8))
        manifest["leaves"][name] = {"file": fname, "shape": shape, "dtype": dtype}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # pragma: no cover - overwrite same step
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(dirpath: str, step: int, tree: Any, blocking: bool = True) -> str:
    """Serialize ``tree`` under ``dirpath`` for ``step`` (atomic rename)."""
    os.makedirs(dirpath, exist_ok=True)
    flat = [(path, _host_bytes(x)) for path, x in tree_flatten_with_path(tree)]
    if blocking:
        return _write(dirpath, step, flat)
    tmp = os.path.abspath(os.path.join(dirpath, f".tmp-{step}-{next(_tmp_counter)}"))

    def run(box: list) -> None:
        try:
            _write(dirpath, step, flat, tmp=tmp)
        except BaseException as e:  # noqa: BLE001 - re-raised from wait_for_saves
            box.append(e)
        finally:
            with _lock:
                _inflight.discard(tmp)

    box: list = []
    t = threading.Thread(target=run, args=(box,), daemon=True)
    with _lock:
        _inflight.add(tmp)
        _pending.append((t, box))
    t.start()
    return os.path.join(dirpath, f"step_{step:08d}")


def wait_for_saves() -> None:
    """Join all in-flight async saves; re-raise the first background error.

    A failed write must not masquerade as a saved checkpoint: any exception
    captured on a save thread surfaces here (remaining threads are still
    joined first, so no writer is left running)."""
    with _lock:
        pending, _pending[:] = _pending[:], []
    errors: list[BaseException] = []
    for t, box in pending:
        t.join()
        errors.extend(box)
    if errors:
        raise errors[0]


def latest_step(dirpath: str) -> int | None:
    if not os.path.isdir(dirpath):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(dirpath)
        if d.startswith("step_") and os.path.exists(os.path.join(dirpath, d, _MANIFEST))
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    dirpath: str,
    template: Any,
    step: int | None = None,
    device=None,
) -> tuple[int, Any]:
    """Load into the structure of ``template`` (tensors and QTensors): each
    leaf as a tensor of the stored dtype on ``device``, else on its template
    leaf's device."""
    step = step if step is not None else latest_step(dirpath)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {dirpath}")
    cdir = os.path.join(dirpath, f"step_{step:08d}")
    with open(os.path.join(cdir, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = []
    for name, tmpl in tree_flatten_with_path(template):
        entry = manifest["leaves"].get(name)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        raw = np.load(os.path.join(cdir, entry["file"])).tobytes()
        dtype = _DTYPES[entry["dtype"]]
        t = (torch.frombuffer(bytearray(raw), dtype=dtype) if raw
             else torch.empty(0, dtype=dtype)).reshape(entry["shape"])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != template {tuple(tmpl.shape)}")
        leaves.append(t.to(device if device is not None else tmpl.device))
    return step, tree_unflatten(template, leaves)


def gc_checkpoints(dirpath: str, keep: int = 3) -> list[int]:
    """Delete all but the newest ``keep`` *complete* checkpoints.

    Only dirs with a manifest (the same completeness predicate as
    ``latest_step``) count toward ``keep`` — an interrupted write must not
    shadow a complete checkpoint out of the retention window.  Incomplete
    ``step_*`` dirs and orphaned ``.tmp-<step>`` dirs are swept
    unconditionally, except for ``.tmp`` dirs belonging to still-running
    async saves."""
    if not os.path.isdir(dirpath):
        return []
    complete, incomplete = [], []
    for d in os.listdir(dirpath):
        if d.startswith("step_"):
            s = int(d.split("_")[1])
            if os.path.exists(os.path.join(dirpath, d, _MANIFEST)):
                complete.append(s)
            else:
                incomplete.append(d)
    dropped = sorted(complete)[:-keep] if keep > 0 else sorted(complete)
    for s in dropped:
        shutil.rmtree(os.path.join(dirpath, f"step_{s:08d}"), ignore_errors=True)
    for d in incomplete:
        shutil.rmtree(os.path.join(dirpath, d), ignore_errors=True)
    with _lock:
        inflight = set(_inflight)
    for d in os.listdir(dirpath):
        if not d.startswith(".tmp-"):
            continue
        if os.path.abspath(os.path.join(dirpath, d)) in inflight:
            continue  # an async save is mid-write here; it renames on finish
        shutil.rmtree(os.path.join(dirpath, d), ignore_errors=True)
    return dropped
