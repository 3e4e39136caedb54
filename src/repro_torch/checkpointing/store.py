"""Fault-tolerant checkpointing, numpy-backed with an async writer (port of
``repro/checkpointing/store.py``).

Layout — one directory per step, one ``.npy`` per pytree leaf plus a
manifest; the reference's format byte for byte, so a tree saved by either
package restores in the other:

  <dir>/step_000123/
      MANIFEST.json       {"step": 123, "leaves": {path: {file, dtype, shape}}}
      <sanitized-path>.npy
      COMMITTED           written last — a step directory without it is torn
                          and ignored by ``latest_step`` / ``restore``

A leaf's path joins its pytree keys with ``/`` (dict keys, sequence
indices, attribute names), as the reference's does.  A dtype numpy lacks
(bf16, the float8s) is stored as its raw bytes, shape ``shape + (itemsize,)``
of uint8, with its name in the manifest.

Crash-safety: writes land in ``step_<n>.tmp`` and are renamed into place
after the COMMITTED marker is written, so a process killed mid-save never
corrupts the restore path (restart picks the previous committed step).
``AsyncCheckpointer`` runs saves on a worker thread; ``wait()`` drains it.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

_STEP_RE = re.compile(r"^step_(\d{9})$")
#: dtypes numpy holds natively; others are stored as raw bytes
_NUMPY_DTYPES = {torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.float16, torch.float32, torch.float64, torch.complex64,
                 torch.complex128}


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


def atomic_write_json(path: str, obj: Any) -> None:
    """Crash-safe JSON write: temp file + atomic rename (same protocol as the
    step-directory commit below, shared with core.plan_cache's disk store)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str) -> Optional[Any]:
    """Read a JSON file; None when missing or torn (partial/corrupt write).

    ValueError covers both JSONDecodeError and the UnicodeDecodeError a
    non-UTF-8 corrupted file raises before the JSON parser even runs.
    """
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    out = []
    for kp, leaf in pytree.tree_flatten_with_path(tree)[0]:
        keys = []
        for p in kp:
            if hasattr(p, "key"):
                keys.append(str(p.key))
            elif hasattr(p, "idx"):
                keys.append(str(p.idx))
            elif hasattr(p, "name"):
                keys.append(str(p.name))
            else:
                keys.append(str(p))
        out.append(("/".join(keys), leaf))
    return out


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of one leaf as a numpy array and its dtype's name; a
    dtype numpy lacks becomes its raw bytes.  Tensors are always copied, so
    the caller may update them in place right after."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _NUMPY_DTYPES:
        return t.numpy(), name
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    return raw.numpy().reshape(tuple(t.shape) + (t.element_size(),)), name


def _host_tree(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    return [(path, *_host_array(leaf)) for path, leaf in _leaf_paths(tree)]


def _write(base_dir: str, step: int, leaves: List[Tuple[str, np.ndarray, str]]) -> str:
    os.makedirs(base_dir, exist_ok=True)
    final = os.path.join(base_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for path, arr, dtype in leaves:
        fname = _sanitize(path) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        shape = arr.shape if str(arr.dtype) == dtype else arr.shape[:-1]
        manifest["leaves"][path] = {"file": fname, "dtype": dtype, "shape": list(shape)}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(base_dir: str, step: int, tree: Any) -> str:
    """Synchronous committed save; returns the final step directory."""
    return _write(base_dir, step, _host_tree(tree))


def latest_step(base_dir: str) -> Optional[int]:
    """Largest committed step, or None. Torn (.tmp / uncommitted) dirs skipped."""
    if not os.path.isdir(base_dir):
        return None
    best = None
    for name in os.listdir(base_dir):
        m = _STEP_RE.match(name)
        if not m:
            continue
        if not os.path.exists(os.path.join(base_dir, name, "COMMITTED")):
            continue
        s = int(m.group(1))
        best = s if best is None else max(best, s)
    return best


def restore(base_dir: str, step: int, like: Any,
            device: Union[str, torch.device, None] = None) -> Any:
    """Restore a pytree of tensors; ``like`` provides the structure (leaves
    ignored).  Leaves land on ``device`` (default: the CPU).  The reference
    places each leaf on a sharding instead; the on-disk format is the
    same."""
    d = os.path.join(base_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves = []
    for path, _ in _leaf_paths(like):
        entry = manifest["leaves"].get(path)
        if entry is None:
            raise KeyError(f"checkpoint at step {step} is missing leaf {path!r}")
        arr = np.load(os.path.join(d, entry["file"]))
        want, shape = entry["dtype"], tuple(entry["shape"])
        if str(arr.dtype) == want:
            t = torch.from_numpy(arr)
        else:  # raw bytes of a dtype numpy lacks: view back via the manifest
            raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1))
            t = raw.view(getattr(torch, want)).reshape(shape)
        leaves.append(t if device is None else t.to(device))
    return pytree.tree_unflatten(leaves, pytree.tree_structure(like))


def retain(base_dir: str, keep: int) -> None:
    """Garbage-collect all but the newest ``keep`` committed steps."""
    if not os.path.isdir(base_dir):
        return
    steps = sorted(
        int(m.group(1))
        for name in os.listdir(base_dir)
        if (m := _STEP_RE.match(name))
        and os.path.exists(os.path.join(base_dir, name, "COMMITTED"))
    )
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(base_dir, f"step_{s:09d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread writer overlapping serialization/disk I/O with the
    next training steps.

    ``save_async`` copies the tree to host memory *on the caller thread*
    before it returns (the port's AdamW updates parameters and moments in
    place, so the next step would race a writer reading the live tensors)
    and enqueues the copies; the worker thread only does file I/O.
    """

    def __init__(self, base_dir: str, keep: int = 3):
        self.base_dir = base_dir
        self.keep = keep
        self._q: "queue.Queue[Optional[Tuple[int, Any]]]" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, leaves = item
            try:
                _write(self.base_dir, step, leaves)
                retain(self.base_dir, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._err = e
            finally:
                self._q.task_done()

    def save_async(self, step: int, tree: Any) -> None:
        if self._err is not None:
            raise self._err
        self._q.put((step, _host_tree(tree)))

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
