"""Atomic, keep-k, async checkpointing in the JAX package's format.

The port of ``repro/checkpoint/store.py``, with the same contract:

* **atomic** — a save writes ``step_XXXXXXXX.tmp`` and ``os.replace``\\ s it
  into place only after every leaf and the manifest are flushed, so a crash
  in the middle never corrupts the latest checkpoint;
* **keep-k** — after a save, all but the newest ``keep`` checkpoints go;
* **async** — :class:`AsyncCheckpointer` copies the tree to host memory on
  the caller's thread and writes it on a background thread; the loop waits
  only when a previous save is still in flight (one outstanding save);
* **one writer** — only ``process_index == 0`` writes.

The format is the reference's: one ``leaves.npz`` and a ``manifest.json``
of leaf paths, shapes and dtypes, the paths joined by ``/`` over the sorted
keys, and an FRSZ2 ``BlockCompressed`` leaf as its two children ``0``
(codes) and ``1`` (exponents).  Codes are held as the reference holds them
(``uint16`` for l = 16, where the port has ``int16`` views of the same
bits); a bf16 leaf is stored as the reference's npz holds one, two raw
bytes a value (``|V2``, its manifest dtype ``bfloat16``), so a checkpoint
of either package restores in the other, bit for bit.  ``restore`` takes a
``device`` where the reference takes ``shardings``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.frsz2 import BlockCompressed
from repro_torch.tree import leaves_with_paths, tree_map

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_MANIFEST = "manifest.json"
_DATA = "leaves.npz"
#: code containers and the unsigned type the reference holds them in
_UNSIGNED = {torch.int16: np.uint16, torch.int32: np.uint32,
             torch.int64: np.uint64}


def _leaf_to_numpy(path: str, t: torch.Tensor) -> tuple[np.ndarray, str]:
    """-> (the array as the reference's npz holds it, its manifest dtype)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    if path.endswith("/0") and t.dtype in _UNSIGNED:   # FRSZ2 codes
        a = a.view(_UNSIGNED[t.dtype])
    return a, str(a.dtype)


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {k: _leaf_to_numpy(k, v) for k, v in leaves_with_paths(tree)}


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save(root: str, step: int, tree: Any, *, keep: int = 3,
         process_index: int = 0) -> str:
    """Atomically persist ``tree`` at ``root/step_XXXXXXXX``."""
    if process_index != 0:
        return _step_dir(root, step)
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten(tree)
    np.savez(os.path.join(tmp, _DATA), **{k: a for k, (a, _) in leaves.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": dt}
                   for k, (a, dt) in leaves.items()},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(root, keep)
    return final


def _gc(root: str, keep: int):
    steps = sorted(_list_steps(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def _list_steps(root: str):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(root: str):
    steps = _list_steps(root)
    return max(steps) if steps else None


def _to_tensor(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype: bf16 and code bits
    viewed (a bf16 leaf is stored as 2 raw bytes, codes as unsigned), any
    other dtype cast, as the reference's ``astype``."""
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    if like.dtype == torch.bfloat16 and arr.dtype.kind in "Vu" \
            and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif (like.dtype in _UNSIGNED and arr.dtype.kind == "u"
          and arr.dtype.itemsize == like.element_size()):
        t = torch.from_numpy(arr.view(np.dtype(f"i{arr.dtype.itemsize}")))
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device if device is None else device)


def restore(root: str, like: Any, *, step: int | None = None, device=None):
    """Load a checkpoint into the structure of ``like`` -> (step, tree).

    Each leaf takes ``like``'s dtype, and its device (or ``device``); a
    ``BlockCompressed`` leaf of ``like`` gives its ``n`` and spec.
    """
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    with np.load(os.path.join(d, _DATA)) as z:
        data = {k: z[k] for k in z.files}

    def load(key, leaf):
        arr = data[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        return _to_tensor(arr, leaf, device)

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, BlockCompressed):
            return BlockCompressed(codes=load(prefix + "0", node.codes),
                                   exps=load(prefix + "1", node.exps),
                                   n=node.n, spec=node.spec)
        return load(prefix[:-1], node)

    return step, rebuild(like, "")


def _to_host(leaf):
    if isinstance(leaf, BlockCompressed):
        return BlockCompressed(codes=leaf.codes.detach().cpu(),
                               exps=leaf.exps.detach().cpu(), n=leaf.n,
                               spec=leaf.spec)
    return leaf.detach().cpu()


class AsyncCheckpointer:
    """One-outstanding-save async writer with a wait barrier."""

    def __init__(self, root: str, *, keep: int = 3, process_index: int = 0):
        self.root = root
        self.keep = keep
        self.process_index = process_index
        self._thread: threading.Thread | None = None
        self.last_error: BaseException | None = None

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = tree_map(_to_host, tree)     # snapshot before async

        def work():
            try:
                save(self.root, step, host_tree, keep=self.keep,
                     process_index=self.process_index)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
