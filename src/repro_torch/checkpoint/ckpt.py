"""Checkpointing (the reference's ``repro.checkpoint.ckpt``): sharded-npz
snapshots with a manifest, atomic publish, and an async writer thread.

Layout:  <dir>/step_<N:08d>/shard_<i:05d>.npz + manifest.json, published by
writing to step_<N>.tmp.<pid> and renaming it: a reader never sees a
partial checkpoint, and a crash mid-save leaves the previous step intact.

Leaves are keyed as the reference keys them: "/"-joined dict keys and
list / tuple indices, a NamedTuple field as ".name" (JAX's attribute key).
So a checkpoint written by the JAX package restores into the same tree of
the port, and one written here restores there. bf16 has no numpy dtype: a
bf16 leaf is stored as its 16-bit pattern (uint16) with "bfloat16" in the
manifest, and restored bit for bit (a JAX bf16 leaf, stored under the same
name, restores the same way).

``restore_checkpoint`` returns CPU tensors; the caller places them (the
trainer copies them into its tensors on the card, so the training state
never exists twice there).

A full-width training state is tens of GB, so shards are cut by bytes as
well as by leaf count, and written (``np.savez``) and read (``np.load``)
by a pool of threads.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = ""):
    """(key, leaf) pairs in JAX pytree order; None is an empty node."""
    if tree is None:
        return
    if isinstance(tree, dict):
        children = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = ((f".{f}", v) for f, v in zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        children = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _items(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(tree, values, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by values[its key]."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values, f"{prefix}/.{f}" if prefix else f".{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return values[prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to store, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)        # (never 0-d: those are contiguous)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_SHARD_BYTES = 1 << 30           # a shard closes once it holds this many bytes
_IO_THREADS = 8


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    np.savez(path, **arrays)


def _read_npz(path: str, names: List[str]) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {name: z[name] for name in names}


def save_checkpoint(directory: str, step: int, tree, *, shard_size: int = 128,
                    extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic checkpoint write of a tree of tensors / arrays. Returns the
    published path. A shard holds at most ``shard_size`` leaves and closes
    once it passes 1 GiB."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": [], "extra": extra_meta or {}}
    shards: List[Dict[str, np.ndarray]] = [{}]
    nbytes = 0
    for i, (key, leaf) in enumerate(_items(tree)):
        arr, dtype = _to_numpy(leaf)
        safe = f"leaf_{i:06d}"          # npz keys cannot hold '/'
        manifest["leaves"].append({"key": key, "npz_key": safe, "shard": len(shards) - 1,
                                   "shape": list(arr.shape), "dtype": dtype})
        shards[-1][safe] = arr
        nbytes += arr.nbytes
        if len(shards[-1]) >= shard_size or nbytes >= _SHARD_BYTES:
            shards.append({})
            nbytes = 0
    shards = [sh for sh in shards if sh]
    with ThreadPoolExecutor(min(_IO_THREADS, max(len(shards), 1))) as pool:
        list(pool.map(lambda ia: _write_npz(os.path.join(tmp, f"shard_{ia[0]:05d}.npz"), ia[1]),
                      enumerate(shards)))

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str, published_only: bool) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and (not published_only
                  or os.path.exists(os.path.join(directory, name, "manifest.json"))):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory, published_only=True)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (its leaves give the
    shapes to check). Returns (tree of CPU tensors, step). Raises
    FileNotFoundError if no checkpoint exists."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_shard: Dict[int, List[dict]] = {}
    for entry in manifest["leaves"]:
        by_shard.setdefault(entry["shard"], []).append(entry)
    values: Dict[str, torch.Tensor] = {}

    def read(item):
        shard_idx, entries = item
        arrays = _read_npz(os.path.join(path, f"shard_{shard_idx:05d}.npz"),
                           [e["npz_key"] for e in entries])
        return {e["key"]: _from_numpy(arrays[e["npz_key"]], e["dtype"]) for e in entries}
    with ThreadPoolExecutor(min(_IO_THREADS, max(len(by_shard), 1))) as pool:
        for part in pool.map(read, sorted(by_shard.items())):
            values.update(part)
    for key, leaf in _items(tree_like):
        if key not in values:
            raise KeyError(f"checkpoint missing leaf {key}")
        want = tuple(getattr(leaf, "shape", values[key].shape))
        if tuple(values[key].shape) != want:
            raise ValueError(f"{key}: checkpoint {tuple(values[key].shape)} vs model {want}")
    return _rebuild(tree_like, values), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer. ``save`` copies the tree to the
    host on the caller's thread (the train step updates its tensors in
    place, so the snapshot must be taken before the next step), then
    serializes and writes it off the training loop. ``keep`` checkpoints
    are kept, the oldest removed."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, tree, extra_meta=None) -> None:
        self.wait()
        host = [(k, v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                 else np.array(v, copy=True)) for k, v in _items(tree)]
        host_tree = _rebuild(tree, dict(host))

        def work():
            try:
                self.last_path = save_checkpoint(self.directory, step, host_tree,
                                                 extra_meta=extra_meta)
                self._gc()
            except BaseException as e:      # re-raised by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.directory, published_only=False)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
