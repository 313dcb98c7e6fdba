"""Fault-tolerant checkpointing: sharded npz + manifest, async save.

Layout, the reference's own, so that a checkpoint one package writes
restores in the other:

    <dir>/step_<N>/
        manifest.json     leaf paths, shapes, dtypes, file map, checksums
        shard_<k>.npz     flat leaves (files capped near 1 GiB)
        COMMIT            written last; a step without it is partial and
                          is skipped on restore (torn-write safety)

A step is written into ``step_<N>.tmp`` and renamed when complete.
Leaves go in the reference's order (dicts by sorted key, tuples in
order) under jax's ``keystr`` paths (``['params']['embed']``, a tuple
entry ``[0]``); each one's ``crc`` is the first 16 hex digits of the sha1
of its bytes.  bfloat16 leaves are stored as raw 2-byte voids (``|V2``)
with ``"dtype": "bfloat16"`` in the manifest, as numpy writes
``ml_dtypes``' bfloat16; the port reads and writes them through
``int16`` views and needs no ``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..models.common import tree_map

_SHARD_BYTES = 1 << 30

def _paths(tree: Any, prefix: str = ""):
    """(keystr path, leaf) of every tensor leaf, in the reference's
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host array of ``t``'s bytes: bfloat16 as ``|V2``."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _crc(a: np.ndarray) -> str:
    return hashlib.sha1(a.tobytes()).hexdigest()[:16]


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous save of ``tree`` (nested dicts and tuples of tensors);
    returns the step directory."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    manifest = {"step": step, "leaves": [], "files": []}
    shard, shard_bytes, shard_idx = {}, 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if not shard:
            return
        fname = f"shard_{shard_idx}.npz"
        np.savez(os.path.join(tmp_dir, fname), **shard)
        manifest["files"].append(fname)
        shard, shard_bytes = {}, 0
        shard_idx += 1

    for i, (path, t) in enumerate(_paths(tree)):
        a = _to_numpy(t)
        key = f"leaf_{i}"
        manifest["leaves"].append({
            "path": path, "key": key, "file_index": shard_idx,
            "shape": list(a.shape), "dtype": (
                "bfloat16" if t.dtype == torch.bfloat16 else str(a.dtype)),
            "crc": _crc(a),
        })
        shard[key] = a
        shard_bytes += a.nbytes
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()

    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    return step_dir


def latest_step(directory: str) -> int | None:
    """Largest step with a COMMIT marker; partial saves are ignored."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(directory, name, "COMMIT")):
            continue
        try:
            s = int(name.split("_")[1])
        except ValueError:
            continue
        best = s if best is None or s > best else best
    return best


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def restore_checkpoint(directory: str, step: int, like: Any,
                       verify: bool = True) -> Any:
    """Restore into the structure of ``like`` (tensors): each leaf on its
    ``like`` leaf's device, cast to its dtype."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    files: dict[str, Any] = {}

    out = []
    for path, ref in _paths(like):
        e = by_path.get(path)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        fname = manifest["files"][e["file_index"]]
        if fname not in files:
            files[fname] = np.load(os.path.join(step_dir, fname))
        a = files[fname][e["key"]]
        if verify and _crc(a) != e["crc"]:
            raise IOError(f"checksum mismatch for {path} in {step_dir}")
        if list(a.shape) != list(ref.shape):
            raise ValueError(f"shape mismatch for {path}: ckpt {a.shape} vs "
                             f"expected {tuple(ref.shape)}")
        out.append(_to_tensor(a, e["dtype"]).to(device=ref.device,
                                                 dtype=ref.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), like, torch.is_tensor)


class CheckpointManager:
    """Async saves (one writer thread at a time) + retention +
    auto-resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        # copied to the host before the writer thread takes it
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree,
                        torch.is_tensor)

        def work():
            save_checkpoint(self.directory, step, host)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, n, "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like)
