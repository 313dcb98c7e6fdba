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

On a mesh the checkpoint is logically global, as the reference's is, so
a checkpoint written on one mesh restores on any other, on one device,
or in the reference.  In a world of ranks, leaf i is written and read by
rank i mod world: its DTensor blocks move to that rank to be saved, and
from it to their ranks on restore (``sharding.move_blocks``: each piece
crosses once), so the writes, the checksums and the traffic spread over
the ranks.  A restored leaf takes the ``like`` leaf's placements where
it is a DTensor, or those of ``shardings`` (a matching tree of
:class:`~repro_torch.sharding.NamedSharding`); a 0-d leaf (the
optimizer's step) is restored as a plain tensor.
:class:`CheckpointManager` joins the world in a barrier after each save
and before each restore.
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

from ..models.common import tree_leaves, tree_map
from ..sharding import (Layout, distribute, from_local, full_tensor,
                        is_dtensor, layout_of, move_blocks)

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


def _gather_to(t: torch.Tensor, owner: int):
    """Leaf ``t`` whole on the host of rank ``owner`` (a DTensor's blocks
    moved there, every rank joining), ``None`` elsewhere; a plain leaf
    (whole in every rank) as it is."""
    if not is_dtensor(t):
        return t
    return move_blocks(t.to_local(), layout_of(t),
                       Layout(t.shape, owner=owner), dtype=t.dtype,
                       device="cpu")


class _ShardWriter:
    """Leaves ``(index, path, tensor)`` into npz files ``<prefix><k>.npz``
    in ``tmp_dir``, each written once it passes 1 GiB, so a writer holds
    at most one file's leaves; ``records`` name each leaf's file."""

    def __init__(self, tmp_dir: str, prefix: str):
        self.tmp_dir, self.prefix = tmp_dir, prefix
        self.records, self.files = [], []
        self.shard, self.nbytes = {}, 0

    def _name(self) -> str:
        return f"{self.prefix}{len(self.files)}.npz"

    def add(self, i: int, path: str, t: torch.Tensor) -> None:
        a = _to_numpy(t)
        self.records.append({
            "path": path, "key": f"leaf_{i}", "file": self._name(),
            "shape": list(a.shape),
            "dtype": ("bfloat16" if t.dtype == torch.bfloat16
                      else str(a.dtype)),
            "crc": _crc(a), "index": i})
        self.shard[f"leaf_{i}"] = a
        self.nbytes += a.nbytes
        if self.nbytes >= _SHARD_BYTES:
            self.flush()

    def flush(self) -> None:
        if self.shard:
            np.savez(os.path.join(self.tmp_dir, self._name()), **self.shard)
            self.files.append(self._name())
            self.shard, self.nbytes = {}, 0

    def close(self):
        self.flush()
        return self.records, self.files


def _commit(directory: str, step: int, records, files) -> None:
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    index = {f: k for k, f in enumerate(files)}
    leaves = [{"path": r["path"], "key": r["key"],
               "file_index": index[r["file"]], "shape": r["shape"],
               "dtype": r["dtype"], "crc": r["crc"]}
              for r in sorted(records, key=lambda r: r["index"])]
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": leaves, "files": files}, f)
    with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)


def _fresh(tmp_dir: str) -> None:
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous save of ``tree`` (nested dicts and tuples of tensors);
    returns the step directory.  In a world of ranks every rank calls it:
    leaf i is moved whole to rank i mod world (DTensor blocks, each
    piece once), which writes it into its own npz files, and rank 0
    writes the manifest and the COMMIT marker."""
    import torch.distributed as dist
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    rank, world = _world()
    if world == 1:
        _fresh(tmp_dir)
        out = _ShardWriter(tmp_dir, "shard_")
        for i, (path, t) in enumerate(_paths(tree)):
            out.add(i, path, full_tensor(t).detach().cpu())
        _commit(directory, step, *out.close())
        return step_dir
    if rank == 0:
        _fresh(tmp_dir)
    _barrier()
    out = _ShardWriter(tmp_dir, f"shard_r{rank}_")
    for i, (path, t) in enumerate(_paths(tree)):
        whole = _gather_to(t, i % world)
        if rank == i % world:
            out.add(i, path, whole.detach().cpu())
        del whole
    written = out.close()
    every = [None] * world
    dist.all_gather_object(every, written)
    if rank == 0:
        _commit(directory, step, [r for rec, _ in every for r in rec],
                [f for _, fs in every for f in fs])
    _barrier()
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


def _world() -> tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist
    if _world()[1] > 1:
        dist.barrier()


def restore_checkpoint(directory: str, step: int, like: Any,
                       shardings: Any = None, verify: bool = True) -> Any:
    """Restore into the structure of ``like`` (tensors): each leaf on its
    ``like`` leaf's device, cast to its dtype, and placed as the ``like``
    leaf is (a DTensor) or as ``shardings`` says (any-mesh restore), on
    its mesh's device type; a placed leaf's ``like`` may be a ``"meta"``
    tensor (its shape and dtype are all that is read).  In
    a world of ranks every rank calls it: a placed leaf i is read (and
    its checksum verified) by rank i mod world alone, and its blocks
    moved to their ranks; a plain leaf is read by every rank."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    files: dict[str, Any] = {}
    rank, world = _world()
    sh_leaves = (list(tree_leaves(shardings, lambda x: hasattr(x, "spec")))
                 if shardings is not None else None)

    def read(path, ref, device=None):
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
        return _to_tensor(a, e["dtype"]).to(
            device=ref.device if device is None else device,
            dtype=ref.dtype)

    out = []
    for i, (path, ref) in enumerate(_paths(like)):
        if ref.ndim == 0:              # a scalar (the step) stays plain
            out.append(read(path, full_tensor(ref)))
            continue
        if sh_leaves is not None and sh_leaves[i] is not None:
            mesh, places = sh_leaves[i].mesh, sh_leaves[i].placements
        elif is_dtensor(ref):
            mesh, places = ref.device_mesh, tuple(ref.placements)
        else:
            out.append(read(path, ref))
            continue
        device = torch.device(mesh.device_type)
        if world == 1:
            out.append(distribute(read(path, ref, device), mesh, places))
            continue
        owner = i % world
        whole = read(path, ref, "cpu") if rank == owner else None
        block = move_blocks(whole, Layout(ref.shape, owner=owner),
                            Layout(ref.shape, mesh, places),
                            dtype=ref.dtype, device=device)
        out.append(from_local(block, mesh, places, ref.shape)
                   if block is not None else None)
    it = iter(out)
    return tree_map(lambda _: next(it), like, torch.is_tensor)


class CheckpointManager:
    """Async saves (one writer thread at a time) + retention +
    auto-resume.  In a world of ranks every rank calls each method, in
    the same order; rank 0 writes."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any) -> None:
        """On one process: copied to the host, then written by a writer
        thread.  In a world of ranks: :func:`save_checkpoint` (leaves
        moved to their writers: a collective), then old steps removed."""
        self.wait()
        if _world()[1] > 1:
            save_checkpoint(self.directory, step, tree)
            if _world()[0] == 0:
                self._gc()
            _barrier()
            return
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
        _barrier()

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.directory, n, "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any, shardings: Any = None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like,
                                        shardings)
