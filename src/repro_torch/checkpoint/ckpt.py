"""Checkpointing: atomic, integrity-checked, async-capable, resumable.

Port of ``repro/checkpoint/ckpt.py:41-199``:

  * **atomic commit** — data files are written to a temp dir, fsynced, then
    the directory (with a manifest of per-file checksums + step) is renamed
    into place last; a crash mid-write never corrupts the latest checkpoint.
  * **integrity manifest** — every array file carries a sha256; restore
    verifies before handing weights to the trainer.
  * **async save** — a background thread serializes while training continues
    (the tensors are copied to the host first, so the step is not blocked on
    disk and an in-place step cannot change what is being written).
  * **one file per leaf** — ``.npy``, named by the leaf's path in the tree.
  * **retention** — keep_n newest checkpoints garbage-collected.

Trees are nested dicts, lists, tuples and dataclasses (the optimizer state)
of tensors.  A DTensor leaf (the sharded train step) is saved whole, one
file a leaf as the reference saves each array (``repro/checkpoint/ckpt.py:
73, 153``): gathering it is a collective, so every rank of its mesh saves,
each into a directory of its own.  It is restored into the placement of
the tree it is restored into, whatever mesh that is: each rank keeps its
own shard of the leaf it read whole.  numpy has no bfloat16, so a bf16
leaf is stored as its uint16 bit pattern and the manifest records the
logical dtype: a round trip is bit-exact.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch.sharding import is_dtensor

MANIFEST = "manifest.json"


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node of a tree; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for k, c in kids
            for pair in _leaf_paths(c, f"{prefix}/{k}" if prefix else k)]


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if _children(tree) is None:
        return next(leaves)
    if isinstance(tree, dict):       # leaves in sorted-key order, keys in tree's
        done = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, leaves) for c in tree)
    return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                        for f in dataclasses.fields(tree)})


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank of its mesh must call this);
    any other tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor leaf, a DTensor's whole (a copy even of
    CPU tensors)."""
    return _rebuild(tree, iter(_whole(t.detach()).to("cpu", copy=True)
                               for _, t in _leaf_paths(tree)))


def _copy_into(like: torch.Tensor, whole: torch.Tensor) -> None:
    """Write the whole leaf ``whole`` into ``like``: a DTensor keeps its
    placements, each rank copying its own shard (no collective)."""
    if not is_dtensor(like):
        like.copy_(whole)
        return
    from torch.distributed.tensor import distribute_tensor
    mesh = like.device_mesh
    local = distribute_tensor(whole.to(mesh.device_type), mesh, like.placements,
                              src_data_rank=None)
    like.copy_(local)


def _to_savable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = _whole(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_savable(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    """Atomic checkpoint write. Returns the committed directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    files = {}
    try:
        for name, leaf in _leaf_paths(tree):
            arr, logical_dtype = _to_savable(leaf)
            fname = name.replace("/", "__") + ".npy"
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            files[name] = {"file": fname, "sha256": digest,
                           "shape": list(arr.shape), "dtype": logical_dtype}
        manifest = {"step": step, "time": time.time(),
                    "files": files, "extra": extra or {}}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _load_manifest(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        return json.load(f)


def load_checkpoint(ckpt_dir: str, tree_like: Any, *,
                    verify: bool = True) -> tuple[Any, dict]:
    """Restore into ``tree_like`` in place: each leaf is copied into the
    tensor that stands at its path, on that tensor's device (a DTensor's
    shard into each rank's local tensor), so a restore holds no second copy
    of the state — the eager train step updates in place for the same
    reason.  Every file is checked against its shape,
    dtype and sha256 before any leaf is written, so a corrupt checkpoint
    leaves ``tree_like`` as it was.  Returns (tree_like, manifest)."""
    manifest = _load_manifest(ckpt_dir)
    files = manifest["files"]
    leaves = _leaf_paths(tree_like)
    for name, like in leaves:
        if name not in files:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        meta = files[name]
        dtype = str(like.dtype).removeprefix("torch.")
        if meta["shape"] != list(like.shape) or meta["dtype"] != dtype:
            raise ValueError(f"leaf {name!r}: checkpoint holds {meta['dtype']} "
                             f"{meta['shape']}, the tree {dtype} {list(like.shape)}")
        if verify:
            with open(os.path.join(ckpt_dir, meta["file"]), "rb") as f:
                if hashlib.file_digest(f, "sha256").hexdigest() != meta["sha256"]:
                    raise IOError(f"checksum mismatch for {name!r} "
                                  f"(corrupt checkpoint {ckpt_dir})")
    with torch.no_grad():
        for name, like in leaves:
            meta = files[name]
            with open(os.path.join(ckpt_dir, meta["file"]), "rb") as f:
                _copy_into(like, _from_savable(np.load(f), meta["dtype"]))
    return tree_like, manifest


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and
             os.path.exists(os.path.join(directory, d, MANIFEST))]
    return max(steps) if steps else None


@dataclasses.dataclass
class CheckpointManager:
    """Async save + retention + resume."""

    directory: str
    keep_n: int = 3
    _pool: cf.ThreadPoolExecutor = dataclasses.field(
        default_factory=lambda: cf.ThreadPoolExecutor(max_workers=1))
    _pending: cf.Future | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None,
             blocking: bool = False) -> None:
        host_tree = _to_host(tree)     # copy NOW, serialize in background
        self.wait()

        def work():
            save_checkpoint(self.directory, step, host_tree, extra)
            self._gc()

        self._pending = self._pool.submit(work)
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def restore_latest(self, tree_like: Any):
        """Returns (tree, manifest) or (None, None) when no checkpoint.
        A corrupt newest checkpoint falls back to the next older one."""
        self.wait()           # an in-flight async save must commit first
        step = latest_step(self.directory)
        if step is None:
            return None, None
        try:
            return load_checkpoint(
                os.path.join(self.directory, f"step_{step:010d}"), tree_like)
        except (IOError, KeyError):
            for d in sorted(os.listdir(self.directory), reverse=True):
                if not d.startswith("step_") or int(d.split("_")[1]) >= step:
                    continue
                try:
                    return load_checkpoint(
                        os.path.join(self.directory, d), tree_like)
                except (IOError, KeyError):
                    continue
            raise

    def _gc(self) -> None:
        dirs = sorted(d for d in os.listdir(self.directory)
                      if d.startswith("step_"))
        for d in dirs[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)
