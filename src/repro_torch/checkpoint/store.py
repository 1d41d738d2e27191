"""Fault-tolerant checkpointing of a training state.

The JAX package's ``checkpoint/store.py`` for trees of tensors, with the
same layout on disk (one directory per step):

    <root>/step_000000042/
        manifest.json     — step, the tree's leaf paths, per-leaf dtype,
                            shape and crc32, extra metadata, completion marker
        leaf_00000.npy …  — one array per leaf

A tree is a nested dict of tensors (the trainer's ``{"params":
state_dict, "opt": {"mu": …, "nu": …, "step": …}}``); its leaves are taken
in sorted key order at every level, as JAX flattens a dict, so ``leaf_i``
is the same leaf for either package's tree of the same names.  bfloat16
leaves (which ``np.save`` cannot write) are stored as their raw 16-bit
words and reinterpreted on restore, as the JAX package stores them.

* **Atomicity** — writes go to ``<dir>.tmp``, renamed only after the
  manifest (with the checksums) is fsync'd: a crash mid-save never leaves
  a directory ``latest_step`` would pick up.
* **Async saves** — ``save_async`` copies every leaf to host memory
  synchronously (the step may then overwrite its tensors in place) and
  writes in a daemon thread; ``wait`` joins the writers.
* **Restore onto a device** — ``restore(step, tree_like, device=)`` puts
  each leaf on ``device`` (default: the like-leaf's), in the like-leaf's
  dtype; shapes and the leaf count must match, and checksums are verified.
* **Sharded leaves** — a DTensor leaf is saved whole: every rank joins
  its gather (``full_tensor``) and rank 0 alone writes, so the files are
  the same as an unsharded save's and either package reads them.
  ``restore(..., shardings=, mesh=)`` places each leaf on ``mesh`` by its
  placements (a tree of the like-tree's structure, as
  ``runtime.sharding.param_shardings`` gives), whatever mesh it was saved
  from: the JAX package's restore onto a different mesh.
* **Retention** — ``keep`` limits how many recent steps survive.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.runtime.sharding import place

__all__ = ["CheckpointStore", "CheckpointMeta"]

# the dtype names the manifest records; bfloat16 goes to disk as its raw bits
_TORCH_NAMES = {torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool"}


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` of a nested dict, keys sorted at every level."""
    if isinstance(tree, Mapping):
        out = []
        for key in sorted(tree):
            out.extend(flatten(tree[key], f"{prefix}{key}/"))
        return out
    return [(prefix[:-1], tree)]


def _unflatten_into(tree: Any, leaves: list, prefix: str = "") -> Any:
    """A tree of ``tree``'s structure with its leaves taken in order."""
    if isinstance(tree, Mapping):
        return {key: _unflatten_into(tree[key], leaves, f"{prefix}{key}/")
                for key in sorted(tree)}
    return leaves.pop(0)


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the leaf's bytes as a numpy array np.save can write, dtype name)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu").contiguous()
    name = _TORCH_NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy(), name
    return t.numpy().copy(), name


def _sharded(tree: Any) -> bool:
    return any(isinstance(leaf, DTensor) for _, leaf in flatten(tree))


def _to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    path: str
    extra: dict


class CheckpointStore:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> str:
        """Synchronous atomic save of a nested dict of tensors.  With DTensor
        leaves every rank must call it; rank 0 writes, and every rank
        returns once the step is on disk."""
        leaves = self._snapshot(tree)
        final = self._step_dir(step)
        if self._writer(tree):
            final = self._write(step, leaves, extra or {})
        if _sharded(tree):
            dist.barrier()
        return final

    @staticmethod
    def _writer(tree: Any) -> bool:
        return not _sharded(tree) or dist.get_rank() == 0

    def save_async(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        """Snapshot to host now; write in the background (with DTensor
        leaves, on rank 0; every rank joins the snapshot's gathers)."""
        leaves = self._snapshot(tree)
        if not self._writer(tree):
            return
        t = threading.Thread(target=self._write, args=(step, leaves, extra or {}), daemon=True)
        t.start()
        with self._lock:
            self._pending.append(t)

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    @staticmethod
    def _snapshot(tree: Any) -> list[tuple[str, np.ndarray, str]]:
        return [(path, *_host(leaf)) for path, leaf in flatten(tree)]

    # ------------------------------------------------------------------
    def _write(self, step: int, leaves, extra: dict) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        records = []
        for i, (path, arr, name) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            records.append({"file": fname, "path": path, "shape": list(arr.shape),
                            "dtype": name, "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
        manifest = {"step": step, "treedef": [p for p, _, _ in leaves],
                    "num_leaves": len(leaves), "leaves": records, "extra": extra,
                    "complete": True}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, tree_like: Any, *, device: str | torch.device | None = None,
                verify: bool = True, shardings: Any | None = None,
                mesh=None) -> tuple[Any, dict]:
        """A tree of ``tree_like``'s structure holding step ``step``'s
        leaves, each in its like-leaf's dtype on ``device`` (default: the
        like-leaf's device).  ``shardings`` (a tree of placements of the
        same structure) makes each leaf a DTensor on ``mesh`` with those
        placements; every rank reads the whole leaf and keeps its shards.
        Raises on an incomplete checkpoint, a leaf count or shape that
        differs, or (``verify``) a checksum mismatch."""
        if shardings is not None and mesh is None:
            raise ValueError("restore(shardings=...) needs the mesh to place them on")
        placed = None if shardings is None else [p for _, p in flatten(shardings)]
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if not manifest.get("complete"):
            raise IOError(f"checkpoint at {d} is incomplete")
        like = flatten(tree_like)
        if len(like) != manifest["num_leaves"]:
            raise ValueError(f"checkpoint has {manifest['num_leaves']} leaves, "
                             f"target tree has {len(like)}")
        out = []
        for i, (rec, (_, leaf)) in enumerate(zip(manifest["leaves"], like)):
            arr = np.load(os.path.join(d, rec["file"]))
            if verify and zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF != rec["crc32"]:
                raise IOError(f"leaf {i} checksum mismatch in {d}")
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {i} shape {arr.shape} != expected {tuple(leaf.shape)}")
            t = _to_tensor(arr, rec["dtype"])
            t = t.to(device=leaf.device if device is None else device, dtype=leaf.dtype)
            if placed is not None:
                t = place(t, mesh, placed[i])
            out.append(t)
        return _unflatten_into(tree_like, out), manifest["extra"]

    def restore_latest(self, tree_like: Any, **kw) -> tuple[int, Any, dict]:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        tree, extra = self.restore(step, tree_like, **kw)
        return step, tree, extra
