"""Fault-tolerant checkpoint manager (port of `repro.checkpoint.manager`).

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:
- a step directory written as ``step_XXXXXXXX.tmp/`` and then renamed
  atomically: a crash mid-write never corrupts the latest checkpoint;
- one ``.npy`` file per leaf and ``manifest.json`` (step, wall time, and
  per leaf its name, file, shape, dtype and crc32), hashes checked on load;
- async save: the copy to host memory happens at once, the disk write on a
  background thread; ``wait()`` joins it. Leaves are written, read and
  hashed on a pool of threads (file I/O and crc32 release the interpreter
  lock), and hashed in place: the same crc32 as the reference's
  ``tobytes()``, without a copy of every leaf;
- retention: keep_last_n + keep_every (milestone) garbage collection.

Leaves are ordered and named as jax flattens the reference's trees: dict
keys sorted, a `TrainState` as its children (params, mu, nu, step) under
the indices 0-3, lists and tuples by index; a name joins the keys with
``/`` (``0/blocks/pos0_dense/attn/wq``). `restore` fills a template of the
same structure in that order, as the reference does, and moves the leaves
to ``device``. ``shardings`` is the counterpart of the reference's
(``device_put`` of each leaf to its ``NamedSharding``): a tree of the same
structure whose leaves are this rank's index into each leaf (from
`repro_torch.distributed.sharding.shard_index`), so each rank of a mesh
loads the host arrays and keeps its shard. Checkpoints always hold whole
leaves (a mesh's rank 0 gathers and writes them), so a checkpoint written
on one mesh restores on any other, and in the reference.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from ..optim.adamw import TrainState

MANIFEST = "manifest.json"


def _children(tree):
    """(key, child) pairs of a container in jax's flatten order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, TrainState):
        return list(enumerate((tree.params, tree.mu, tree.nu, tree.step)))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten_with_paths(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        return [("/".join(str(p) for p in prefix), tree)]
    return [pair for k, v in kids for pair in _flatten_with_paths(v, prefix + (k,))]


def _flatten_like(template, tree):
    """``tree``'s values at ``template``'s leaves (a leaf of ``tree`` may
    itself be a tuple, such as an index)."""
    kids = _children(template)
    if kids is None:
        return [tree]
    values = _children(tree)
    return [x for (_, t), (_, v) in zip(kids, values) for x in _flatten_like(t, v)]


def _unflatten(template, it):
    kids = _children(template)
    if kids is None:
        return next(it)
    values = [_unflatten(v, it) for _, v in kids]
    if isinstance(template, dict):
        return dict(zip((k for k, _ in kids), values))
    if isinstance(template, TrainState):
        return TrainState(*values)
    return type(template)(values)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf (never a view of a tensor that training will
    update in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep_last_n: int = 3,
        keep_every: Optional[int] = None,
    ):
        self.dir = directory
        self.keep_last_n = keep_last_n
        self.keep_every = keep_every
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        host = [(n, _to_host(x)) for n, x in _flatten_with_paths(tree)]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)

            def leaf(i):
                name, arr = host[i]
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                return {
                    "name": name,
                    "file": fn,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "crc32": _crc32(arr),
                }

            with _pool() as pool:
                records = list(pool.map(leaf, range(len(host))))
            manifest = {"step": step, "time": time.time(), "leaves": records}
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------- load

    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, MANIFEST)):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(
        self,
        template: Any,
        step: Optional[int] = None,
        device=None,
        verify: bool = True,
        shardings: Any = None,
    ) -> Any:
        """Load into the structure of ``template`` (its leaves' values are
        not read: parameter specs do) as tensors on ``device`` (CPU if
        None); with ``shardings``, each leaf's ``arr[index]`` only."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        n_leaves = len(_flatten_with_paths(template))
        if n_leaves != len(manifest["leaves"]):
            raise ValueError(f"checkpoint @ step {step} holds {len(manifest['leaves'])} "
                             f"leaves, the template {n_leaves}")

        def load(rec):
            arr = np.load(os.path.join(d, rec["file"]))
            if verify and _crc32(arr) != rec["crc32"]:
                raise IOError(f"checksum mismatch in {rec['name']} @ step {step}")
            return arr

        index = (_flatten_like(template, shardings) if shardings is not None
                 else [()] * n_leaves)

        def part(arr, ix):  # ascontiguousarray would turn a 0-d leaf into 1-d
            a = arr[ix]
            return torch.from_numpy(np.ascontiguousarray(a) if a.ndim else np.asarray(a))

        with _pool() as pool:
            leaves = [part(arr, ix).to(device or "cpu")
                      for arr, ix in zip(pool.map(load, manifest["leaves"]), index)]
        return _unflatten(template, iter(leaves))

    # ------------------------------------------------------------- GC

    def _gc(self) -> None:
        steps = self.steps()
        keep = set(steps[-self.keep_last_n :])
        if self.keep_every:
            keep |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)
