"""Atomic, keep-k, asynchronous checkpoints with elastic resharding.

Counterpart of ``repro.checkpoint.manager``, with its on-disk layout::

    <dir>/step_000123/
        manifest.json        # step, meta, and each leaf's key, file,
                             # shape and dtype
        arr_00000.npy ...    # one file per leaf
    <dir>/LATEST             # atomic pointer (rename-into-place)

* **atomic** — a step is written into ``step_x.tmp`` and renamed into
  place, then ``LATEST`` is; a crash mid-save never corrupts the last
  good checkpoint;
* **async** — :meth:`CheckpointManager.save` snapshots the state into
  pinned host buffers on a side CUDA stream (the current stream waits
  for that copy before anything can change the state again) and returns;
  a writer thread waits for the copy's event, then writes the files, so
  the train thread never waits for the disk.  :meth:`~CheckpointManager.
  wait` joins it and re-raises its failure;
* **keep-k** — older steps are deleted after a successful save;
* **bfloat16 without ml_dtypes** — a bfloat16 leaf is stored as its raw
  16 bits (a ``uint16`` ``.npy``) with ``"bfloat16"`` in the manifest;
  any other leaf is a plain ``.npy`` of its dtype;
* **restore in place** — ``restore(template, in_place=True)`` copies
  into the template's own tensors, so a captured CUDA graph that reads
  them keeps its addresses;
* **elastic** — :func:`reshard_workers` maps a worker-stacked state saved
  with ``W_old`` replicas onto ``W_new`` (replicas averaged and
  re-broadcast: a synchronization point).

Leaf keys are the reference's ``/``-joined paths: ``NamedTuple`` field
names (``TrainState``, ``OuterState``), then dict keys; ``None`` holds no
leaf.  Files are numbered in the reference's flattening order (dict keys
sorted), so a float32 state carries across the two packages both ways.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..tree import tree_map

__all__ = ["CheckpointManager", "reshard_workers"]

Tree = Any


def _map_with_keys(fn: Callable[[str, torch.Tensor], Any], tree: Tree,
                   prefix: tuple[str, ...] = ()) -> Tree:
    """``fn(key, leaf)`` over every leaf, in the reference's flattening
    order; the result keeps ``tree``'s structure (``None`` stays)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_keys(fn, getattr(tree, f),
                                           prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _keyed_leaves(tree: Tree) -> list[tuple[str, torch.Tensor]]:
    out: list[tuple[str, torch.Tensor]] = []
    _map_with_keys(lambda k, x: out.append((k, x)), tree)
    return out


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor as the array written to disk, and its manifest
    dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_file(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pinned: dict[int, torch.Tensor] = {}  # leaf -> its buffer
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Tree, *, meta: dict | None = None,
             block: bool = False) -> None:
        self.wait()                       # one in-flight save at a time
        leaves = _keyed_leaves(state)
        host, copied = self._snapshot([x for _, x in leaves])
        keys = [k for k, _ in leaves]

        def work():
            try:
                if copied is not None:
                    copied.synchronize()
                self._write(step, keys, host, meta or {})
                self._gc()
            except Exception as e:        # surfaced by the next wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=work, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()
        else:
            work()
            self.wait()                   # re-raise a sync-save failure

    def _snapshot(self, leaves: list[torch.Tensor]
                  ) -> tuple[list[torch.Tensor], torch.cuda.Event | None]:
        """Host copies of ``leaves``: CUDA ones into pinned buffers on a
        side stream (the event marks the copy done; the current stream
        waits for it), CPU ones cloned."""
        cuda = [x for x in leaves if x.is_cuda]
        if not cuda:
            return [x.detach().clone() for x in leaves], None
        dev = cuda[0].device
        main = torch.cuda.current_stream(dev)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(main)          # copy the state as it ends
        host = []
        with torch.cuda.stream(stream):
            for i, x in enumerate(leaves):
                if not x.is_cuda:
                    host.append(x.detach().clone())
                    continue
                buf = self._pinned.get(i)
                if buf is None or buf.shape != x.shape \
                        or buf.dtype != x.dtype:
                    buf = self._pinned[i] = torch.empty(
                        x.shape, dtype=x.dtype, pin_memory=True)
                buf.copy_(x, non_blocking=True)
                host.append(buf)
        copied = torch.cuda.Event()
        copied.record(stream)
        main.wait_event(copied)           # nothing updates a leaf mid-copy
        return host, copied

    def wait(self) -> None:
        """Block until any in-flight save lands; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, keys: list[str], host: list[torch.Tensor],
               meta: dict) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "meta": meta, "leaves": []}
        for i, (key, t) in enumerate(zip(keys, host, strict=True)):
            fn = f"arr_{i:05d}.npy"
            arr, dtype = _to_numpy(t)
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"key": key, "file": fn, "shape": list(t.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.rename(latest_tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        self.wait()                       # pending async saves count
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[1])

    def _manifest(self, step: int | None) -> tuple[int, str, dict]:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return step, d, json.load(f)

    def peek_meta(self, step: int | None = None) -> dict:
        """A checkpoint's manifest ``meta`` without loading arrays."""
        return self._manifest(step)[2]["meta"]

    def restore(self, template: Tree, *, step: int | None = None,
                in_place: bool = False) -> tuple[int, Tree, dict]:
        """Load a checkpoint (the latest by default) into ``template``'s
        structure -> ``(step, tree, meta)``.

        By default each leaf comes back as saved (shapes may differ in
        the worker axis: the caller reshards with
        :func:`reshard_workers`) on the device of the template's leaf.
        ``in_place=True`` copies every leaf into the template's own
        tensor, which must have the saved shape and dtype, and returns
        ``template``.  Waits for any in-flight save first, so a restore
        right after a save never races the writer."""
        step, d, manifest = self._manifest(step)
        by_key = {e["key"]: e for e in manifest["leaves"]}

        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            e = by_key[key]
            t = _from_file(os.path.join(d, e["file"]), e["dtype"])
            if not in_place:
                return t.to(leaf.device)
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(
                    f"leaf {key!r}: saved {tuple(t.shape)} {t.dtype}, "
                    f"template {tuple(leaf.shape)} {leaf.dtype}; an "
                    "in-place restore needs both equal")
            leaf.copy_(t)
            return leaf

        tree = _map_with_keys(load, template)
        return step, template if in_place else tree, manifest["meta"]


def reshard_workers(tree: Tree, w_new: int) -> Tree:
    """Elastically change the worker-replica count: every leaf's axis 0
    is averaged (float32) and broadcast to ``w_new`` replicas — all
    workers restart from a synchronization point, so convergence
    guarantees survive membership changes."""
    def one(x):
        m = x.float().mean(0, keepdim=True).to(x.dtype)
        return m.expand(w_new, *x.shape[1:]).contiguous()
    return tree_map(one, tree)
