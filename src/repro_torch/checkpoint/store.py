"""Fault-tolerant checkpoint store — port of ``repro.checkpoint.store``,
in its on-disk format, so that a flat tree written by one package restores
in the other:

* **atomicity** — write to ``<dir>/tmp.<step>.<pid>/`` then ``os.rename``
  to ``step_<%010d>/``; a crash mid-write never corrupts the latest
  checkpoint;
* **integrity** — ``manifest.json`` stores per-leaf shape, dtype and crc32;
  restore verifies them before handing arrays back;
* **layout** — one ``arrays.npz`` of the tree's leaves, each keyed by its
  path joined with ``::`` (dict keys, list and tuple indices, a
  NamedTuple's field names);
* **async** — :meth:`CheckpointManager.save_async` copies every tensor to
  the host first (blocking only on that copy, so later in-place updates of
  the parameters cannot reach the snapshot) and writes in a background
  thread, overlapping the next training steps.

Leaves are tensors (on any device), values placed on a mesh (a
:class:`~repro_torch.models.sharding.Sharded`, gathered to the host whole,
so a checkpoint written on a mesh is the one a single device writes),
numpy arrays or Python numbers; restore returns numpy arrays in the
example tree's structure.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.models.sharding import Sharded

__all__ = ["CheckpointManager", "SEP", "latest_step", "restore_checkpoint",
           "save_checkpoint"]

SEP = "::"


def _items(tree):
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in the tree's order; None leaves are skipped."""
    items = _items(tree)
    if items is None:
        if tree is not None:
            yield prefix, tree
        return
    for k, child in items:
        yield from _leaves(child, prefix + (str(k),))


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (a tensor detached and copied, never a view; a
    placed value gathered from its blocks)."""
    if isinstance(leaf, Sharded):
        with torch.no_grad():
            return leaf.full("cpu").numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {SEP.join(path): _host(leaf) for path, leaf in _leaves(tree)}


def _unflatten(example, flat: dict[str, np.ndarray], prefix=()):
    items = _items(example)
    if items is None:
        if example is None:
            return None
        key = SEP.join(prefix)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        return flat[key]
    out = [(k, _unflatten(child, flat, prefix + (str(k),))) for k, child in items]
    if isinstance(example, dict):
        return dict(out)
    values = [v for _, v in out]
    if isinstance(example, tuple) and hasattr(example, "_fields"):
        return type(example)(*values)
    return type(example)(values)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    """Atomically write ``tree`` (+ json-serializable ``extra``) for ``step``."""
    return _write(directory, step, _flatten(tree), extra)


def _write(directory: str, step: int, flat: dict[str, np.ndarray],
           extra: dict | None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": step,
        "extra": extra or {},
        "leaves": {
            k: {
                "shape": list(v.shape),
                "dtype": str(v.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes()),
            }
            for k, v in flat.items()
        },
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(
        int(name.split("_")[1]) for name in os.listdir(directory)
        if name.startswith("step_")
        and os.path.isdir(os.path.join(directory, name)))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, example_tree: Any,
                       step: int | None = None, verify: bool = True
                       ) -> tuple[Any, dict, int]:
    """Restore (tree of numpy arrays shaped as ``example_tree``, extra,
    step); validates checksums and shapes."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    if verify:
        for k, meta in manifest["leaves"].items():
            arr = flat[k]
            if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
                raise ValueError(f"leaf {k}: manifest/shape mismatch")
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc32"]:
                raise ValueError(f"leaf {k}: checksum mismatch (corrupt checkpoint)")
    return _unflatten(example_tree, flat), manifest.get("extra", {}), step


class CheckpointManager:
    """Async saver with a bounded queue (depth 1) and retention policy."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, extra: dict | None = None):
        """Copy ``tree`` to the host now, write it in a background thread."""
        self.wait()  # depth-1 queue: the previous write must finish
        flat = _flatten(tree)

        def work():
            try:
                _write(self.directory, step, flat, extra)
                self._gc()
            except Exception as e:  # noqa: BLE001 — surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
