"""Atomic, asynchronous, keep-last-k checkpoints of parameter trees.

The port of ``repro.train.checkpoint``, in its layout::

    <dir>/step_000000120/
        manifest.json        # leaf paths, shapes, dtypes, step, extras
        arrays/<idx>.npy     # one file per leaf, in leaf order
    <dir>/LATEST             # the pointer, replaced atomically

A step is written under a ``.tmp-`` name, its manifest fsynced, and
``os.replace``d into place; only then is LATEST repointed, so a crash at
any point leaves the previous checkpoint whole.  bfloat16 leaves, which
numpy has no type for, are saved as their 16-bit patterns and named
``bfloat16`` in the manifest.  ``restore`` puts every leaf on the device
and in the dtype of the tree it is given (or on ``device``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import leaves, leaves_with_paths, tree_map, unflatten


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _dtype_name(t) -> str:
    return str(torch.as_tensor(t).dtype).replace("torch.", "")


def save(tree: Any, directory: str, step: int, *,
         extras: Optional[dict] = None, keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, f".tmp-{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))

    manifest = {"step": step, "extras": extras or {}, "leaves": []}
    for i, (key, leaf) in enumerate(leaves_with_paths(tree)):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, "arrays", f"{i}.npy"), arr)
        manifest["leaves"].append({"key": key, "idx": i,
                                   "shape": list(arr.shape),
                                   "dtype": _dtype_name(leaf)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    latest_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))

    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write in a background
    thread; one save in flight at a time."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, tree: Any, step: int, *,
             extras: Optional[dict] = None) -> None:
        self.wait()
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self._thread = threading.Thread(
            target=save, args=(host, self.directory, step),
            kwargs={"extras": extras, "keep": self.keep}, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore(tree_like: Any, directory: str, *, step: Optional[int] = None,
            device=None):
    """Restore into the structure of ``tree_like``: (tree, step, extras).
    Each leaf takes its ``tree_like`` leaf's dtype, and its device unless
    ``device`` is given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = leaves(tree_like)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(like)}")
    out = []
    for e, ref in zip(manifest["leaves"], like):
        t = torch.from_numpy(np.load(os.path.join(path, "arrays",
                                                  f"{e['idx']}.npy")))
        if e["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(device=ref.device if device is None else device,
                        dtype=ref.dtype))
    return unflatten(tree_like, out), manifest["step"], manifest["extras"]
