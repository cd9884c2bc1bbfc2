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

A tree of DTensors (a train step on a mesh) is saved leaf by leaf whole,
gathered with ``full_tensor`` (the reference's host-gathered leaves),
with the same manifest, so a checkpoint from a mesh and one from a plain
run are interchangeable.  Every rank calls ``save``; the default group's
rank 0 writes and the others wait for it at a barrier.
``restore(..., shardings=)`` lays each leaf out on a target mesh, which
may differ from the one that saved it: the elastic restart path
(``train/elastic.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..dist import sharding as sh
from .tree import leaves, leaves_with_paths, tree_map, unflatten


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _dtype_name(t) -> str:
    return str(torch.as_tensor(t).dtype).replace("torch.", "")


def _placed(tree) -> bool:
    return any(isinstance(x, DTensor) for x in leaves(tree))


def _writer() -> bool:
    """Whether this process writes a placed tree's checkpoint: the default
    group's rank 0 (or a process with no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(tree: Any, directory: str, step: int, *,
         extras: Optional[dict] = None, keep: int = 3) -> str:
    """Synchronous atomic save; returns the checkpoint's path.  DTensor
    leaves are gathered whole; with any of them, every rank must call it,
    rank 0 writes, and all leave together."""
    if _placed(tree):
        tree = tree_map(lambda t: sh.whole(t).detach(), tree)
        path = _save(tree, directory, step, extras, keep) if _writer() \
            else os.path.join(directory, f"step_{step:09d}")
        if dist.is_initialized():
            dist.barrier()
        return path
    return _save(tree, directory, step, extras, keep)


def _save(tree: Any, directory: str, step: int, extras: Optional[dict],
          keep: int) -> str:
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
        """DTensor leaves are gathered whole here, on every rank; only the
        writer (:func:`_writer`) starts a thread."""
        self.wait()
        placed = _placed(tree)
        host = tree_map(lambda t: sh.whole(t).detach().to("cpu", copy=True),
                        tree)
        if placed and not _writer():
            return
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
            device=None, shardings: Any = None):
    """Restore into the structure of ``tree_like``: (tree, step, extras).
    Each leaf takes its ``tree_like`` leaf's dtype, and its device unless
    ``device`` is given.  ``shardings``, a tree of
    ``dist.sharding.NamedSharding`` of ``tree_like``'s structure (for
    example ``param_shardings`` on another mesh than the one that saved
    it), lays each leaf out as a DTensor on its mesh's device, each rank
    keeping its block."""
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
    places = [None] * len(like) if shardings is None else leaves(shardings)
    out = []
    for e, ref, s in zip(manifest["leaves"], like, places):
        t = torch.from_numpy(np.load(os.path.join(path, "arrays",
                                                  f"{e['idx']}.npy")))
        if e["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if s is not None:
            dev = _mesh_device(s.mesh) if device is None else device
            out.append(s.place(t.to(device=dev, dtype=ref.dtype)))
            continue
        out.append(t.to(device=ref.device if device is None else device,
                        dtype=ref.dtype))
    return unflatten(tree_like, out), manifest["step"], manifest["extras"]


def _mesh_device(mesh) -> torch.device:
    """The device of this rank on ``mesh``: the current card for a CUDA
    mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
