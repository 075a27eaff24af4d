"""Checkpoints of the port, in the JAX package's format: either package
reads what the other writes.

The port of ``repro.checkpoint.manager``:

  * **Format**: a directory ``step_<step>`` holding one ``.npy`` file a
    leaf and ``manifest.json`` (``{"step", "leaves": {key: {"file",
    "dtype", "shape", "crc"}}, "shards": null}``).  A leaf's key is its
    JAX path string (``params|group0_dense|attn|wq``, ``opt|.inner|m|
    embed``, ``opt|.step``: ``train.tree``); files are numbered in the
    sorted order of the keys; the CRC32 is over the array's raw bytes.  A
    bf16 leaf is written as the JAX package writes it (numpy has no
    bfloat16 without ``ml_dtypes``): its raw 2-byte words as ``|V2``,
    manifest dtype ``"bfloat16"``; it is read back through those words
    into ``torch.bfloat16``.  The JAX package's own ``restore_tree`` fails
    on such a leaf (numpy cannot cast ``|V2``), so only the port reads a
    bf16 checkpoint of either package.
  * **Atomic**: written to ``<dir>/tmp.<step>`` then renamed.
  * **Integrity**: restore checks each leaf's CRC32.
  * **Sharded trees**: a ``DTensor`` leaf is gathered whole (every rank
    calls ``save_tree``, rank 0 writes), so the format stays one file a
    leaf whatever the world size.
  * **Async**: ``save_tree(..., blocking=False)`` first takes its own host
    copy of every leaf (``.detach().to("cpu", copy=True)``: a copy even
    of a CPU tensor), then writes from a thread.  The optimizer updates
    parameters in place, so a copy that shared storage would be written
    while the next step changes it.
  * **Retention**: the last ``keep`` steps are kept.

``restore_tree`` puts each leaf on ``device`` (None: its template leaf's
device) in its template leaf's dtype.  ``shardings`` (a tree in the
template's structure of ``dist.api.NamedSharding``, None where a leaf
stays whole) is the elastic restore: leaves are stored whole, so each is
read whole and laid out as a ``DTensor`` with the given placements on any
mesh; a restore onto another world size gives the same full tensors.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.api import is_dtensor, place
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train import tree

__all__ = ["save_tree", "restore_tree", "latest_step", "CheckpointManager"]

BF16 = "bfloat16"


def _flatten(t: Any) -> dict:
    return {tree.path_key(p): leaf for p, leaf in tree.leaves_with_path(t)}


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that no later step can change (a
    ``DTensor`` gathered whole first); a bf16 tensor as its raw 2-byte
    words (``|V2``)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_tree(t: Any, directory: str, step: int, *, keep: int = 3,
              blocking: bool = True) -> Optional["_Writer"]:
    """Write ``t`` to ``directory/step_<step>`` atomically; without
    ``blocking``, return the writer thread (``join`` re-raises its
    error)."""
    flat = _flatten(t)
    host = {k: _host(v) for k, v in flat.items()}
    if any(is_dtensor(v) for v in flat.values()):
        # every rank gathered the leaves; one writes them
        import torch.distributed as dist
        if dist.get_rank() != 0:
            return None
    os.makedirs(directory, exist_ok=True)

    def write():
        tmp = os.path.join(directory, f"tmp.{step}")
        final = os.path.join(directory, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}, "shards": None}
        for i, (key, arr) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname,
                                       "dtype": _dtype_name(arr),
                                       "shape": list(arr.shape),
                                       "crc": _crc(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        _gc(directory, keep)

    if blocking:
        write()
        return None
    w = _Writer(write)
    w.start()
    return w


class _Writer(threading.Thread):
    """A background save whose ``join`` re-raises the error it met."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn, self.error = fn, None

    def run(self):
        try:
            self._fn()
        except BaseException as e:      # handed to the joining thread
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


def _gc(directory: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_tree(template: Any, directory: str, step: Optional[int] = None,
                 device=None, shardings: Any = None) -> Any:
    """The checkpoint of ``step`` (None: the latest) in the structure of
    ``template``: each leaf on ``device`` (None: its template leaf's) in
    its template leaf's dtype, or laid out by its entry of ``shardings``.
    Raises ``IOError`` on a CRC mismatch."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dev = None if device is None else resolve_device(device)

    flat_s = {} if shardings is None else dict(
        tree.leaves_with_path(shardings))

    def load(p, leaf):
        key = tree.path_key(p)
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        crc = _crc(arr)
        if crc != meta["crc"]:
            raise IOError(f"checkpoint corruption in leaf {key!r} "
                          f"(crc {crc} != {meta['crc']})")
        t = torch.as_tensor(leaf)
        got = _tensor(arr, meta["dtype"]).to(dtype=t.dtype)
        sharding = flat_s.get(p)
        if sharding is not None:
            return place(got, sharding.mesh, sharding.spec)
        return got.to(device=dev if dev is not None else t.device)

    out = [load(p, leaf) for p, leaf in tree.leaves_with_path(template)]
    return tree.unflatten(template, out)


class CheckpointManager:
    """Step-driven saves in the background, and resume from the latest."""

    def __init__(self, directory: str, interval: int = 100, keep: int = 3):
        self.directory, self.interval, self.keep = directory, interval, keep
        self._pending: Optional[_Writer] = None

    def maybe_save(self, step: int, t: Any, *, force: bool = False):
        if not force and (step % self.interval):
            return
        self.wait()
        self._pending = save_tree(t, self.directory, step, keep=self.keep,
                                  blocking=False)

    def wait(self):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.join()

    def restore_or(self, template: Any, shardings: Any = None):
        """(tree, step) from the latest checkpoint onto the template's
        devices (or ``shardings``' layouts), or (template, 0)."""
        step = latest_step(self.directory)
        if step is None:
            return template, 0
        return restore_tree(template, self.directory, step,
                            shardings=shardings), step
