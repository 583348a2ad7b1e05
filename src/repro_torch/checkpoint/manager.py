"""Fault-tolerant checkpointing, ported from ``repro.checkpoint.manager``:
async and atomic.

* **Atomic**: each file is written to ``<name>.tmp`` and then
  ``os.replace``d, so a crash mid-save never corrupts the latest
  checkpoint.
* **Async**: the device-to-host copy is synchronous (a copy, so that the
  caller may go on updating its tensors in place); the disk write runs on
  a background thread, one in flight at a time. A write that failed raises
  at the next ``wait`` (or ``save``).
* **keep_n** garbage collection, a ``latest`` pointer file, and a JSON
  manifest beside each step's ``.npz`` holding the caller's ``extra`` (the
  data iterator's step) and every tensor's dtype.

A tree is a nested dict of tensors (the LM's parameters by name, the AdamW
state), flattened to ``/``-joined keys. A dtype that numpy lacks
(bfloat16) is stored as its raw 16-bit view and named in the manifest.
``restore`` rebuilds ``like``'s structure with each tensor in the dtype
of ``like``'s, on ``like``'s device or the one it is given.

On a mesh (``mesh`` given) every rank calls ``save`` and ``restore``.
``save`` takes a tree of this rank's blocks and a tree of shardings (each
with ``gather(local) -> whole`` and ``shard(whole) -> local``, such as
``parallel.NamedSharding``): each tensor is gathered whole and the mesh's
rank (0, ..., 0) alone writes it, in the one-device format, so a mesh
checkpoint restores on one device and the other way round. ``wait`` holds
every rank until that rank's write has been renamed into place (and
raises on every rank if it failed). ``restore(step, like, shardings)``
cuts each whole tensor to this rank's block for the current mesh (the
elastic restart onto another mesh).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.comm import is_mesh_leader, mesh_max

# dtypes numpy lacks, stored as a raw view of this integer dtype
_RAW_VIEWS = {torch.bfloat16: torch.int16}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if "/" in str(key):
            raise ValueError(f"a checkpoint key may not hold '/': {key!r}")
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "/"))
        elif torch.is_tensor(value):
            out[path] = value
        else:
            raise TypeError(f"{path}: a checkpoint holds tensors, got "
                            f"{type(value).__name__}")
    return out


def _unflatten_like(like: Dict[str, Any], flat: Dict[str, Any],
                    prefix: str = "") -> Dict[str, Any]:
    return {key: (_unflatten_like(value, flat, f"{prefix}{key}/")
                  if isinstance(value, dict) else flat[f"{prefix}{key}"])
            for key, value in like.items()}


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(a numpy copy of ``t``, its torch dtype's name)."""
    t = t.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _RAW_VIEWS:
        t = t.view(_RAW_VIEWS[t.dtype])
    return t.numpy(), name


def _leaf(tree: Optional[Dict[str, Any]], path: str):
    """The entry of a nested dict at a ``/``-joined path, or None."""
    for key in path.split("/"):
        if tree is None:
            return None
        tree = tree.get(key)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, mesh=None):
        self.dir = directory
        self.keep_n = keep_n
        self.mesh = mesh
        self.writer = mesh is None or is_mesh_leader(mesh)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.save_seconds = 0.0
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None,
             shardings: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``tree`` to the host and write it as ``step`` in the
        background; on a mesh, gather each tensor whole by its entry of
        ``shardings`` (none: whole on every rank) first."""
        t0 = time.perf_counter()
        host, dtypes = {}, {}
        for key, t in _flatten(tree).items():
            sh = _leaf(shardings, key)
            if sh is not None:
                t = sh.gather(t)
            if self.writer:
                host[key], dtypes[key] = _to_host(t)
        self.wait()                                             # one in flight
        if not self.writer:
            return
        self._thread = threading.Thread(
            target=self._write_logged, args=(step, host, dtypes, extra or {}),
            daemon=True)
        self._thread.start()
        self.save_seconds = time.perf_counter() - t0

    def _write_logged(self, *args) -> None:
        try:
            self._write(*args)
        except Exception as e:              # re-raised by wait()
            self._error = e

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.npz")

    def _write(self, step: int, host: Dict[str, np.ndarray],
               dtypes: Dict[str, str], extra: Dict[str, Any]) -> None:
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k.replace("/", "\x1f"): v for k, v in host.items()})
        os.replace(tmp, path)
        man = {"step": step, "extra": extra, "keys": sorted(host),
               "dtypes": dtypes, "time": time.time()}
        mtmp = path + ".json.tmp"
        with open(mtmp, "w") as f:
            json.dump(man, f)
        os.replace(mtmp, path + ".json")
        latest = os.path.join(self.dir, "latest")
        with open(latest + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(latest + ".tmp", latest)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep_n]:
            for suffix in ("", ".json"):
                try:
                    os.remove(self._path(s) + suffix)
                except FileNotFoundError:
                    pass

    def wait(self) -> None:
        """Wait for the write in flight; raise what it raised. On a mesh
        every rank waits for the writer's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None and \
                mesh_max(self.mesh, float(self._error is not None)):
            err, self._error = self._error, None
            raise RuntimeError("the checkpoint write failed") from err
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the checkpoint write failed") from err

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("step_") and f.endswith(".npz"))

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "latest")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.exists(self._path(s)):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Dict[str, Any],
                shardings: Optional[Dict[str, Any]] = None, device=None):
        """(the tree saved at ``step`` in the structure of ``like``, each
        tensor in the dtype of ``like``'s and on ``device``, None: on
        ``like``'s; the ``extra`` saved with it). With ``shardings`` (the
        structure of ``like``, None entries whole) ``like`` holds this
        rank's blocks and each whole tensor is cut to its block
        (re-sharding onto the current mesh). A key, shape or dtype that
        differs raises."""
        path = self._path(step)
        with open(path + ".json") as f:
            man = json.load(f)
        flat_like = _flatten(like)
        if set(flat_like) != set(man["keys"]):
            raise ValueError(f"checkpoint {path} holds other keys: "
                             f"{sorted(set(flat_like) ^ set(man['keys']))}")
        out = {}
        with np.load(path) as data:
            for key, ref in flat_like.items():
                stored = getattr(torch, man["dtypes"][key])
                if stored != ref.dtype:
                    raise ValueError(f"{key}: saved as {stored}, restored "
                                     f"into {ref.dtype}")
                t = torch.from_numpy(data[key.replace("/", "\x1f")])
                if stored in _RAW_VIEWS:
                    t = t.view(stored)
                sh = _leaf(shardings, key)
                if sh is not None:
                    t = sh.shard(t)
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"{key}: saved {tuple(t.shape)}, "
                                     f"restored into {tuple(ref.shape)}")
                out[key] = t.to(ref.device if device is None else device)
        return _unflatten_like(like, out), man["extra"]
