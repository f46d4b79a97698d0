"""Atomic, async, retained checkpoints of parameter trees (the port's
counterpart of ``repro/checkpoint/ckpt.py``, in the same on-disk format).

  * **atomic**: write to ``.tmp_<name>_<pid>`` beside the target, fsync the
    manifest, then ``os.rename`` into place: a crash mid-save never
    corrupts the latest checkpoint;
  * **async**: ``CheckpointManager.save`` snapshots the tree to host memory
    and writes on one worker thread; a second save waits for the first
    (at most one save in flight);
  * **retention**: the newest ``keep`` checkpoints plus every
    ``keep_every``-th step;
  * **metadata**: arbitrary JSON rides in the manifest.

The format is the JAX package's, byte for byte: one ``.npy`` file per leaf
named after its sanitized tree path, and a ``manifest.json`` mapping each
path to its file, shape and dtype.  Paths are the JAX package's:
``/``-joined dict keys in sorted order, list indices, and a ``Packed`` leaf
as its two pytree children ``<path>/0`` (the int8 words) and ``<path>/1``
(the exponent f); ``n_bits`` comes from the restore template, as JAX's
pytree aux data does.  A NamedTuple (a ``TrainState``) names its children
by field, as ``jax.tree_util`` does, and a ``SymogState`` is its one child
``<path>/0``, the tree of f (its mask is static, not written).  A Python
int leaf (a state's ``step``) is written as an int32 0-d array, a float as
a float32 one, JAX's default dtypes, and comes back as an int or float.
bfloat16 leaves are written as numpy writes ml_dtypes' bfloat16 (2-byte
void words, dtype ``bfloat16`` in the manifest).  So each package restores
the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packing import Packed
from repro_torch.core.symog import SymogState

_MANIFEST = "manifest.json"


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "__", path)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the JAX package's flatten order and path names."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], _join(prefix, k))]
    if isinstance(tree, SymogState):
        return _leaves(tree.f, _join(prefix, 0))
    if _is_namedtuple(tree):
        return [kv for k, v in zip(tree._fields, tree) for kv in _leaves(v, _join(prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, _join(prefix, i))]
    if isinstance(tree, Packed):
        return [(_join(prefix, 0), tree.data), (_join(prefix, 1), tree.f)]
    return [(prefix, tree)]


def _to_numpy(leaf, copy: bool = False) -> np.ndarray:
    """The host array as written: bfloat16 as 2-byte void words.  ``copy``:
    never share memory with a CPU tensor (a snapshot the caller may then
    change)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else (t.clone() if copy else t)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, (int, float)):
        return np.asarray(leaf, dtype=np.int32 if isinstance(leaf, int) else np.float32)
    return np.array(leaf) if copy else np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, except that bfloat16 words get the header numpy writes
    for ml_dtypes' bfloat16 (``'<V2'``; a plain 2-byte void says ``'|V2'``)."""
    if arr.dtype != np.dtype("V2"):
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def save_pytree(tree: Any, directory: str, *, metadata: Optional[Dict] = None) -> None:
    """Blocking atomic save of one tree into ``directory``."""
    _write([(path, _to_numpy(leaf)) for path, leaf in _leaves(tree)], directory, metadata)


def _write(arrays: List[Tuple[str, np.ndarray]], directory: str,
           metadata: Optional[Dict]) -> None:
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp_{os.path.basename(directory)}_{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"leaves": {}, "metadata": metadata or {}}
    for path, arr in arrays:
        fname = _sanitize(path) + ".npy"
        _save_npy(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": _dtype_name(arr)}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_manifest(directory: str) -> Dict:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)


def load_pytree(directory: str, like: Any, *, device=None) -> Any:
    """Restore into the structure of ``like`` (a template tree: tensors,
    meta tensors, ``Packed`` leaves, ints and floats; only shapes, ``n_bits``,
    a ``SymogState``'s mask and the Python types are read).  Leaves keep
    their saved dtype and land on ``device`` (default the CPU)."""
    manifest = load_manifest(directory)
    leaves = manifest["leaves"]
    dev = torch.device(device) if device is not None else torch.device("cpu")

    def restore(path: str, template):
        if path not in leaves:
            raise KeyError(f"checkpoint {directory} missing leaf {path!r}")
        arr = np.load(os.path.join(directory, leaves[path]["file"]))
        if isinstance(template, (int, float)):
            return type(template)(arr)
        expect = tuple(template.shape) if hasattr(template, "shape") else None
        if expect is not None and tuple(arr.shape) != expect:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != expected {expect}")
        if leaves[path]["dtype"] == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    def walk(tree, prefix: str):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: walk(v, _join(prefix, k)) for k, v in tree.items()}
        if isinstance(tree, SymogState):
            return SymogState(f=walk(tree.f, _join(prefix, 0)), mask=tree.mask)
        if _is_namedtuple(tree):
            return type(tree)(*(walk(v, _join(prefix, k)) for k, v in zip(tree._fields, tree)))
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, _join(prefix, i)) for i, v in enumerate(tree))
        if isinstance(tree, Packed):
            return Packed(data=restore(_join(prefix, 0), tree.data), n_bits=tree.n_bits,
                          f=restore(_join(prefix, 1), tree.f))
        return restore(prefix, tree)

    return walk(like, "")


class CheckpointManager:
    """Async, retained, resumable checkpoints under ``root``."""

    def __init__(self, root: str, *, keep: int = 3, keep_every: int = 0):
        self.root = root
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(root, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- discovery ---------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"ckpt_(\d+)", name)
            if m and os.path.exists(os.path.join(self.root, name, _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt_{step}")

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, *, metadata: Optional[Dict] = None,
             blocking: bool = False, mesh=None) -> None:
        """Write ``tree`` as ``ckpt_<step>``.  On a ``mesh`` the tree is the
        same on every rank (data-parallel training keeps it replicated) and
        rank 0 alone writes the full logical arrays: JAX's format."""
        if mesh is not None and mesh.rank != 0:
            return
        self.wait()  # back-pressure: at most one save in flight
        # snapshot to host memory now, so the caller may change the tensors
        host = [(path, _to_numpy(leaf, copy=True)) for path, leaf in _leaves(tree)]

        def work():
            _write(host, self.path(step), metadata)
            self._gc()

        if blocking:
            work()
        else:
            with self._lock:
                self._pending = threading.Thread(target=work, daemon=True)
                self._pending.start()

    def wait(self) -> None:
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                self._pending = None

    # -- restore -----------------------------------------------------------
    def restore(self, like: Any, *, step: Optional[int] = None, device=None, mesh=None,
                rules=None) -> Tuple[Any, Dict, int]:
        """(tree, metadata, step) of ``step`` (default the latest), its
        leaves on ``device`` (the engine's, in place of the JAX package's
        ``shardings``).  With ``mesh`` and ``rules`` (``nn.sharding``) each
        rank keeps its slice of every leaf (``shard_tree``); ``like`` holds
        the full logical shapes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.path(step)
        tree = load_pytree(d, like, device=device)
        if mesh is not None and rules is not None:
            from repro_torch.nn.sharding import shard_tree

            tree = shard_tree(rules, mesh, tree)
        return tree, load_manifest(d)["metadata"], step

    # -- retention ---------------------------------------------------------
    def _gc(self) -> None:
        steps = self.steps()
        protect = set(steps[-self.keep:]) if self.keep else set(steps)
        if self.keep_every:
            protect |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in protect:
                shutil.rmtree(self.path(s), ignore_errors=True)
