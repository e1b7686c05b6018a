"""The JAX package's checkpoint layout and manager (twin of
``repro/checkpoint/manager.py``):

    <dir>/step_000120/
        manifest.json      # leaf names, shapes, dtypes, extra (config, ...)
        shard_00000.npz    # leaves, with "/" in leaf names stored as "__"
        _COMMITTED         # written last: a directory without it is ignored

``save`` takes a pytree of tensors or numpy arrays (a flat ``{name: array}``
dict is one) and writes its ``named_leaves``; ``restore`` reads a step as
``({name: array}, manifest)``, ``restore_tree`` into the structure of a
target tree.  A tree's leaf names are JAX's (``0/table/embedding``,
``1/mu/...`` for ``(params, OptState)``), so each package restores the
other's checkpoint.  As in the JAX twin, a bfloat16 leaf is written as fp32
(npz cannot hold it) and cast back to the target leaf's dtype on restore:
every bf16 value is an fp32 one, so the bits survive.

``CheckpointManager`` adds the async save (a host copy of every leaf taken
before ``save_async`` returns, written on a worker thread), retention and
restore-latest, which waits for a save in flight.  ``restore_tree`` puts each leaf on its target leaf's device
and dtype; with ``shardings`` (a tree of ``dist.sharding.P``) and a
``mesh`` each rank reads the stored global leaf and keeps its block, the
JAX twin's elastic re-shard onto the current mesh.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import named_leaves, tree_map_with_name


def _fsync_file(path: pathlib.Path) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a numpy array, bfloat16 as fp32; with ``copy`` an array of
    its own, never a view of a live tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.float() if t.dtype == torch.bfloat16 else t
        return t.to("cpu", copy=copy).numpy()
    x = np.array(leaf, copy=copy or None)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def _leaf_dict(tree: Any, copy: bool = False) -> dict[str, np.ndarray]:
    return {name: _host(leaf, copy) for name, leaf in named_leaves(tree)}


def save(directory: str | os.PathLike, step: int, tree: Any,
         extra: dict | None = None) -> pathlib.Path:
    """Write one step of ``tree`` -> its committed directory (see
    :func:`_write_step`)."""
    return _write_step(directory, step, _leaf_dict(tree), extra=extra)


def _write_step(directory: str | os.PathLike, step: int, leaves: dict[str, np.ndarray], *,
                extra: dict | None = None) -> pathlib.Path:
    """The one crash-safe write path (sync and async saves both use it), in
    the JAX crash order: the shard and the manifest are written and fsync'd
    in a ``.tmp`` staging directory, then ``_COMMITTED`` (fsync'd), and the
    rename into place comes last.  A crash leaves the previous step or the
    new one, never a torn one."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in leaves.items()},
        "extra": extra or {},
    }
    np.savez(tmp / "shard_00000.npz",
             **{k.replace("/", "__"): v for k, v in leaves.items()})
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    _fsync_file(tmp / "shard_00000.npz")
    _fsync_file(tmp / "manifest.json")
    (tmp / "_COMMITTED").write_text("ok")
    _fsync_file(tmp / "_COMMITTED")
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)
    return d


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest committed step under ``directory``, or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    best = None
    for sub in d.iterdir():
        m = re.fullmatch(r"step_(\d+)", sub.name)
        if m and (sub / "_COMMITTED").exists():
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore(directory: str | os.PathLike, step: int | None = None):
    """Read one committed step -> ``({leaf name: np.ndarray}, manifest)``.

    Leaf names are the JAX ``named_leaves`` paths (``psi/dense/kernel``).
    Shapes and dtypes are checked against the manifest; a ``bfloat16`` leaf
    raises (npz cannot hold it and the port serves fp32)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    d = pathlib.Path(directory) / f"step_{step:08d}"
    if not (d / "_COMMITTED").exists():
        raise FileNotFoundError(f"{d} is not a committed checkpoint")
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "shard_00000.npz") as data:
        leaves = {k.replace("__", "/"): data[k] for k in data.files}
    for name, spec in manifest["leaves"].items():
        if spec["dtype"] == "bfloat16":
            raise ValueError(f"{name}: bfloat16 leaves are not supported")
        if name not in leaves:
            raise KeyError(f"checkpoint {d} missing leaf {name!r}")
        arr = leaves[name]
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            raise ValueError(f"{name}: bfloat16 leaves are not supported")
        if list(arr.shape) != list(spec["shape"]) or str(arr.dtype) != spec["dtype"]:
            raise ValueError(f"{name}: stored {arr.dtype}{list(arr.shape)} != "
                             f"manifest {spec['dtype']}{spec['shape']}")
    return leaves, manifest


def restore_tree(directory: str | os.PathLike, target_tree: Any, *,
                 step: int | None = None, shardings: Any = None,
                 mesh: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``target_tree`` -> (tree, step).  Each
    leaf is checked against its target's shape and put on the target leaf's
    device and dtype; stored leaves the target lacks are ignored.  With
    ``shardings`` (a tree of partition specs matching the target's leaves
    by name) and ``mesh``, each stored leaf is cut to this rank's block and
    the target holds blocks.  Raises as the JAX twin: FileNotFoundError
    without a committed step, KeyError for a missing leaf, ValueError for a
    shape."""
    if shardings is not None and mesh is None:
        raise ValueError("restore_tree(shardings=...) needs the mesh its specs refer to")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    stored, _ = restore(directory, step)
    missing = [n for n, _ in named_leaves(target_tree) if n not in stored]
    if missing:
        raise KeyError(f"checkpoint {directory} step {step} missing leaves: {missing[:5]}...")
    specs = {} if shardings is None else dict(named_leaves(shardings))

    def fill(name, leaf):
        arr = torch.from_numpy(stored[name])
        if name in specs:
            from repro_torch.dist.sharding import local_block

            arr = local_block(arr, specs[name], mesh)
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: checkpoint shape {tuple(arr.shape)} != target {want}")
        return arr.to(device=leaf.device, dtype=leaf.dtype)

    return tree_map_with_name(fill, target_tree), step


class CheckpointManager:
    """Async save + retention + restore-latest."""

    def __init__(self, directory: str | os.PathLike, keep_last: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree: Any, *, extra: dict | None = None):
        self.wait()
        # a host copy of every leaf now (the caller may write the live
        # tensors in place once this returns), the write on a worker thread
        host = _leaf_dict(tree, copy=True)

        def work():
            try:
                _write_step(self.directory, step, host, extra=extra)
                self._prune()
            except Exception as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore_latest(self, target_tree: Any, shardings: Any = None, *, mesh: Any = None):
        self.wait()
        return restore_tree(self.directory, target_tree, shardings=shardings, mesh=mesh)

    def latest_step(self):
        """The newest committed step, a save in flight counted once it has
        committed (it is waited for: the JAX twin reads the directory at
        once, so a restore can race its own async save and take an older
        step; ROADMAP Queue 3)."""
        self.wait()
        return latest_step(self.directory)

    def _prune(self):
        steps = sorted(
            int(m.group(1))
            for sub in self.directory.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", sub.name)) and (sub / "_COMMITTED").exists()
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
