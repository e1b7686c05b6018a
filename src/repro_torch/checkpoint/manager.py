"""The JAX package's checkpoint layout (``repro/checkpoint/manager.py``),
read and written as numpy:

    <dir>/step_000120/
        manifest.json      # leaf names, shapes, dtypes, extra (config, ...)
        shard_00000.npz    # leaves, with "/" in leaf names stored as "__"
        _COMMITTED         # written last: a directory without it is ignored
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import time

import numpy as np


def _fsync_file(path: pathlib.Path) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def save(directory: str | os.PathLike, step: int, leaves: dict[str, np.ndarray],
         extra: dict | None = None) -> pathlib.Path:
    """Write one step -> its committed directory, in the JAX crash order: the
    shard and the manifest are written and fsync'd in a ``.tmp`` staging
    directory, then ``_COMMITTED`` (fsync'd), and the rename into place comes
    last.  A crash leaves the previous step or the new one, never a torn one."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = {k: np.asarray(v) for k, v in leaves.items()}
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
