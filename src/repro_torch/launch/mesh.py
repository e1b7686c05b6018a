"""Meshes on ``torch.distributed`` (twin of ``repro/launch/mesh.py``): the
production and host meshes of the training cells and the serving mesh of
the launchers.

Axis semantics: ``pod`` is cross-pod data parallelism, ``data`` the in-pod
batch and ZeRO/FSDP shards, ``model`` tensor, expert, sequence and corpus
parallelism.  :func:`make_production_mesh` and :func:`make_host_mesh` lay a
``DeviceMesh`` over the live process group (the caller makes it: one rank a
process, or the ``fake`` backend of ``launch.dryrun``).

The JAX package's ``common/compat.py`` papers over JAX versions
(``shard_map``, ``make_mesh``, ``AxisType``, ``set_mesh``); the port has
no twin of it: ``init_device_mesh`` and ``DeviceMesh`` (``get_group``,
``get_coordinate``, ``mesh_dim_names``) are one API across the torch
versions the port runs on, and there is no ``shard_map`` (each rank runs
its blocks with ``common.collectives``).

JAX forces host devices into one process; a ``torch.distributed`` mesh is
one process a rank.  So ``--mesh N`` runs under ``torchrun --nproc-per-node
N -m repro_torch.launch.serve ...`` (one card a rank), or in one process
when N is 1.  :func:`make_serving_mesh` uses the process group it finds, or
makes one: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), else a one-rank group on a TCP store at
a free local port (NCCL on the card, gloo on the CPU).  A group made here is
destroyed by :func:`release_serving_group`; one found is left to whoever
made it.  Importing this module touches no device and opens no group.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as tdist

from repro_torch.common.device import resolve_device

AXES = ("pod", "data", "model")
_made_group = False   # whether the live process group was made here


def parse_mesh_spec(spec: str) -> tuple[int, ...]:
    """``"1x8"`` -> (1, 8).  1-3 ``x``-separated positive ints."""
    try:
        shape = tuple(int(p) for p in str(spec).lower().split("x"))
    except ValueError:
        raise ValueError(f"bad --mesh spec {spec!r}; want e.g. '8' or '1x8'")
    if not 1 <= len(shape) <= 3 or any(s < 1 for s in shape):
        raise ValueError(f"bad --mesh spec {spec!r}; want 1-3 positive ints")
    return shape


def world_size() -> int:
    """Ranks of the live process group, else of ``torchrun``'s environment,
    else 1."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank() -> int:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return int(os.environ.get("RANK", 0))


def ensure_devices(n: int) -> None:
    """Raise unless the world has ``n`` ranks: a process cannot add ranks to
    itself, so the error names the ``torchrun`` command that starts them."""
    have = world_size()
    if have != n:
        raise RuntimeError(
            f"--mesh needs {n} ranks but the world has {have}; launch with "
            f"torchrun --nproc-per-node {n} -m repro_torch.launch.serve ... --mesh ...")


def init_serving_group(device="cuda") -> bool:
    """Make the process group the mesh needs unless one is live (see the
    module docstring); on the card, each rank takes card ``LOCAL_RANK``.
    Returns whether it made one."""
    global _made_group
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index or 0)))
    if tdist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        tdist.init_process_group(backend, init_method="env://")
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        tdist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                 world_size=1, rank=0)
    _made_group = True
    return True


def release_serving_group() -> None:
    """Destroy the process group if :func:`init_serving_group` made it."""
    global _made_group
    if _made_group and tdist.is_initialized():
        tdist.destroy_process_group()
    _made_group = False


def make_serving_mesh(spec: str, *, device="cuda"):
    """Corpus-serving DeviceMesh from a ``--mesh`` spec like ``"1x8"``, over
    the rightmost axes of (pod, data, model): ``"8"`` -> 8-way ``model``,
    ``"1x8"`` -> (data=1, model=8).  The corpus is sharded over every axis
    (``LemurRetriever.shard``).  Makes the process group when none is live
    (:func:`init_serving_group`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = parse_mesh_spec(spec)
    dev = resolve_device(device)
    init_serving_group(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=AXES[3 - len(shape):])


def n_devices(mesh) -> int:
    return int(mesh.size())


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model"),
    over the live process group of 256 or 512 ranks (``device_type`` "cpu"
    for gloo or the dry run's ``fake`` group on meta tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """("data", "model") over the live group: (n/2, 2) with 4 or more ranks,
    else (1, 1) (JAX's rule over its local devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    shape = (n // 2, 2) if n >= 4 else (1, 1)
    return init_device_mesh(device_type, shape, mesh_dim_names=("data", "model"))


from repro_torch.dist.sharding import batch_axes  # noqa: E402,F401 (JAX's import path)
