"""A one-rank gloo process group and its ``DeviceMesh``, for the CPU tests
that run a mesh form on one rank: every collective of a one-rank mesh moves
nothing, so the form must equal its ``mesh=None`` form.  The group is
process-global: each use makes it and destroys it."""
import contextlib
import tempfile

import torch.distributed as tdist
from torch.distributed.device_mesh import init_device_mesh


@contextlib.contextmanager
def one_rank_mesh(tmp_dir, shape=(1, 1), names=("data", "model")):
    """The mesh of a one-rank group whose store is a new file under ``tmp_dir``."""
    store = tempfile.mkdtemp(dir=tmp_dir)
    tdist.init_process_group("gloo", init_method=f"file://{store}/pg_store",
                             world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        tdist.destroy_process_group()
