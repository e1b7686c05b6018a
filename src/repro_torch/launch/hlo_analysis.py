"""Step cost analysis of an eager PyTorch step (twin of
``repro/launch/hlo_analysis.py``; the module name is kept so a reader finds
the counterpart).

JAX's analyzer walks the compiled HLO and multiplies each loop body by its
trip count, because XLA's own cost analysis counts a ``while`` body once.
Eager PyTorch has no HLO: every operation of a step is dispatched, loops
included, so the twin watches one run of the step under a
``TorchDispatchMode`` and adds up, per device:

* ``flops``: the products, JAX's "dot/convolution" (``mm``, ``addmm``,
  ``bmm``, ``baddbmm`` as 2mnk a product, and the convolution and
  attention operators by ``torch.utils.flop_counter``'s formulas);
* ``bytes``: each operation's input and output bytes.  Eager runs
  unfused, so this is the traffic an eager step really makes.  Views,
  allocations and collectives move no bytes here; a gather (indexing,
  ``gather``, ``index_select``, ``embedding``) counts twice its result, an
  in-place scatter (``index_put_``, ``index_add_``, ``scatter_*_``) twice
  the rows it writes, plus their indices, as JAX's analyzer counts
  ``gather``;
* ``collective_bytes`` / ``collective_count`` by kind (the ``c10d``
  operations: the result bytes of each, as JAX counts them), and
  ``total_collective_bytes``.

Run a step under it with :func:`analyze` (or ``with CostAnalysis() as
ca: ...; ca.result()``), on real tensors or on ``meta`` ones (shapes
only, as the dry run does).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_C10D_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute", "recv_": "collective-permute",
}
_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
_GATHERS = {"index", "gather", "index_select", "embedding", "take_along_dim"}
_SCATTERS = {"index_put_", "index_add_", "scatter_", "scatter_add_", "scatter_reduce_",
             "index_copy_", "_index_put_impl_"}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "_to_copy_meta", "set_", "resize_",
               "record_stream", "_local_scalar_dense", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "is_same_size"}


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _matmul_flops(name: str, args) -> float:
    if name == "mm":
        a, b = args[0], args[1]
    elif name == "addmm":
        a, b = args[1], args[2]
    elif name == "bmm":
        a, b = args[0], args[1]
    else:                       # baddbmm
        a, b = args[1], args[2]
    k = a.shape[-1]
    return 2.0 * a.numel() / k * k * b.shape[-1]


class CostAnalysis(TorchDispatchMode):
    """Adds up FLOPs, bytes and collectives of what runs under it (see the
    module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_count: dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d":
            kind = _C10D_KIND.get(name)
            if kind is not None:
                self.coll_bytes[kind] += _nbytes(_tensors(args[0]))
                self.coll_count[kind] += 1
            return out
        if name in _MATMULS:
            self.flops += _matmul_flops(name, args)
        else:
            from torch.utils.flop_counter import flop_registry

            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
        if name in _NO_TRAFFIC or _is_view(func):
            return out
        if name in _GATHERS:
            self.bytes += 2 * _nbytes(_tensors(out))
        elif name in _SCATTERS:
            moved = _tensors(args[1:]) + _tensors(kwargs)
            self.bytes += sum(2 * _nbytes([t]) if t.is_floating_point() else _nbytes([t])
                              for t in moved)
        else:
            self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
        return out

    def result(self) -> dict:
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collective_bytes": dict(self.coll_bytes),
            "collective_count": dict(self.coll_count),
            "total_collective_bytes": float(sum(self.coll_bytes.values())),
        }


def analyze(fn, *args, **kwargs) -> dict:
    """The cost analysis of one run of ``fn(*args, **kwargs)``: the keys of
    the JAX twin's ``analyze``."""
    with CostAnalysis() as ca:
        fn(*args, **kwargs)
    return ca.result()
