"""Regex rule tables mapping parameter names to partition specs, and the
block helpers every mesh form of the port uses (twin of
``repro/dist/sharding.py``).

One :class:`ShardingRules` table per model family; ``launch/cells.py``
resolves every parameter leaf of every architecture through these tables
when it builds the dry-run cells.

Lookup contract (first match wins):

    rules = ShardingRules(rules=((r"attn/w.*$", P("model")), (r".*", P())))
    rules.spec("attn/wq", 3)   # -> P("model")  (trailing dims whole)
    rules.spec("ln1/scale", 1) # -> P()         (catch-all)

A spec may be shorter than the leaf's rank (missing trailing entries mean
whole) but never longer: a rule whose spec has more entries than the leaf
has dims raises ``ValueError``.  Scan-stacked leaves (names under
``stack_*/pos_*/``) are resolved by :func:`resolve_spec`, which strips the
stack prefix, matches the per-layer name at ``ndim - 1`` and puts ``None``
first for the stack dim; the tables are written against per-layer names.

Axis conventions (``launch/mesh.py``): ``pod`` is cross-pod data
parallelism, so parameters never use it; ``data`` carries FSDP/ZeRO
shards; ``model`` carries tensor, expert, vocab and sequence shards.

**Blocks.**  torch has no sharded array type here: a rank holds its block
of each leaf, and the mesh forms run on blocks with explicit collectives.
A dim named by several axes is split over their product, the first-named
axis major, as ``NamedSharding`` does: the rank's block along it is the
row-major fold of its coordinates on those axes.  :func:`local_block` cuts
a rank's block of a whole tensor, :func:`gather_block` is its inverse (an
all-gather a named axis, the last-named first; its backward is the
reduce-scatter), and :func:`sync_grads` sums a leaf's gradient over the
axes its spec does not name, so that after the backward each rank holds
the block of the global gradient, as JAX's gradient under a parameter
sharding is.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.common import collectives
from repro_torch.common.pytree import tree_leaves, tree_map, tree_map_with_name

__all__ = [
    "P",
    "ShardingRules",
    "GNN_RULES",
    "LM_RULES",
    "LM_RULES_FFSLICE",
    "RECSYS_RULES",
    "resolve_spec",
    "spec_tree",
    "local_shape",
    "local_block",
    "gather_block",
    "shard_tree",
    "row_block_lookup",
    "gather_tree",
    "sync_grads",
    "global_norm",
    "loss_total",
]


class P:
    """A partition spec: one entry a leading dimension, each ``None``
    (whole), an axis name, or a tuple of names (split over their product,
    the first major).  ``len``, iteration, indexing and equality are those
    of the tuple of entries, as ``jax.sharding.PartitionSpec``'s."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        object.__setattr__(self, "_entries", tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __setattr__(self, name, value):
        raise AttributeError("P is frozen")

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return iter(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._entries == other._entries
        return NotImplemented

    def __hash__(self):
        return hash(("P", self._entries))

    def __repr__(self):
        return f"P{self._entries!r}" if len(self._entries) != 1 else f"P({self._entries[0]!r})"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis name a spec uses, in order."""
    return tuple(a for e in spec for a in _axes(e))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """First-match-wins (regex, P) table (see the module docstring)."""

    rules: tuple[tuple[str, P], ...]

    def spec(self, name: str, ndim: int) -> P:
        for pattern, spec in self.rules:
            if re.search(pattern, name):
                if len(spec) > ndim:
                    raise ValueError(
                        f"rule {pattern!r} spec {spec} has {len(spec)} entries "
                        f"but leaf {name!r} has rank {ndim}")
                return spec
        raise KeyError(f"no sharding rule matches {name!r}")


# ---------------------------------------------------------------------------
# LM family.  Per-layer names and ranks (the stack dim is the caller's).
# Dense layers: tensor parallelism on the ffn/vocab axes plus FSDP over
# "data" on d_model where every production arch divides.  Biases, norms and
# routers are small and whole.
# ---------------------------------------------------------------------------

_LM_COMMON_HEAD = (
    (r"(^|/)(scale|bias)$", P()),          # norms and every dense bias
    (r"attn/b[qkv]$", P()),                # per-head attention biases
    (r"embed/embedding$", P("model", None)),   # vocab-sharded
    (r"head/kernel$", P(None, "model")),       # (d_model, vocab)
    (r"attn/wo$", P(None, None, "model")),     # (heads, head_dim, d_model)
    (r"attn/w", P("model")),               # every other attention projection
)

_LM_COMMON_TAIL = (
    (r"moe/router$", P()),
    (r"wi(_\d)?/kernel$", P("data", "model")),  # (d_model, ffn) incl. moe/shared
    (r"wo/kernel$", P("model", "data")),        # (ffn, d_model)
    (r".*", P()),
)

#: expert-parallel layout: the expert dim over "model", d_model FSDP over
#: "data".  moe/wi_*: (E, d_model, ffn_e); moe/wo: (E, ffn_e, d_model).
LM_RULES = ShardingRules(rules=_LM_COMMON_HEAD + (
    (r"moe/wi_\d$", P("model", "data", None)),
    (r"moe/wo$", P("model", "data", None)),
) + _LM_COMMON_TAIL)

#: ffslice layout: every expert on every rank, each expert's ffn dim sliced
#: over "model" (nn/moe.py's layout for a few large experts).
LM_RULES_FFSLICE = ShardingRules(rules=_LM_COMMON_HEAD + (
    (r"moe/wi_\d$", P(None, "data", "model")),
    (r"moe/wo$", P(None, "model", "data")),
) + _LM_COMMON_TAIL)


# ---------------------------------------------------------------------------
# RecSys family.  The embedding tables are row-sharded over "model" (the
# sharded lookup's substrate); the BST positional table and the MLP, CIN and
# attention weights are whole, except the two-tower MLPs, whose widths are
# multiples of 16.
# ---------------------------------------------------------------------------

RECSYS_RULES = ShardingRules(rules=(
    (r"(^|/)(scale|bias)$", P()),
    (r"pos_table/embedding$", P()),
    (r"/embedding$", P("model", None)),
    (r"_tower/layer_\d+/kernel$", P(None, "model")),
    (r".*", P()),
))


# ---------------------------------------------------------------------------
# GNN family.  The graph (nodes and edges) carries the parallelism; every
# parameter is whole.
# ---------------------------------------------------------------------------

GNN_RULES = ShardingRules(rules=((r".*", P()),))


STACK_RE = re.compile(r"stack_\d+/pos_\d+/")


def resolve_spec(rules: ShardingRules, name: str, ndim: int) -> P:
    """Rule lookup with the stack handling: a leaf under stack_*/pos_*/ is
    stacked on a leading dim; its per-layer name is matched and ``None``
    put first for the stack dim."""
    if STACK_RE.search(name):
        spec = rules.spec(STACK_RE.sub("", name), ndim - 1)
        return P(None, *spec)
    return rules.spec(name, ndim)


_resolve_spec = resolve_spec


def spec_tree(tree: Any, rules: ShardingRules) -> Any:
    """The tree of each leaf's resolved spec (by its name and rank)."""
    return tree_map_with_name(lambda n, x: resolve_spec(rules, n, x.dim()), tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (its axis indices on a mesh
    without names).  The specs and shapes of a layout (``local_shape``,
    ``configs.registry.build_cell``) take these sizes in place of a mesh,
    so a dict passes through; the collectives and ``local_block`` need a
    live mesh."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: int(s) for n, s in zip(mesh.mesh_dim_names or range(mesh.ndim), mesh.shape)}


def batch_axes(mesh) -> tuple[str, ...]:
    """The batch (data-parallel) axes a mesh (or its {axis: size}) has:
    "pod", "data"."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def n_shards(spec, mesh, dim: int) -> int:
    sizes = axis_sizes(mesh)
    entry = spec[dim] if dim < len(spec) else None
    return math.prod(sizes.get(a, 1) for a in _axes(entry))


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A rank's block shape of a leaf of ``shape`` under ``spec`` on
    ``mesh`` (a DeviceMesh or {axis: size}); raises ``ValueError`` when a
    dim does not split evenly."""
    out = []
    for dim, n in enumerate(shape):
        k = n_shards(spec, mesh, dim)
        if n % k:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split {k} ways ({spec})")
        out.append(n // k)
    return tuple(out)


def block_index(spec, mesh, coordinate: dict[str, int] | None = None) -> list[tuple[int, int]]:
    """(index, count) of a rank's block along each entry of ``spec``: its
    coordinates on the entry's axes folded row-major, first axis major.
    ``coordinate`` defaults to this rank's on ``mesh``."""
    sizes = axis_sizes(mesh)
    if coordinate is None:
        coordinate = {a: collectives.axis_index(mesh, a) for a in sizes}
    out = []
    for entry in spec:
        i, n = 0, 1
        for a in _axes(entry):
            s = sizes.get(a, 1)
            i, n = i * s + coordinate.get(a, 0), n * s
        out.append((i, n))
    return out


def local_block(x: torch.Tensor, spec, mesh, coordinate: dict[str, int] | None = None):
    """This rank's block of the whole tensor ``x`` under ``spec`` (a view)."""
    idx = [slice(None)] * x.dim()
    for dim, (i, n) in enumerate(block_index(spec, mesh, coordinate)):
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split {n} ways")
        rows = x.shape[dim] // n
        idx[dim] = slice(i * rows, (i + 1) * rows)
    return x[tuple(idx)]


def gather_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``: an
    all-gather along each split dim over its axes, the last-named (minor)
    first.  Differentiable: the backward reduce-scatters the gradient over
    those axes, so each rank gets the sum of every rank's gradient for its
    block."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            x = collectives.all_gather(x, mesh, a, dim)
    return x


def row_block_lookup(table: torch.Tensor, ids: torch.Tensor, mesh, scatter_dim=None):
    """``table[ids]`` where ``table`` is this rank's block of rows on
    "model": ids outside the block read zeros, and a sum over "model"
    combines the blocks (the JAX twin's ``sharded_embedding_lookup`` body);
    with ``scatter_dim`` the sum is scattered over "model" along it (each
    rank keeps its block of the looked-up rows)."""
    rows_loc = table.shape[0]
    local = ids - collectives.axis_index(mesh, "model") * rows_loc
    ok = (local >= 0) & (local < rows_loc)
    rows = table[local.clamp(0, rows_loc - 1)] * ok[..., None].to(table.dtype)
    if scatter_dim is not None:
        return collectives.psum_scatter(rows, mesh, "model", scatter_dim)
    return collectives.psum(rows, mesh, "model")


def _is_spec(x) -> bool:
    return isinstance(x, P)


def shard_tree(tree: Any, rules_or_specs, mesh) -> Any:
    """Each leaf's local block: by its resolved rule when given a
    :class:`ShardingRules`, else by the matching leaf of a spec tree."""
    if isinstance(rules_or_specs, ShardingRules):
        return tree_map_with_name(
            lambda n, x: local_block(x, resolve_spec(rules_or_specs, n, x.dim()), mesh), tree)
    return tree_map(lambda s, x: local_block(x, s, mesh), rules_or_specs, tree,
                    is_leaf=_is_spec)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf whole again from its blocks (the inverse of
    :func:`shard_tree`)."""
    return tree_map(lambda s, x: gather_block(x, s, mesh), specs, tree, is_leaf=_is_spec)


def sync_grads(grads: Any, specs: Any, mesh) -> Any:
    """Sum each gradient block over the mesh axes its spec does not name
    (where its parameter is replicated), in place."""
    names = collectives.axis_names(mesh)

    def one(spec, g):
        used = set(spec_axes(spec))
        for a in names:
            if a not in used and collectives.axis_size(mesh, a) > 1:
                dist.all_reduce(g, group=mesh.get_group(a))
        return g

    return tree_map(one, specs, grads, is_leaf=_is_spec)


def global_norm(grads: Any, specs: Any, mesh) -> torch.Tensor:
    """The global gradient norm from the blocks: each block's squares
    divided by its replica count, summed over the whole mesh (one
    all-reduce an axis)."""
    total = None
    for spec, g in zip(tree_leaves(specs, is_leaf=_is_spec), tree_leaves(grads)):
        used = set(spec_axes(spec))
        reps = math.prod(collectives.axis_size(mesh, a)
                         for a in collectives.axis_names(mesh) if a not in used)
        sq = torch.sum(torch.square(g.float())) / reps
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    for a in collectives.axis_names(mesh):
        if collectives.axis_size(mesh, a) > 1:
            dist.all_reduce(total, group=mesh.get_group(a))
    return torch.sqrt(total)


class _LossTotal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share, mesh):
        out = share.detach().clone()
        for a in collectives.axis_names(mesh):
            if collectives.axis_size(mesh, a) > 1:
                dist.all_reduce(out, group=mesh.get_group(a))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def loss_total(share: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over every rank of each rank's ``share`` of a loss.  Its
    backward is the identity: each rank differentiates its own share, and
    the collectives' adjoints with :func:`sync_grads` make the sum of the
    shares' gradients."""
    return _LossTotal.apply(share, mesh)
