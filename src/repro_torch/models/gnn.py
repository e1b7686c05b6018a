"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode GNN
(twin of ``repro/models/gnn.py``).

Message passing runs over an edge index: the aggregators are a sorted
``index_put_(accumulate=True)`` (sum, mean: the same order every run) and
``scatter_reduce("amax")`` (max) into the node states.  As ``jax.ops.segment_max``, the max leaves a node with no
incoming edge at -inf (ROADMAP Queue 3); the sum and the mean leave it at 0.

The processor's layer parameters are stacked (leading axis ``n_layers``),
as the JAX twin's ``vmap`` init gives them; where JAX scans them under
``jax.checkpoint``, the port loops over views of the stacks and wraps each
layer in ``torch.utils.checkpoint`` under autograd.

Shape regimes:
  full-graph      — forward over all edges (full_graph_sm / ogb_products)
  sampled         — uniform neighbor sampler (fanout 15-10) + two-hop
                    aggregation (minibatch_lg)
  batched-small   — many small graphs flattened with graph-id segment ids
                    (molecule), graph-level readout.

The sampler's draw is a ``torch.Generator`` where JAX's is a key; the rest
of it is :func:`neighbors_from_uniforms`, a function of the uniforms that
matches JAX's bit for bit on the same ``u``.

**Edge-sharded forms** (a ``DeviceMesh``), the JAX twin's ``shard_map``
body on each rank: node tensors split over the node axes ("pod", "data"),
edge tensors (features, senders, receivers: global node ids) over every
axis, parameters whole.  Each layer gathers the node states over the node
axes, computes its edges' messages, aggregates them into a whole-graph
partial, sums that over every axis and keeps its own nodes.  As in JAX the
sum runs over whatever the aggregator gives, so ``max`` and ``mean`` under
a mesh combine each rank's partial max or mean by a sum (ROADMAP Queue 3).
The loss is summed over the node axes as JAX's ``allsum`` does and each
rank differentiates its share of it (``dist.sharding.loss_total``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import collectives
from repro_torch.common.config import ConfigBase
from repro_torch.common.device import resolve_device
from repro_torch.common.prng import PRNGSeq
from repro_torch.common.pytree import tree_map, value_and_grad
from repro_torch.dist.sharding import batch_axes
from repro_torch.nn import layers
from repro_torch.optim.adam import adam_update


@dataclasses.dataclass(frozen=True)
class GNNConfig(ConfigBase):
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2          # hidden layers per MLP (paper: 2)
    aggregator: str = "sum"
    d_node_in: int = 16
    d_edge_in: int = 4
    d_out: int = 2
    task: str = "regression"     # regression | classification
    graph_readout: bool = False  # molecule: graph-level output
    fanout: tuple[int, ...] = (15, 10)
    layernorm: bool = True


def _mlp_dims(cfg: GNNConfig, d_in: int, d_out: int) -> tuple[int, ...]:
    return (d_in, *([cfg.d_hidden] * cfg.mlp_layers), d_out)


def _init_block(generator, cfg: GNNConfig, d_in: int, d_out: int, device):
    p = {"mlp": layers.init_mlp(generator, _mlp_dims(cfg, d_in, d_out), device=device)}
    if cfg.layernorm:
        p["ln"] = layers.init_layernorm(d_out, device=device)
    return p


def _block(p, x, activation="relu"):
    h = layers.mlp(p["mlp"], x, activation)
    if "ln" in p:
        h = layers.layernorm(p["ln"], h)
    return h


def init_gnn(generator: torch.Generator | int, cfg: GNNConfig, device="cuda"):
    """Parameters drawn from ``generator`` (or a seed) on ``device`` in the
    JAX twin's tree (the draws agree in law, not in bits); ``proc`` holds the
    processor layers stacked, each layer drawn into its slice."""
    dev = resolve_device(device)
    ks = PRNGSeq(generator, dev)
    dh = cfg.d_hidden
    params: dict[str, Any] = {
        "node_enc": _init_block(next(ks), cfg, cfg.d_node_in, dh, dev),
        "edge_enc": _init_block(next(ks), cfg, cfg.d_edge_in, dh, dev),
    }
    proc = None
    for i, g in enumerate(ks.take(cfg.n_layers)):
        g_edge, g_node = PRNGSeq(g, dev).take(2)
        one = {"edge": _init_block(g_edge, cfg, 3 * dh, dh, dev),
               "node": _init_block(g_node, cfg, 2 * dh, dh, dev)}
        if proc is None:
            proc = tree_map(lambda t: t.new_empty((cfg.n_layers, *t.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), proc, one)
    params["proc"] = proc
    params["decoder"] = {"mlp": layers.init_mlp(next(ks), _mlp_dims(cfg, dh, cfg.d_out),
                                                device=dev)}
    return params


# ---------------------------------------------------------------------------
# full-graph forward
# ---------------------------------------------------------------------------

def segment_sum(x, segments, n: int):
    """``jax.ops.segment_sum``: rows of ``x`` added into ``n`` segments, in
    one fixed order: ``index_put_(accumulate=True)`` sorts the segment ids
    (stably) on the card and adds each segment's rows in turn, where
    ``index_add`` adds them with atomics in no fixed order, so that a run
    repeats bit for bit (a ReLU at its kink turns on the sum's last bit)."""
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_put_((segments.long(),), x, accumulate=True)


def segment_max(x, segments, n: int):
    """``jax.ops.segment_max``: an empty segment stays at -inf."""
    idx = segments.long().view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    init = torch.full((n, *x.shape[1:]), float("-inf"), dtype=x.dtype, device=x.device)
    return init.scatter_reduce(0, idx, x, "amax", include_self=True)


def _aggregate(cfg: GNNConfig, msgs, receivers, n_nodes):
    if cfg.aggregator == "sum":
        return segment_sum(msgs, receivers, n_nodes)
    if cfg.aggregator == "max":
        return segment_max(msgs, receivers, n_nodes)
    if cfg.aggregator == "mean":
        s = segment_sum(msgs, receivers, n_nodes)
        c = segment_sum(torch.ones(receivers.shape, dtype=torch.float32,
                                   device=receivers.device), receivers, n_nodes)
        return s / torch.clamp(c[:, None], min=1.0)
    raise ValueError(cfg.aggregator)


def _layer(cfg, h, e, lp, senders, receivers):
    hs = h[senders]
    hr = h[receivers]
    e_new = e + _block(lp["edge"], torch.cat([e, hs, hr], dim=-1))
    agg = _aggregate(cfg, e_new, receivers, h.shape[0])
    return h + _block(lp["node"], torch.cat([h, agg], dim=-1)), e_new


def _forward_body(params, node_feat, edge_feat, senders, receivers, cfg: GNNConfig,
                  mesh=None):
    """Encode, ``n_layers`` message-passing layers (each recomputed in the
    backward under autograd), decode -> (N, d_out), or with a mesh this
    rank's (N_loc, d_out) (see the module docstring)."""
    h = _block(params["node_enc"], node_feat)
    e = _block(params["edge_enc"], edge_feat)
    grad = torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = tree_map(lambda t: t[i], params["proc"])
        args = (cfg, h, e, lp, senders, receivers)
        layer = _layer if mesh is None else _mesh_layer
        kw = {} if mesh is None else {"mesh": mesh}
        if grad:
            h, e = checkpoint(layer, *args, use_reentrant=False, **kw)
        else:
            h, e = layer(*args, **kw)
    return layers.mlp(params["decoder"]["mlp"], h)


def _mesh_layer(cfg, h_l, e, lp, senders, receivers, *, mesh):
    """One layer on a rank: node states gathered over the node axes, its
    edges' messages, the aggregate summed over every axis, its own nodes
    kept."""
    axes = batch_axes(mesh)
    h = h_l
    for a in reversed(axes):
        h = collectives.all_gather(h, mesh, a, 0)
    e_new = e + _block(lp["edge"], torch.cat([e, h[senders], h[receivers]], dim=-1))
    agg = collectives.psum(_aggregate(cfg, e_new, receivers, h.shape[0]), mesh,
                           collectives.axis_names(mesh))
    idx = 0
    for a in axes:
        idx = idx * collectives.axis_size(mesh, a) + collectives.axis_index(mesh, a)
    n_loc = h_l.shape[0]
    agg_l = agg[idx * n_loc:(idx + 1) * n_loc]
    return h_l + _block(lp["node"], torch.cat([h_l, agg_l], dim=-1)), e_new


def _loss_from_out(out, batch, cfg: GNNConfig, mesh=None):
    """The loss; with a mesh ``out`` and the node leaves of ``batch`` are this
    rank's nodes and the partial sums are summed over the node axes (JAX's
    ``allsum``)."""
    def allsum(x):
        return x if mesh is None else collectives.psum(x, mesh, batch_axes(mesh))

    if cfg.graph_readout:
        g = allsum(segment_sum(out, batch["graph_ids"], batch["graph_labels"].shape[0]))
        loss = torch.mean(torch.square(g - batch["graph_labels"]))
    elif cfg.task == "classification":
        logits = out.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
        mask = batch.get("label_mask", torch.ones_like(lse))
        loss = allsum(torch.sum((lse - gold) * mask)) / torch.clamp(allsum(torch.sum(mask)),
                                                                     min=1.0)
    else:
        mask = batch.get("label_mask", torch.ones(out.shape[0], dtype=out.dtype,
                                                   device=out.device))
        se = torch.sum(torch.square(out - batch["labels"]) * mask[:, None])
        loss = allsum(se) / torch.clamp(allsum(torch.sum(mask)) * out.shape[-1], min=1.0)
    if mesh is None:
        return loss
    from repro_torch.dist.sharding import loss_total

    # every rank holds the same loss: each differentiates 1/world of it
    return loss_total(loss / collectives.mesh_size(mesh), mesh)


def forward(params, node_feat, edge_feat, senders, receivers, cfg: GNNConfig, mesh=None):
    """Full-graph forward -> (N, d_out); with a mesh, this rank's nodes'
    rows from its blocks (see the module docstring)."""
    return _forward_body(params, node_feat, edge_feat, senders, receivers, cfg, mesh)


def loss_fn(params, batch, cfg: GNNConfig, mesh=None):
    out = _forward_body(params, batch["node_feat"], batch["edge_feat"],
                        batch["senders"], batch["receivers"], cfg, mesh)
    return _loss_from_out(out, batch, cfg, mesh)


def make_train_step(cfg: GNNConfig, mesh=None, lr: float = 1e-3):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).
    With a mesh the whole parameters' gradients are summed over every rank
    (``sync_grads``)."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(p, batch, cfg, mesh), params)
        if mesh is not None:
            from repro_torch.dist.sharding import GNN_RULES, spec_tree, sync_grads

            grads = sync_grads(grads, spec_tree(params, GNN_RULES), mesh)
        with torch.no_grad():
            params, opt_state, om = adam_update(grads, opt_state, params, lr=lr,
                                                grad_clip=1.0)
        return params, opt_state, {"loss": loss, **om}

    return step


# ---------------------------------------------------------------------------
# neighbor sampling (minibatch_lg): uniform fanout over CSR
# ---------------------------------------------------------------------------

def neighbors_from_uniforms(u, row_ptr, col_idx, nodes):
    """The sampler given its uniforms ``u`` (``(*nodes.shape, fanout)``
    fp32 in [0, 1)): neighbor ``floor(u * deg)`` of each node's incoming
    list; zero-degree nodes self-loop."""
    deg = row_ptr[nodes + 1] - row_ptr[nodes]
    off = torch.floor(u * torch.clamp(deg, min=1)[..., None]).to(row_ptr.dtype)
    idx = row_ptr[nodes][..., None] + off
    nbr = col_idx[torch.clamp(idx, max=col_idx.shape[0] - 1)]
    return torch.where((deg > 0)[..., None], nbr, nodes[..., None].to(nbr.dtype))


def sample_neighbors(generator: torch.Generator, row_ptr, col_idx, nodes, fanout: int):
    """Uniform-with-replacement fanout sample.  nodes: (...,) -> (..., fanout)."""
    u = torch.rand((*nodes.shape, fanout), generator=generator, device=nodes.device)
    return neighbors_from_uniforms(u, row_ptr, col_idx, nodes)


def _uniforms(draw, B: int, cfg: GNNConfig, device):
    """(u1, u2): given, or drawn from the generator ``draw``."""
    if isinstance(draw, torch.Generator):
        f1, f2 = cfg.fanout[0], cfg.fanout[1]
        return (torch.rand((B, f1), generator=draw, device=device),
                torch.rand((B, f1, f2), generator=draw, device=device))
    return draw


def sampled_forward(params, draw, batch, cfg: GNNConfig):
    """GraphSAGE-regime two-hop forward for seed nodes.

    batch: {row_ptr, col_idx, node_feat (N, d), seeds (B,)} -> (B, d_out).
    ``draw``: a ``torch.Generator`` (on the batch's device), or the
    uniforms ``(u1 (B, f1), u2 (B, f1, f2))`` it would draw.  Uses the
    encoder + first two processor-layer node MLPs as the two aggregation
    levels (weight-shared with the full-graph model)."""
    seeds = batch["seeds"]
    u1, u2 = _uniforms(draw, seeds.shape[0], cfg, seeds.device)
    n1 = neighbors_from_uniforms(u1, batch["row_ptr"], batch["col_idx"], seeds)   # (B, f1)
    n2 = neighbors_from_uniforms(u2, batch["row_ptr"], batch["col_idx"], n1)      # (B, f1, f2)

    enc = lambda x: _block(params["node_enc"], x)
    h_seed = enc(batch["node_feat"][seeds])
    h1 = enc(batch["node_feat"][n1])
    h2 = enc(batch["node_feat"][n2])

    lp0 = tree_map(lambda x: x[0], params["proc"])
    lp1 = tree_map(lambda x: x[1], params["proc"])
    agg2 = torch.sum(h2, dim=2)  # (B, f1, d)
    h1 = h1 + _block(lp0["node"], torch.cat([h1, agg2], dim=-1))
    agg1 = torch.sum(h1, dim=1)  # (B, d)
    h_seed = h_seed + _block(lp1["node"], torch.cat([h_seed, agg1], dim=-1))
    return layers.mlp(params["decoder"]["mlp"], h_seed)


def make_sampled_train_step(cfg: GNNConfig, lr: float = 1e-3, *, mesh=None):
    """Returns step(params, opt_state, draw, batch) -> (params, opt_state,
    metrics); ``draw`` as in :func:`sampled_forward`.  With a mesh (the
    dry-run cell's data parallelism: the JAX twin lets GSPMD split the
    seeds) each rank passes its seeds and labels, the loss is the mean over
    every rank's seeds and the gradients are summed over the ranks."""

    def step(params, opt_state, draw, batch):
        uniforms = _uniforms(draw, batch["seeds"].shape[0], cfg, batch["seeds"].device)

        def lf(p):
            out = sampled_forward(p, uniforms, batch, cfg).float()
            if cfg.task == "classification":
                lse = torch.logsumexp(out, dim=-1)
                gold = out.gather(-1, batch["labels"].long()[:, None])[:, 0]
                terms = lse - gold
            else:
                terms = torch.square(out - batch["labels"])
            if mesh is None:
                return torch.mean(terms)
            from repro_torch.dist.sharding import loss_total

            return loss_total(terms.sum() / (terms.numel() * collectives.mesh_size(mesh)), mesh)

        loss, grads = value_and_grad(lf, params)
        if mesh is not None:
            from repro_torch.dist.sharding import GNN_RULES, spec_tree, sync_grads

            grads = sync_grads(grads, spec_tree(params, GNN_RULES), mesh)
        with torch.no_grad():
            params, opt_state, om = adam_update(grads, opt_state, params, lr=lr,
                                                grad_clip=1.0)
        return params, opt_state, {"loss": loss, **om}

    return step
