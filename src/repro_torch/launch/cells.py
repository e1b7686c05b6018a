"""Dry-run cell builders: one (architecture x input shape) pair = one Cell
(twin of ``repro/launch/cells.py``).

A Cell packages what ``launch/dryrun.py`` needs to run one rank's step
without real data: the step function, the arguments as whole (global)
tensors on the ``meta`` device (the twin of ``jax.eval_shape``: drawn by the
real init and input builders, never allocated), and their partition specs
(trees of ``dist.sharding.P``) from the family's rules.  The step takes a
rank's blocks (``dist.sharding.local_block`` / ``local_shape`` of each
argument under its spec) on the mesh it was built for.

Where the port lays an argument out otherwise than the JAX cell, the spec
says so: the LM's token ids and labels enter whole on every rank (each
rank takes its rows, ``models.lm.mesh_layout``); the LEMUR state holds the
port's row map and fp32 scales, and its index step reads fp32 doc tokens.

Families: lm (train/prefill/decode), gnn (full/sampled/batched), recsys
(train/serve/retrieval), lemur (index/serve).
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Callable

import torch

from repro_torch.common import collectives
from repro_torch.common.pytree import tree_map, tree_map_with_name
from repro_torch.dist.sharding import (
    RECSYS_RULES,
    STACK_RE,
    P,
    _resolve_spec,
    axis_sizes,
    spec_tree,
)
from repro_torch.launch.mesh import batch_axes
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import recsys as recsys_mod

META = torch.device("meta")

__all__ = ["Cell", "STACK_RE", "_resolve_spec", "lm_train_cell", "lm_prefill_cell",
           "lm_decode_cell", "gnn_full_cell", "gnn_sampled_cell", "recsys_cell",
           "recsys_retrieval_cell", "lemur_serve_cell", "lemur_index_cell"]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable            # positional-args step function on a rank's blocks
    args: tuple             # pytrees of whole tensors on the meta device
    in_shardings: tuple     # pytrees of P, one an argument
    out_shardings: Any      # pytrees of P, or None
    donate_argnums: tuple = ()


def _n_devices(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def _n_batch(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def _whole(tree):
    return tree_map(lambda _: P(), tree)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _opt_shardings(rules, opt_s):
    """Moments follow their parameter's spec; scalars whole.  Works for both
    OptState (mu/nu mirror params) and Opt8State (a Q8's ``q`` mirrors the
    parameter; its per-row scales take the parameter's spec minus its last
    axis)."""

    def resolve(name, x):
        if x.dim() == 0:
            return P()
        for pre in ("mu/", "nu/"):
            if name.startswith(pre):
                name = name[len(pre):]
        if name.endswith("/q"):
            return _resolve_spec(rules, name[:-2], x.dim())
        if name.endswith("/scale") and "ln" not in name and "norm" not in name:
            spec = _resolve_spec(rules, name[: -len("/scale")], x.dim() + 1)
            return P(*spec[: x.dim()])
        return _resolve_spec(rules, name, x.dim())

    return tree_map_with_name(resolve, opt_s)


def lm_train_cell(arch, cfg: lm_mod.LMConfig, *, seq: int, global_batch: int,
                  mesh, use_adam8: bool = False) -> Cell:
    from repro_torch.dist.sharding import global_norm

    rules = lm_mod.lm_rules(cfg)
    params_s = lm_mod.init_lm(0, cfg, device=META)
    if use_adam8:
        from repro_torch.optim.adam8bit import adam8_init, adam8_update

        opt_s = adam8_init(params_s)

        def step(params, opt, batch):
            (_, (loss, aux)), grads = lm_mod.value_and_grad(
                params, batch["tokens"], batch["labels"], cfg, mesh)
            norm = global_norm(grads, lm_mod.lm_specs(cfg, params), mesh)
            with torch.no_grad():
                params, opt, m = adam8_update(grads, opt, params, grad_norm=norm)
            return params, opt, {"loss": loss, **m}
    else:
        from repro_torch.optim.adam import adam_init

        opt_s = adam_init(params_s, moment_dtype=torch.float32)
        step = lm_mod.make_train_step(cfg, mesh)
    tokens = _meta((global_batch, seq), torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    psh = spec_tree(params_s, rules)
    osh = _opt_shardings(rules, opt_s)
    bsh = {"tokens": P(), "labels": P()}
    return Cell(arch, f"train_{seq}", "train", step, (params_s, opt_s, batch),
                (psh, osh, bsh), None, donate_argnums=(0, 1))


def lm_prefill_cell(arch, cfg: lm_mod.LMConfig, *, seq: int, global_batch: int,
                    mesh) -> Cell:
    ba = batch_axes(mesh)
    params_s = lm_mod.init_lm(0, cfg, device=META)
    tokens = _meta((global_batch, seq), torch.int32)
    cache_len = seq + 128

    @torch.no_grad()
    def step(params, tokens):
        return lm_mod.prefill(params, tokens, cfg, cache_len, mesh)

    psh = spec_tree(params_s, lm_mod.lm_rules(cfg))
    caches_s = lm_mod.init_cache(cfg, global_batch, cache_len, device=META)
    csh = lm_mod.cache_specs(cfg, mesh, global_batch, caches_s)
    out_sh = (P(ba, None), csh)
    return Cell(arch, f"prefill_{seq}", "prefill", step, (params_s, tokens),
                (psh, P()), out_sh)


def lm_decode_cell(arch, cfg: lm_mod.LMConfig, *, seq: int, global_batch: int,
                   mesh) -> Cell:
    ba = batch_axes(mesh)
    params_s = lm_mod.init_lm(0, cfg, device=META)
    caches_s = lm_mod.init_cache(cfg, global_batch, seq, device=META)
    token = _meta((global_batch, 1), torch.int32)

    @torch.no_grad()
    def step(params, token, caches):
        logits, new_caches = lm_mod.decode(params, token, caches, seq, cfg, mesh)
        return torch.argmax(logits, dim=-1).to(torch.int32), new_caches

    psh = spec_tree(params_s, lm_mod.lm_rules(cfg))
    csh = lm_mod.cache_specs(cfg, mesh, global_batch, caches_s)
    split = global_batch % _n_batch(mesh) == 0 and global_batch >= _n_batch(mesh)
    out_sh = (P(ba) if split else P(), csh)
    return Cell(arch, f"decode_{seq}", "decode", step, (params_s, token, caches_s),
                (psh, P(), csh), out_sh, donate_argnums=(2,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_state(cfg):
    from repro_torch.optim.adam import adam_init

    params = gnn_mod.init_gnn(0, cfg, device=META)
    return params, adam_init(params)


def gnn_full_cell(arch, cfg: gnn_mod.GNNConfig, *, n_nodes: int, n_edges: int,
                  mesh, n_graphs: int = 0) -> Cell:
    axes = tuple(axis_sizes(mesh))
    node_axes = batch_axes(mesh)
    nd = _n_devices(mesh)
    nn_shards = _n_batch(mesh)
    n_edges = -(-n_edges // nd) * nd                  # pad edges to the mesh
    n_nodes = -(-n_nodes // nn_shards) * nn_shards    # pad nodes (masked in the loss)
    f32, i32 = torch.float32, torch.int32
    batch = {
        "node_feat": _meta((n_nodes, cfg.d_node_in), f32),
        "edge_feat": _meta((n_edges, cfg.d_edge_in), f32),
        "senders": _meta((n_edges,), i32),
        "receivers": _meta((n_edges,), i32),
        "label_mask": _meta((n_nodes,), f32),
    }
    if cfg.graph_readout:
        batch["graph_ids"] = _meta((n_nodes,), i32)
        batch["graph_labels"] = _meta((n_graphs, cfg.d_out), f32)
        del batch["label_mask"]
    elif cfg.task == "classification":
        batch["labels"] = _meta((n_nodes,), i32)
    else:
        batch["labels"] = _meta((n_nodes, cfg.d_out), f32)
    params_s, opt_s = _gnn_state(cfg)
    step = gnn_mod.make_train_step(cfg, mesh)
    bsh = {k: P(node_axes) for k in batch}
    for k in ("edge_feat", "senders", "receivers"):
        bsh[k] = P(axes)
    if "graph_labels" in batch:
        bsh["graph_labels"] = P()
    return Cell(arch, f"full_{n_nodes}", "train", step, (params_s, opt_s, batch),
                (_whole(params_s), _whole(opt_s), bsh), None, donate_argnums=(0, 1))


def gnn_sampled_cell(arch, cfg: gnn_mod.GNNConfig, *, n_nodes: int, n_edges: int,
                     batch_nodes: int, d_feat: int, mesh) -> Cell:
    ba = batch_axes(mesh)
    i32 = torch.int32
    batch = {
        "row_ptr": _meta((n_nodes + 1,), i32),
        "col_idx": _meta((n_edges,), i32),
        "node_feat": _meta((n_nodes, d_feat), torch.float32),
        "seeds": _meta((batch_nodes,), i32),
        "labels": _meta((batch_nodes,), i32),
    }
    params_s, opt_s = _gnn_state(cfg)
    base = gnn_mod.make_sampled_train_step(cfg, mesh=mesh)

    def step(p, o, b):
        dev, n = b["seeds"].device, b["seeds"].shape[0]
        if dev.type == "meta":     # a meta tensor draws nothing: its uniforms' shapes
            f1, f2 = cfg.fanout[0], cfg.fanout[1]
            draw = (torch.empty((n, f1), device=dev), torch.empty((n, f1, f2), device=dev))
        else:
            draw = torch.Generator(device=dev).manual_seed(7)
        return base(p, o, draw, b)

    bsh = {k: P() for k in batch}
    bsh["seeds"] = P(ba)
    bsh["labels"] = P(ba)
    return Cell(arch, "sampled", "train", step, (params_s, opt_s, batch),
                (_whole(params_s), _whole(opt_s), bsh), None, donate_argnums=(0, 1))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch_spec(cfg: recsys_mod.RecsysConfig, batch: int):
    i32, f32 = torch.int32, torch.float32
    if cfg.model == "bst":
        return {"history": _meta((batch, cfg.seq_len), i32),
                "target_item": _meta((batch,), i32),
                "labels": _meta((batch,), f32)}
    if cfg.model == "two_tower":
        return {"ids": _meta((batch, cfg.n_fields), i32),
                "item": _meta((batch,), i32),
                "labels": _meta((batch,), f32)}
    return {"ids": _meta((batch, cfg.n_fields), i32), "labels": _meta((batch,), f32)}


def _rows_specs(mesh, batch_spec):
    ba = batch_axes(mesh)
    return tree_map(lambda x: P(ba) if x.dim() == 1 else P(ba, None), batch_spec)


def recsys_cell(arch, cfg: recsys_mod.RecsysConfig, *, batch: int, mesh,
                kind: str) -> Cell:
    from repro_torch.optim.adam import adam_init

    batch_spec = _recsys_batch_spec(cfg, batch)
    params_s = recsys_mod.init_recsys(0, cfg, device=META)
    opt_s = adam_init(params_s)
    psh = spec_tree(params_s, RECSYS_RULES)
    osh = _opt_shardings(RECSYS_RULES, opt_s)
    if kind == "train":
        step = recsys_mod.make_train_step(cfg, mesh)
        return Cell(arch, f"train_{batch}", "train", step,
                    (params_s, opt_s, batch_spec), (psh, osh, _rows_specs(mesh, batch_spec)),
                    None, donate_argnums=(0, 1))
    chunk = 32768 if batch > 65536 else 0
    serve = recsys_mod.make_serve_step(cfg, mesh, chunk=chunk)
    batch_spec.pop("labels", None)
    return Cell(arch, f"serve_{batch}", "serve", lambda p, b: serve(p, b),
                (params_s, batch_spec), (psh, _rows_specs(mesh, batch_spec)),
                P(batch_axes(mesh)))


def _merge_rows(mesh, axes, scores, ids, k: int):
    """The top-k of every rank's (k,) candidates over ``axes``, ties to the
    lower position (the ranks' order, then each rank's)."""
    from repro_torch.anns.base import stable_topk

    for a in axes:
        scores = collectives.all_gather(scores, mesh, a, 0)
        ids = collectives.all_gather(ids, mesh, a, 0)
        scores, pos = stable_topk(scores, min(k, scores.shape[0]))
        ids = ids[pos]
    return scores, ids


def recsys_retrieval_cell(arch, cfg: recsys_mod.RecsysConfig, *, n_candidates: int,
                          mesh, k: int = 100) -> Cell:
    axes = tuple(axis_sizes(mesh))
    params_s = recsys_mod.init_recsys(0, cfg, device=META)
    psh = spec_tree(params_s, RECSYS_RULES)
    nd = _n_devices(mesh)
    pad_to = math.lcm(nd, 65536) if cfg.model != "two_tower" else nd
    n_candidates = -(-n_candidates // pad_to) * pad_to   # pad to the mesh (and the chunk)
    if cfg.model == "two_tower":
        batch_spec = {"ids": _meta((1, cfg.n_fields), torch.int32)}
        cand = _meta((n_candidates, cfg.out_dim), torch.float32)
        step = recsys_mod.make_retrieval_step(cfg, mesh, k=k)
        return Cell(arch, "retrieval", "retrieval", step, (params_s, batch_spec, cand),
                    (psh, {"ids": P()}, P(axes, None)), (P(), P()))

    # CTR models: bulk-score one user against n_candidates items
    serve = recsys_mod.make_serve_step(cfg, mesh, chunk=65536)
    ba = batch_axes(mesh)
    if cfg.model == "bst":
        batch_spec = {"history": _meta((n_candidates, cfg.seq_len), torch.int32),
                      "target_item": _meta((n_candidates,), torch.int32)}
    else:
        batch_spec = {"ids": _meta((n_candidates, cfg.n_fields), torch.int32)}

    @torch.no_grad()
    def step(params, batch):
        from repro_torch.anns.base import stable_topk

        scores = serve(params, batch)
        top, ids = stable_topk(scores, min(k, scores.shape[0]))
        row0 = 0
        for a in ba:
            row0 = row0 * collectives.axis_size(mesh, a) + collectives.axis_index(mesh, a)
        return _merge_rows(mesh, ba, top, ids + row0 * scores.shape[0], k)

    return Cell(arch, "retrieval", "retrieval", step, (params_s, batch_spec),
                (psh, _rows_specs(mesh, batch_spec)), None)


# ---------------------------------------------------------------------------
# LEMUR cells (the paper's own serving and indexing over the production mesh)
# ---------------------------------------------------------------------------

def _psi_tree(d: int, d_prime: int):
    return {"dense": {"kernel": _meta((d, d_prime), torch.float32),
                      "bias": _meta((d_prime,), torch.float32)},
            "ln": {"scale": _meta((d_prime,), torch.float32),
                   "bias": _meta((d_prime,), torch.float32)}}


def _psi_of(tree):
    """The attributes ``core.model.pool_queries`` reads, from the psi tree."""
    return SimpleNamespace(dense=SimpleNamespace(**tree["dense"]),
                           ln=SimpleNamespace(**tree["ln"]))


def lemur_serve_cell(arch, cfg, *, m: int, doc_tokens: int, q_tokens: int,
                     batch: int, mesh) -> Cell:
    from repro_torch.core import distributed as dist

    nd = _n_devices(mesh)
    m = -(-m // nd) * nd  # pad the corpus to the mesh
    sq8 = cfg.ivf.sq8
    codes = torch.int8 if sq8 else torch.float32
    state_s = dist.ShardedRetrievalState(
        psi=_psi_tree(cfg.d, cfg.d_prime),
        W=_meta((m, cfg.d_prime), codes),
        doc_tokens=_meta((m, doc_tokens, cfg.d), codes),
        doc_mask=_meta((m, doc_tokens), torch.bool),
        row_ids=_meta((m,), torch.int32),
        row_valid=_meta((m,), torch.bool),
        W_scales=_meta((m,), torch.float32) if sq8 else None,
        doc_scales=_meta((m, doc_tokens), torch.float32) if sq8 else None,
    )
    q = _meta((batch, q_tokens, cfg.d), torch.float32)
    qm = _meta((batch, q_tokens), torch.bool)
    serve = dist.make_serve_step(mesh, cfg)

    @torch.no_grad()
    def step(state, q, qm):
        return serve(state._replace(psi=_psi_of(state.psi)), q, qm)

    return Cell(arch, "serve", "lemur_serve", step, (state_s, q, qm),
                (dist.state_shardings(mesh, state_s), P(), P()), (P(), P()))


def lemur_index_cell(arch, cfg, *, m: int, doc_tokens: int, mesh) -> Cell:
    from repro_torch.core import distributed as dist

    axes = tuple(axis_sizes(mesh))
    nd = _n_devices(mesh)
    m = -(-m // nd) * nd
    dpr, npts = cfg.d_prime, cfg.n_ols
    f32 = torch.float32
    args = (
        _meta((dpr, dpr), f32),                     # Cholesky factor
        _meta((npts, dpr), f32),                    # feats
        _meta((npts, cfg.d), f32),                  # x_ols
        _meta((m, doc_tokens, cfg.d), f32),
        _meta((m, doc_tokens), torch.bool),
        _meta((), f32),
        _meta((), f32),
    )
    index = dist.make_index_step(mesh, cfg)

    @torch.no_grad()
    def step(*a):
        return index(*a)

    corpus = P(axes)
    return Cell(arch, "index", "lemur_index", step, args,
                (P(), P(), P(), corpus, corpus, P(), P()), corpus)
