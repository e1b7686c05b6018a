"""RecSys family: DeepFM, xDeepFM (CIN), BST, two-tower retrieval (twin of
``repro/models/recsys.py``).

Parameters are nested dicts of tensors with the JAX package's leaf names,
so ``common.pytree.named_leaves`` gives JAX's names and ``convert`` is a
leaf-by-leaf copy.  One combined table holds all fields (ids are
field-offset, FBGEMM-style).

The embedding gradient is dense, as JAX's gradient of ``jnp.take`` is: the
lookup is ``table[ids]``, whose backward writes a zero table and adds the
looked-up rows' gradients into it.  Adam then moves every row each step
(its first moment decays on rows no id touched); a sparse or lazy Adam
would be another result (ROADMAP Queue 3).

xDeepFM's CIN layer is ``einsum("bid,bjd,hij->bhd")``, which materialises
the (B, H_k, F, d) outer product on any contraction path (about 20 GB at a
batch of 65,536 and full width).  The port runs it a chunk of rows at a
time under ``torch.utils.checkpoint``, so no more than ``CIN_CHUNK_ELEMS``
elements of it live at once, forward or backward.

**Mesh forms.**  With a ``DeviceMesh`` every rank passes its blocks:
parameters cut by ``dist.sharding.RECSYS_RULES`` (the tables' rows over
``"model"``, the two-tower MLP kernels' columns over ``"model"``, the rest
whole) and its rows of the batch (split over the batch axes ("pod",
"data"); whole where the batch does not divide them, as JAX replicates
it).  A table lookup is the JAX twin's ``shard_map`` body: each rank takes
the rows it holds, zeros elsewhere, and a sum over ``"model"`` combines
them; a two-tower kernel is gathered whole for its product.  A loss is the
sum over ranks of each rank's share (``dist.sharding.loss_total``): its
rows' sum over the count of every rank's rows, replicas included, so each
rank differentiates its share and ``sync_grads`` completes the gradient.
The two-tower loss's in-batch softmax gathers the items over the batch
axes (its batch must split over them).  ``make_retrieval_step`` scores its
block of the candidates, keeps a local top-k and merges over every axis
(``dist.serve.merge``); ties break by (score descending, index ascending).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import collectives
from repro_torch.common.config import ConfigBase
from repro_torch.common.device import resolve_device
from repro_torch.common.prng import PRNGSeq
from repro_torch.common.pytree import tree_leaves, tree_map_with_name, value_and_grad
from repro_torch.dist.sharding import batch_axes
from repro_torch.nn import attention, layers
from repro_torch.optim.adam import adam_update

#: elements of the CIN's (rows, H_k, F, d) outer product held at once
CIN_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class RecsysConfig(ConfigBase):
    name: str = "deepfm"
    model: str = "deepfm"            # deepfm | xdeepfm | bst | two_tower
    vocab_sizes: tuple[int, ...] = (1000,) * 39
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    # xDeepFM
    cin_dims: tuple[int, ...] = (200, 200, 200)
    # BST
    seq_len: int = 20
    n_heads: int = 8
    n_blocks: int = 1
    n_items: int = 2_000_000
    # two-tower
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    out_dim: int = 256
    temperature: float = 0.05

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)


# ---------------------------------------------------------------------------
# embedding substrate
# ---------------------------------------------------------------------------

def sharded_embedding_lookup(table, ids, mesh, *, batch_axes=("pod", "data")):
    """table: this rank's (V / |model|, d) block of rows; ids: the rank's
    (B_loc, ...) global ids -> (B_loc, ..., d).  ``batch_axes`` is the JAX
    twin's; here the ids are already the rank's rows (whole where the batch
    does not divide the batch axes)."""
    from repro_torch.dist.sharding import row_block_lookup

    del batch_axes
    return row_block_lookup(table, ids, mesh)


def embedding_lookup(table, ids, mesh=None):
    """table: (V, d) (with a mesh, this rank's block of rows); ids: (B, ...)
    -> (B, ..., d); a dense gradient."""
    if mesh is None or "model" not in collectives.axis_names(mesh):
        return table[ids]
    return sharded_embedding_lookup(table, ids, mesh)


def _whole(tree, prefix: str, mesh):
    """A parameter subtree gathered whole from its blocks (by its rules)."""
    if mesh is None:
        return tree
    from repro_torch.dist.sharding import RECSYS_RULES, gather_block, resolve_spec

    return tree_map_with_name(lambda n, x: gather_block(
        x, resolve_spec(RECSYS_RULES, f"{prefix}/{n}", x.dim()), mesh), tree)


def embedding_bag(table, ids, mesh=None, *, combiner: str = "mean", pad_id: int = 0):
    """Multi-hot bag: ids (B, L) -> (B, d) with mean/sum over valid (id != pad)."""
    e = embedding_lookup(table, ids, mesh)                  # (B, L, d)
    mask = (ids != pad_id)[..., None].to(e.dtype)
    s = torch.sum(e * mask, dim=-2)
    if combiner == "sum":
        return s
    return s / torch.clamp(torch.sum(mask, dim=-2), min=1.0)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_recsys(generator: torch.Generator | int, cfg: RecsysConfig, device="cuda"):
    """Parameters drawn from ``generator`` (or a seed) on ``device``, in the
    JAX twin's tree and key order (the draws agree in law, not in bits)."""
    dev = resolve_device(device)
    ks = PRNGSeq(generator, dev)
    d = cfg.embed_dim
    params: dict[str, Any] = {}
    if cfg.model in ("deepfm", "xdeepfm"):
        params["table"] = layers.init_embedding(next(ks), cfg.total_vocab, d, device=dev)
        params["first_order"] = layers.init_embedding(next(ks), cfg.total_vocab, 1, device=dev)
        params["bias"] = torch.zeros((), device=dev)
        deep_in = cfg.n_fields * d
        params["deep"] = layers.init_mlp(next(ks), (deep_in, *cfg.mlp_dims, 1), device=dev)
        if cfg.model == "xdeepfm":
            dims = (cfg.n_fields, *cfg.cin_dims)
            params["cin"] = {
                f"layer_{i}": layers.variance_scaling(
                    next(ks), (dims[i + 1], dims[i], cfg.n_fields), device=dev)
                for i in range(len(cfg.cin_dims))
            }
            params["cin_out"] = layers.init_dense(next(ks), sum(cfg.cin_dims), 1, True,
                                                  device=dev)
    elif cfg.model == "bst":
        params["item_table"] = layers.init_embedding(next(ks), cfg.n_items, d, device=dev)
        params["pos_table"] = layers.init_embedding(next(ks), cfg.seq_len + 1, d, device=dev)
        params["blocks"] = {}
        for b in range(cfg.n_blocks):
            params["blocks"][f"block_{b}"] = {
                "attn": attention.init_gqa(next(ks), d, cfg.n_heads, cfg.n_heads,
                                           max(1, d // cfg.n_heads), device=dev),
                "ln1": layers.init_layernorm(d, device=dev),
                "ln2": layers.init_layernorm(d, device=dev),
                "ffn": layers.init_ffn(next(ks), d, 4 * d, gated=False, use_bias=True,
                                       device=dev),
            }
        mlp_in = (cfg.seq_len + 1) * d
        params["mlp"] = layers.init_mlp(next(ks), (mlp_in, *cfg.mlp_dims, 1), device=dev)
    elif cfg.model == "two_tower":
        params["user_table"] = layers.init_embedding(next(ks), cfg.total_vocab, d, device=dev)
        params["item_table"] = layers.init_embedding(next(ks), cfg.n_items, d, device=dev)
        user_in = cfg.n_fields * d
        params["user_tower"] = layers.init_mlp(
            next(ks), (user_in, *cfg.tower_dims, cfg.out_dim), device=dev)
        params["item_tower"] = layers.init_mlp(
            next(ks), (d, *cfg.tower_dims, cfg.out_dim), device=dev)
    else:
        raise ValueError(cfg.model)
    return params


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _offset_ids(cfg: RecsysConfig, ids):
    return ids + torch.as_tensor(cfg.field_offsets, dtype=ids.dtype, device=ids.device)[None, :]


def deepfm_forward(params, ids, cfg: RecsysConfig, mesh=None):
    """ids: (B, F) per-field ids (unoffset) -> logits (B,)."""
    gids = _offset_ids(cfg, ids)
    emb = embedding_lookup(params["table"]["embedding"], gids, mesh)   # (B, F, d)
    first = embedding_lookup(params["first_order"]["embedding"], gids, mesh)[..., 0]
    sum_v = torch.sum(emb, dim=1)
    fm = 0.5 * torch.sum(torch.square(sum_v) - torch.sum(torch.square(emb), dim=1), dim=-1)
    deep = layers.mlp(params["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    return params["bias"] + torch.sum(first, dim=1) + fm + deep


def _cin_rows(xk, x0, w):
    """One CIN layer on a chunk of rows: sum_ij w[h, i, j] xk[b, i, :] x0[b, j, :]."""
    z = xk[:, :, None, :] * x0[:, None, :, :]                          # (b, Hk, F, d)
    return w.reshape(w.shape[0], -1) @ z.reshape(z.shape[0], -1, z.shape[-1])


def cin_layer(xk, x0, w):
    """``einsum("bid,bjd,hij->bhd", xk, x0, w)``, ``CIN_CHUNK_ELEMS`` of the
    outer product at a time (recomputed in the backward under autograd)."""
    B, Hk, d = xk.shape
    rows = max(1, CIN_CHUNK_ELEMS // (Hk * x0.shape[1] * d))
    if B <= rows:
        return _cin_rows(xk, x0, w)
    grad = torch.is_grad_enabled()
    outs = []
    for s in range(0, B, rows):
        args = (xk[s:s + rows], x0[s:s + rows], w)
        outs.append(checkpoint(_cin_rows, *args, use_reentrant=False) if grad
                    else _cin_rows(*args))
    return torch.cat(outs)


def xdeepfm_forward(params, ids, cfg: RecsysConfig, mesh=None):
    gids = _offset_ids(cfg, ids)
    emb = embedding_lookup(params["table"]["embedding"], gids, mesh)   # (B, F, d)
    first = embedding_lookup(params["first_order"]["embedding"], gids, mesh)[..., 0]
    # CIN (arXiv:1803.05170 eq. 6): x^{k+1}_h = sum_ij W^k_{h,i,j} (x^k_i ∘ x^0_j)
    x0, xk = emb, emb
    pools = []
    for i in range(len(cfg.cin_dims)):
        xk = cin_layer(xk, x0, params["cin"][f"layer_{i}"])            # (B, H, d)
        pools.append(torch.sum(xk, dim=-1))                            # (B, H)
    cin = layers.dense(params["cin_out"], torch.cat(pools, dim=-1))[:, 0]
    deep = layers.mlp(params["deep"], emb.reshape(emb.shape[0], -1))[:, 0]
    return params["bias"] + torch.sum(first, dim=1) + cin + deep


def bst_forward(params, history, target_item, cfg: RecsysConfig, mesh=None):
    """history: (B, L); target_item: (B,) -> logits (B,)."""
    B, L = history.shape
    seq = torch.cat([history, target_item[:, None]], dim=1)            # (B, L+1)
    e = embedding_lookup(params["item_table"]["embedding"], seq, mesh)
    e = e + params["pos_table"]["embedding"][None, : L + 1]
    for b in range(cfg.n_blocks):
        blk = params["blocks"][f"block_{b}"]
        h = layers.layernorm(blk["ln1"], e)
        q = torch.einsum("btd,dhk->bthk", h, blk["attn"]["wq"])
        k = torch.einsum("btd,dhk->bthk", h, blk["attn"]["wk"])
        v = torch.einsum("btd,dhk->bthk", h, blk["attn"]["wv"])
        s = torch.einsum("bthk,bshk->bhts", q, k) / np.sqrt(q.shape[-1] * 1.0)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhts,bshk->bthk", a, v)
        e = e + torch.einsum("bthk,hkd->btd", o, blk["attn"]["wo"])
        h = layers.layernorm(blk["ln2"], e)
        e = e + layers.ffn(blk["ffn"], h, "gelu")
    return layers.mlp(params["mlp"], e.reshape(B, -1), activation="relu")[:, 0]


def _unit_rows(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def two_tower_user(params, ids, cfg: RecsysConfig, mesh=None):
    gids = _offset_ids(cfg, ids)
    emb = embedding_lookup(params["user_table"]["embedding"], gids, mesh)
    tower = _whole(params["user_tower"], "user_tower", mesh)
    return _unit_rows(layers.mlp(tower, emb.reshape(emb.shape[0], -1)))


def two_tower_item(params, item_ids, cfg: RecsysConfig, mesh=None):
    e = embedding_lookup(params["item_table"]["embedding"], item_ids, mesh)
    return _unit_rows(layers.mlp(_whole(params["item_tower"], "item_tower", mesh), e))


FORWARDS = {
    "deepfm": deepfm_forward,
    "xdeepfm": xdeepfm_forward,
}


# ---------------------------------------------------------------------------
# losses / steps
# ---------------------------------------------------------------------------

def _bce_terms(logits, labels):
    logits = logits.float()
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_loss(logits, labels):
    return torch.mean(_bce_terms(logits, labels))


def _mean_over_mesh(terms, mesh):
    """The mean of every rank's rows of ``terms``: the sum of each rank's
    share, its rows' sum over the count of all ranks' rows (every rank has
    as many, replicas included)."""
    from repro_torch.dist.sharding import loss_total

    world = collectives.mesh_size(mesh)
    return loss_total(terms.sum() / (terms.numel() * world), mesh)


def ctr_loss(params, batch, cfg: RecsysConfig, mesh=None):
    if cfg.model == "bst":
        logits = bst_forward(params, batch["history"], batch["target_item"], cfg, mesh)
    else:
        logits = FORWARDS[cfg.model](params, batch["ids"], cfg, mesh)
    if mesh is None:
        return bce_loss(logits, batch["labels"])
    return _mean_over_mesh(_bce_terms(logits, batch["labels"]), mesh)


def _gather_rows(x, mesh):
    """Every rank's rows over the batch axes, in the global order."""
    for a in reversed(batch_axes(mesh)):
        x = collectives.all_gather(x, mesh, a, 0)
    return x


def two_tower_loss(params, batch, cfg: RecsysConfig, mesh=None):
    """In-batch sampled softmax with logQ correction (Yi et al. RecSys'19).
    With a mesh the batch rows are split over the batch axes; the items and
    ``logq`` are gathered over them for the (B_loc, B) logits."""
    u = two_tower_user(params, batch["ids"], cfg, mesh)         # (B, D)
    v = two_tower_item(params, batch["item"], cfg, mesh)        # (B, D)
    logq = batch.get("logq")
    offset = 0
    if mesh is not None:
        v = _gather_rows(v, mesh)
        logq = None if logq is None else _gather_rows(logq, mesh)
        for a in batch_axes(mesh):
            offset = offset * collectives.axis_size(mesh, a) + collectives.axis_index(mesh, a)
        offset *= u.shape[0]
    logits = (u @ v.T) / cfg.temperature                        # (B_loc, B)
    if logq is not None:
        logits = logits - logq[None, :]
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits[torch.arange(u.shape[0], device=u.device),
                  torch.arange(u.shape[0], device=u.device) + offset]
    if mesh is None:
        return torch.mean(lse - gold)
    return _mean_over_mesh(lse - gold, mesh)


def make_train_step(cfg: RecsysConfig, mesh=None, lr: float = 1e-3):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics):
    the loss's gradient by autograd, then ``adam_update(lr, grad_clip=1.0)``.
    With a mesh, on this rank's blocks: the gradient summed over the ranks
    that hold each block (``sync_grads``) and clipped by the global norm."""
    lf = two_tower_loss if cfg.model == "two_tower" else ctr_loss

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: lf(p, batch, cfg, mesh), params)
        norm = None
        if mesh is not None:
            from repro_torch.dist.sharding import (RECSYS_RULES, global_norm, spec_tree,
                                                   sync_grads)

            specs = spec_tree(params, RECSYS_RULES)
            grads = sync_grads(grads, specs, mesh)
            norm = global_norm(grads, specs, mesh)
        with torch.no_grad():
            params, opt_state, om = adam_update(grads, opt_state, params, lr=lr,
                                                grad_clip=1.0, grad_norm=norm)
        return params, opt_state, {"loss": loss, **om}

    return step


def make_serve_step(cfg: RecsysConfig, mesh=None, *, chunk: int = 0):
    """Pointwise scoring step.  ``chunk`` > 0 streams the batch through
    fixed-size tiles, one after another (bounds the CIN/MLP activation
    footprint for the bulk-scoring cells; the JAX twin's ``lax.map``).  With
    a mesh it scores this rank's rows."""

    def score(params, batch):
        if cfg.model == "bst":
            return bst_forward(params, batch["history"], batch["target_item"], cfg, mesh)
        if cfg.model == "two_tower":
            u = two_tower_user(params, batch["ids"], cfg, mesh)
            v = two_tower_item(params, batch["item"], cfg, mesh)
            return torch.sum(u * v, dim=-1)
        return FORWARDS[cfg.model](params, batch["ids"], cfg, mesh)

    @torch.no_grad()
    def step(params, batch):
        n = tree_leaves(batch)[0].shape[0]
        if not chunk or n <= chunk or n % chunk != 0:
            return score(params, batch)
        return torch.cat([score(params, {k: x[s:s + chunk] for k, x in batch.items()})
                          for s in range(0, n, chunk)])

    return step


def make_retrieval_step(cfg: RecsysConfig, mesh, k: int = 100):
    """Score one query batch against the candidate matrix and return the
    global top-k (scores, ids), ties to the lower index (the
    ``retrieval_cand`` cell).  With a mesh each rank passes its block of the
    candidates (split over every axis, row-major) and every rank returns
    the merged (B, k); with ``mesh=None`` the candidates are whole."""
    from repro_torch.anns.base import stable_topk

    @torch.no_grad()
    def step(params, batch, candidates):
        u = two_tower_user(params, batch["ids"], cfg, mesh)
        s = u @ candidates.T.to(u.dtype)                        # (B, m_loc)
        top, ids = stable_topk(s, min(k, s.shape[1]))
        if mesh is None:
            return top, ids
        from repro_torch.dist.serve import merge, shard_index

        gids = ids + shard_index(mesh) * candidates.shape[0]
        return merge(mesh, top, gids, k)

    return step
