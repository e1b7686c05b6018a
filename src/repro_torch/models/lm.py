"""Decoder-only LM family covering the five transformer configs (twin of
``repro/models/lm.py``).

One config-driven implementation: GQA/MQA (qwen, granite, gemma, llama4)
and MLA (deepseek-v3) attention; dense GeGLU/SwiGLU/GELU or MoE FFN;
interleaved layer patterns (llama4's dense/MoE alternation with chunked
attention and full attention every 4th layer; deepseek's dense prefix).

Parameters are nested dicts of tensors with the JAX package's leaf names
(``stack_{si}/pos_{pi}/attn/wq``), each stack's leaves keeping their
leading ``n_blocks`` axis, so ``common.pytree.named_leaves`` gives the JAX
names and ``convert`` is a leaf-by-leaf copy.  Where JAX scans a stack
(``lax.scan``), the port loops over its blocks; ``remat="full"`` wraps each
block in ``torch.utils.checkpoint`` under autograd.

On one device an MoE layer runs ``moe_apply_dense`` (every expert for every
token), as the JAX package does without a mesh.

**Mesh forms** (a ``DeviceMesh`` with axes of ("pod", "data", "model")):
where JAX gets them from GSPMD and two ``shard_map``s, the port runs
explicit local blocks.  Parameters are each rank's blocks of their
``dist.sharding`` rule (``lm_specs``); a layer gathers what it needs whole
(``gather_block``, recomputed under remat), except the dims a mesh form
consumes itself: the ``ep`` experts over "model" and the ``ffslice``
expert ffn over "model" (``_moe_weights``).  Token ids and labels enter
whole on every rank (they are small) and each rank takes its rows
(``mesh_layout``): the rows split over the batch axes when the batch
divides them, the positions split over "model" wherever the
context-parallel attention runs (``attention._use_cp``; the JAX twin's
``_seq_constraint`` layout).  The embedding lookup and the loss are
vocab-parallel: each "model" rank reads its block of the table, and the
cross-entropy combines its block of the logits by a max and a sum-exp over
"model", so the (V, d) table and head are never gathered.  The prefill
writes each rank's block of the caches, whose sequence is split over
"model" (over ("data", "model") when the rows are whole: ``cache_specs``);
a decode step's new K/V is written by the rank that holds position
kv_len - 1, and its attention merges each rank's partial softmax over
those axes.  Losses are sums of every rank's share
(``dist.sharding.loss_total``) and the gradients come out as blocks
(``value_and_grad``).  The ``ep`` MoE raises ``ValueError`` where JAX's
``shard_map`` cannot split its experts over ("model", "data").

KV caches are written in place by ``decode`` (see ``nn.attention``).

Entry points:
  init_lm / forward_train / lm_loss / make_train_step
  prefill / decode / init_cache / make_prefill_step / make_decode_step
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import collectives
from repro_torch.common.config import ConfigBase
from repro_torch.common.device import resolve_device
from repro_torch.common.prng import PRNGSeq
from repro_torch.common import pytree
from repro_torch.common.pytree import tree_map
from repro_torch.nn import attention, layers, moe
from repro_torch.optim.adam import adam_update

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}

#: How far two bf16 evaluations of the same logits (decode against the train
#: forward) may sit apart, relative to max |logit|: twice the largest
#: deviation of bf16 logits from fp32 ones at SMOKE widths on the CPU, 0.026
#: (gemma-7b at its 28 layers over 8 seeds; deepseek-v3 cut to 2 layers:
#: 0.012), rounded up; held by ``tests/test_torch_lm.py::test_bf16_logit_tolerance``.
BF16_LOGIT_RTOL = 0.06


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMConfig(ConfigBase):
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 32000
    activation: str = "silu"
    gated: bool = True
    mlp_bias: bool = False
    qkv_bias: bool = False
    norm: str = "rms"            # rms | ln
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma: multiply embeddings by sqrt(d)
    # attention type
    attn: str = "gqa"            # gqa | mla
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # MoE
    moe_n_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: int = 0
    moe_shared: int = 0          # shared experts (deepseek: 1)
    moe_layout: str = "ep"       # ep | ffslice (see nn.moe)
    moe_period: int = 0          # 0 = dense model; 1 = every layer; 2 = alternate
    prefix_dense_layers: int = 0 # deepseek: first 3 layers dense
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # llama4 chunked attention
    chunk_attn: int = 0          # 0 = full; else local chunk size
    full_attn_every: int = 0     # every Nth layer uses full attention
    # execution
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    q_block: int = 512
    kv_block: int = 512
    loss_chunk: int = 512
    remat: str = "full"          # none | full
    scan_layers: bool = True
    seq_shard: bool = True       # the JAX twin's sequence-parallel residual stream on a mesh

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    is_moe: bool
    chunk: int  # 0 = full attention


def layer_stacks(cfg: LMConfig) -> list[tuple[int, tuple[LayerSpec, ...]]]:
    """Derive (n_blocks, block_pattern) stacks from the config."""
    specs = []
    for i in range(cfg.n_layers):
        if cfg.moe_n_experts > 0 and cfg.moe_period > 0 and i >= cfg.prefix_dense_layers:
            is_moe = ((i - cfg.prefix_dense_layers) % cfg.moe_period) == cfg.moe_period - 1
        else:
            is_moe = False
        chunk = cfg.chunk_attn
        if chunk and cfg.full_attn_every and (i + 1) % cfg.full_attn_every == 0:
            chunk = 0
        specs.append(LayerSpec(is_moe, chunk))

    stacks: list[tuple[int, tuple[LayerSpec, ...]]] = []
    i = 0
    if cfg.prefix_dense_layers:
        stacks.append((cfg.prefix_dense_layers, (specs[0],)))
        i = cfg.prefix_dense_layers
    rest = specs[i:]
    if not rest:
        return stacks
    # the shortest repeating pattern in the remaining layers
    for plen in range(1, len(rest) + 1):
        if len(rest) % plen:
            continue
        pat = rest[:plen]
        if all(rest[j] == pat[j % plen] for j in range(len(rest))):
            stacks.append((len(rest) // plen, tuple(pat)))
            return stacks
    stacks.append((1, tuple(rest)))
    return stacks


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_norm(cfg: LMConfig, device):
    return (layers.init_rmsnorm(cfg.d_model, cfg.pdtype, device) if cfg.norm == "rms"
            else layers.init_layernorm(cfg.d_model, cfg.pdtype, device))


def _norm(cfg: LMConfig, p, x):
    return layers.rmsnorm(p, x) if cfg.norm == "rms" else layers.layernorm(p, x)


def _init_layer(generator, cfg: LMConfig, spec: LayerSpec, device):
    ks = PRNGSeq(generator, device)
    p: dict[str, Any] = {"ln1": _init_norm(cfg, device), "ln2": _init_norm(cfg, device)}
    if cfg.attn == "mla":
        p["attn"] = attention.init_mla(
            next(ks), cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
            cfg.qk_nope, cfg.qk_rope, cfg.v_head, cfg.pdtype, device)
    else:
        p["attn"] = attention.init_gqa(
            next(ks), cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.qkv_bias, cfg.pdtype, device)
    if spec.is_moe:
        p["moe"] = moe.init_moe(
            next(ks), cfg.moe_n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
            gated=cfg.gated, n_shared=cfg.moe_shared, shared_d_ff=cfg.moe_d_ff or cfg.d_ff,
            dtype=cfg.pdtype, device=device)
    else:
        p["mlp"] = layers.init_ffn(next(ks), cfg.d_model, cfg.d_ff, cfg.gated,
                                   cfg.mlp_bias, cfg.pdtype, device)
    return p


def init_lm(generator: torch.Generator | int, cfg: LMConfig, device="cuda"):
    """Parameters drawn from ``generator`` (or a seed) on ``device``: one draw
    a block, written into each stack's leaves (leading axis n_blocks)."""
    dev = resolve_device(device)
    ks = PRNGSeq(generator, dev)
    params: dict[str, Any] = {
        "embed": layers.init_embedding(next(ks), cfg.vocab, cfg.d_model, cfg.pdtype, dev),
        "final_norm": _init_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = layers.init_dense(next(ks), cfg.d_model, cfg.vocab, False,
                                           cfg.pdtype, dev)
    for si, (n_blocks, block) in enumerate(layer_stacks(cfg)):
        stack = None
        for b, g in enumerate(ks.take(n_blocks)):
            sub = PRNGSeq(g, dev)
            one = {f"pos_{pi}": _init_layer(next(sub), cfg, spec, dev)
                   for pi, spec in enumerate(block)}
            if stack is None:
                stack = tree_map(lambda t: t.new_empty((n_blocks, *t.shape)), one)
            tree_map(lambda dst, src: dst[b].copy_(src), stack, one)
            del one
        params[f"stack_{si}"] = stack
    return params


def _block(stack, b: int):
    """Block ``b``'s params (views) of a stacked subtree."""
    return tree_map(lambda t: t[b], stack)


# ---------------------------------------------------------------------------
# layer application (one device, or a rank's blocks with a MeshLayout)
# ---------------------------------------------------------------------------

def _attn_train(cfg: LMConfig, p, x, positions, chunk, mesh=None):
    if cfg.attn == "mla":
        return attention.mla_train(
            p, x, positions, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
            kv_lora=cfg.kv_lora, rope_base=cfg.rope_base, kv_block=cfg.kv_block,
            q_block=cfg.q_block, mesh=mesh)
    return attention.gqa_train(
        p, x, positions, rope_base=cfg.rope_base, chunk=chunk or None,
        q_block=cfg.q_block, kv_block=cfg.kv_block, mesh=mesh)


def _ffn(cfg: LMConfig, spec: LayerSpec, p, h, lay=None):
    """The layer's FFN -> (y, aux)."""
    if spec.is_moe:
        if lay is not None:
            return _moe_mesh(cfg, p["moe"], h, lay)
        return moe.moe_apply_dense(p["moe"], h, n_experts=cfg.moe_n_experts,
                                   top_k=cfg.moe_top_k, activation=cfg.activation)
    return layers.ffn(p["mlp"], h, cfg.activation), 0.0


def _layer(cfg: LMConfig, spec: LayerSpec, p, x, attn_fn, lay=None):
    """One layer; ``attn_fn(p_attn, h) -> (out, cache or None)``.
    Returns (x, aux, cache)."""
    a, cache = attn_fn(p["attn"], _norm(cfg, p["ln1"], x))
    x = x + a
    y, aux = _ffn(cfg, spec, p, _norm(cfg, p["ln2"], x), lay)
    return x + y, aux, cache


def _layer_train(cfg: LMConfig, spec: LayerSpec, p, x, positions):
    """One training layer on one device -> (x, aux)."""
    x, aux, _ = _layer(cfg, spec, p, x, lambda pa, h: (
        _attn_train(cfg, pa, h, positions, spec.chunk), None))
    return x, aux


def _run_layers(params, cfg: LMConfig, x, attn_for, lay=None, remat: bool = False):
    """``x`` through every block of every stack -> (x, aux, caches).
    ``attn_for(si, b, pi, spec)`` gives the attention of that layer
    (:func:`_layer`); a stack's caches are the layers' caches stacked on a
    leading n_blocks axis (None where the attention keeps none).  With a
    layout each block gathers its parameters (``_gathered``) inside the
    block, so ``remat`` recomputes the gathers too."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for si, (n_blocks, block) in enumerate(layer_stacks(cfg)):
        stack = params[f"stack_{si}"]
        specs = None if lay is None else _layer_specs(cfg, params, si)

        def block_fn(x, bp, b, si=si, block=block, specs=specs):
            aux_b, cs = 0.0, {}     # a tensor once an MoE layer adds its aux loss
            for pi, spec in enumerate(block):
                p = bp[f"pos_{pi}"]
                if lay is not None:
                    p = _gathered(p, specs[f"pos_{pi}"], lay.mesh)
                x, aux, cs[f"pos_{pi}"] = _layer(cfg, spec, p, x, attn_for(si, b, pi, spec),
                                                 lay)
                aux_b = aux_b + aux
            return x, aux_b, cs

        stack_caches, auxs = None, []
        for b in range(n_blocks):
            if remat and cfg.remat == "full" and torch.is_grad_enabled():
                x, aux_b, cs = checkpoint(block_fn, x, _block(stack, b), b, use_reentrant=False)
            else:
                x, aux_b, cs = block_fn(x, _block(stack, b), b)
            auxs.append(aux_b)
            if all(c is not None for c in cs.values()):
                if stack_caches is None:
                    stack_caches = tree_map(lambda t: t.new_empty((n_blocks, *t.shape)), cs)
                tree_map(lambda dst, src: dst[b].copy_(src), stack_caches, cs)
            del cs      # views of the layer's whole padded caches: free them now
        caches.append(stack_caches)
        aux_total = aux_total + sum(auxs)
    return x, aux_total, caches


def _embed(params, tokens, cfg: LMConfig, lay=None):
    """The embedding of ``tokens``; with a layout, of the rank's rows from
    its block of the vocabulary: each "model" rank reads the ids in its
    rows of the table and a sum over "model" (scattered over the sequence
    where it is split) combines them, so the table is never gathered."""
    if lay is None:
        x = layers.embed(params["embed"], tokens)
    else:
        from repro_torch.dist.sharding import row_block_lookup

        x = row_block_lookup(params["embed"]["embedding"], tokens[lay.rows], lay.mesh,
                             1 if lay.cp else None)
    x = x.to(cfg.cdtype)
    if cfg.embed_scale:
        # sqrt(d) in fp32, then cast to the compute dtype (55.43 -> 55.5 in bf16)
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(cfg.cdtype)
    return x


def _inputs(params, tokens, cfg: LMConfig, lay=None):
    """(embedded rows, their positions): every row and position, or with a
    layout the rank's rows and, where the sequence is split, its positions."""
    B, T = tokens.shape
    x = _embed(params, tokens, cfg, lay)
    t0, n = (0, T) if lay is None else (lay.j * lay.T_loc if lay.cp else 0, lay.T_loc)
    return x, torch.arange(t0, t0 + n, device=tokens.device).expand(x.shape[0], n)


def _cp_mesh(lay):
    """The mesh the attention gathers the sequence over, if it is split."""
    return lay.mesh if lay is not None and lay.cp else None


def _layout(mesh, B: int, T: int):
    return None if mesh is None else mesh_layout(mesh, B, T)


def forward_train(params, tokens, cfg: LMConfig, mesh=None):
    """tokens: (B, T) -> (hidden (B, T, d), aux_loss).  With a mesh, params
    are this rank's blocks and tokens whole; hidden is the rank's block
    (its rows, its positions where the sequence is split: ``mesh_layout``)
    and aux the global value."""
    lay = _layout(mesh, *tokens.shape)
    x, positions = _inputs(params, tokens, cfg, lay)
    cp = _cp_mesh(lay)
    x, aux, _ = _run_layers(params, cfg, x, lambda si, b, pi, spec: lambda p, h: (
        _attn_train(cfg, p, h, positions, spec.chunk, cp), None), lay, remat=True)
    hidden = _norm(cfg, params["final_norm"], x)
    if lay is not None:
        from repro_torch.dist.sharding import loss_total

        aux = loss_total(aux / collectives.mesh_size(mesh), mesh)
    return hidden, aux


def _readout(params, h, cfg: LMConfig):
    """Logits of ``h``; on a rank's blocks, of its block of the vocabulary."""
    if cfg.tie_embeddings:
        return layers.embed_logits(params["embed"], h)
    return layers.dense(params["head"], h)


def _xent(logits, labels, lay):
    """Per-position cross-entropy; with a layout, vocab-parallel: ``logits``
    are the rank's block of the vocabulary, the max and the sum-exp are
    combined over "model" and the gold logit comes from the block that
    holds it."""
    if lay is None:
        return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    mesh, v_loc = lay.mesh, logits.shape[-1]
    m = collectives.pmax(logits.amax(-1), mesh, "model")
    se = collectives.psum(torch.exp(logits - m[..., None]).sum(-1), mesh, "model")
    local = labels.long() - lay.j * v_loc
    ok = (local >= 0) & (local < v_loc)
    gold = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0] * ok
    return m + torch.log(se) - collectives.psum(gold, mesh, "model")


def lm_loss(params, hidden, labels, cfg: LMConfig, mesh=None):
    """Chunked softmax cross-entropy (never holds (B, T, V)).  With a mesh,
    hidden is the rank's block from ``forward_train``, labels whole: its
    rows at every position (gathered over "model" where the sequence is
    split) against its block of the vocabulary (:func:`_xent`)."""
    B, T = labels.shape
    lay = _layout(mesh, B, T)
    if lay is not None:
        hidden = collectives.all_gather(hidden, mesh, "model", 1) if lay.cp else hidden
        labels = labels[lay.rows]
    chunk = min(cfg.loss_chunk, T)
    nb = T // chunk if T % chunk == 0 else 1
    chunk = T // nb
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nb):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = _readout(params, hidden[:, sl], cfg).float()
        total = total + _xent(logits, labels[:, sl], lay).sum()
    if lay is None:
        return total / (B * T)
    from repro_torch.dist.sharding import loss_total

    return loss_total(total / (hidden.shape[0] * T * collectives.mesh_size(mesh)), mesh)


def value_and_grad(params, tokens, labels, cfg: LMConfig, mesh=None):
    """((loss + aux_loss_coef * aux, (loss, aux)), grads) by autograd, grads
    in ``params``' structure: ``jax.value_and_grad(..., has_aux=True)`` of
    the JAX twin's train loss.  With a mesh the grads are this rank's blocks
    of the global gradient (summed over the ranks holding each block)."""
    def total(p):
        hidden, aux = forward_train(p, tokens, cfg, mesh)
        loss = lm_loss(p, hidden, labels, cfg, mesh)
        return loss + cfg.aux_loss_coef * aux, (loss, aux)

    out, grads = pytree.value_and_grad(total, params, has_aux=True)
    if mesh is not None:
        from repro_torch.dist.sharding import sync_grads

        grads = sync_grads(grads, lm_specs(cfg, params), mesh)
    return out, grads


def make_train_step(cfg: LMConfig, mesh=None, *, optimizer=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    As the JAX twin, the step ignores ``optimizer`` and always applies
    ``adam_update(lr=1e-3, grad_clip=1.0)`` (ROADMAP Queue 3 records this).
    With a mesh, on this rank's blocks, clipped by the global norm."""

    def train_step(params, opt_state, batch):
        (_, (loss, aux)), grads = value_and_grad(params, batch["tokens"], batch["labels"], cfg,
                                                 mesh)
        norm = None
        if mesh is not None:
            from repro_torch.dist.sharding import global_norm

            norm = global_norm(grads, lm_specs(cfg, params), mesh)
        with torch.no_grad():
            params, opt_state, om = adam_update(grads, opt_state, params, lr=1e-3,
                                                grad_clip=1.0, grad_norm=norm)
        return params, opt_state, {"loss": loss, "aux_loss": aux, **om}

    return train_step


# ---------------------------------------------------------------------------
# serving: prefill + decode with stacked caches
# ---------------------------------------------------------------------------

def _attn_prefill(cfg, p, x, positions, cache_len, chunk, mesh=None):
    if cfg.attn == "mla":
        return attention.mla_prefill(
            p, x, positions, cache_len, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
            kv_lora=cfg.kv_lora, rope_base=cfg.rope_base, kv_block=cfg.kv_block,
            q_block=cfg.q_block, mesh=mesh)
    return attention.gqa_prefill(
        p, x, positions, cache_len, rope_base=cfg.rope_base, chunk=chunk or None,
        q_block=cfg.q_block, kv_block=cfg.kv_block, mesh=mesh)


def _attn_decode(cfg, p, x, cache, kv_len, chunk, seq=None):
    if cfg.attn == "mla":
        return attention.mla_decode(
            p, x, cache, kv_len, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
            kv_lora=cfg.kv_lora, rope_base=cfg.rope_base, seq=seq)
    return attention.gqa_decode(p, x, cache, kv_len, rope_base=cfg.rope_base,
                                chunk=chunk or None, seq=seq)


def _logits(params, x_last, cfg: LMConfig, lay=None):
    """(b, 1, d) -> (b, V); on a rank, its vocabulary block gathered over
    "model"."""
    logits = _readout(params, _norm(cfg, params["final_norm"], x_last), cfg)
    if lay is not None:
        logits = collectives.all_gather(logits, lay.mesh, "model", -1)
    return logits[:, 0]


def prefill(params, tokens, cfg: LMConfig, cache_len: int, mesh=None):
    """Returns (last_token_logits, caches).  caches: a list a stack of
    {pos_i: (k, v)} (MLA: (c_kv, k_rope)), each with leading axis n_blocks.
    With a mesh: the logits of the rank's rows and its blocks of the caches
    (``cache_specs``)."""
    B, T = tokens.shape
    lay = _layout(mesh, B, T)
    x, positions = _inputs(params, tokens, cfg, lay)
    cp = _cp_mesh(lay)
    keep = lambda c: c
    if lay is not None:
        s_idx, s_n = lay.cache_seq_block()
        if cache_len % s_n:
            raise ValueError(f"a cache of {cache_len} positions does not split {s_n} ways")
        S_loc = cache_len // s_n
        keep = lambda c: tuple(t[:, s_idx * S_loc:(s_idx + 1) * S_loc] for t in c)

    def attn_for(si, b, pi, spec):
        def attn(p, h):
            out, c = _attn_prefill(cfg, p, h, positions, cache_len, spec.chunk, cp)
            return out, keep(c)
        return attn

    x, _, caches = _run_layers(params, cfg, x, attn_for, lay)
    x = x[:, -1:]
    if cp is not None:   # the last position sits on the last "model" rank
        x = collectives.psum(x * float(lay.j == lay.M - 1), mesh, "model")
    return _logits(params, x, cfg, lay), caches


def decode(params, token, caches, kv_len, cfg: LMConfig, mesh=None):
    """One decode step.  token: (B, 1) int; kv_len (a scalar) includes the
    new token.  Writes the new token's K/V into ``caches`` in place and
    returns (logits (B, vocab), caches).  With a mesh: token whole, caches
    this rank's blocks, the logits of its rows; the rank whose block holds
    position kv_len - 1 writes the new K/V and the attention merges each
    rank's partial softmax over the caches' sequence axes."""
    lay = _layout(mesh, token.shape[0], 1)
    seq = None
    if lay is not None:
        kv_len = int(kv_len)
        seq = (mesh, lay.cache_seq_axes, lay.cache_seq_block()[0])
    x = _embed(params, token, cfg, lay)

    def attn_for(si, b, pi, spec):
        cache = tuple(t[b] for t in caches[si][f"pos_{pi}"])
        return lambda p, h: (_attn_decode(cfg, p, h, cache, kv_len, spec.chunk, seq)[0], None)

    x, _, _ = _run_layers(params, cfg, x, attn_for, lay)
    return _logits(params, x, cfg, lay), caches


def init_cache(cfg: LMConfig, batch: int, cache_len: int, device="cuda", mesh=None):
    """Zero KV caches with ``prefill``'s structure (dtype: the compute
    dtype); with a mesh, this rank's blocks (``cache_specs``)."""
    dev = resolve_device(device)
    lay = _layout(mesh, batch, 1)

    def z(*shape):
        if lay is not None:
            n_s = lay.cache_seq_block()[1]
            shape = (shape[0], batch // (lay.n_row_shards if lay.split_rows else 1),
                     shape[2] // n_s, *shape[3:])
        return torch.zeros(shape, dtype=cfg.cdtype, device=dev)
    caches = []
    for n_blocks, block in layer_stacks(cfg):
        stack_cache = {}
        for pi, _ in enumerate(block):
            if cfg.attn == "mla":
                c = (z(n_blocks, batch, cache_len, cfg.kv_lora),
                     z(n_blocks, batch, cache_len, cfg.qk_rope))
            else:
                shape = (n_blocks, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
                c = (z(*shape), z(*shape))
            stack_cache[f"pos_{pi}"] = c
        caches.append(stack_cache)
    return caches


def make_prefill_step(cfg: LMConfig, cache_len: int, mesh=None):
    def step(params, tokens):
        return prefill(params, tokens, cfg, cache_len, mesh)

    return step


def make_decode_step(cfg: LMConfig, mesh=None):
    def step(params, token, caches, kv_len):
        logits, new_caches = decode(params, token, caches, kv_len, cfg, mesh)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, new_caches

    return step


# ---------------------------------------------------------------------------
# mesh layout, parameter blocks and the MoE on a mesh (see the module
# docstring)
# ---------------------------------------------------------------------------

def lm_rules(cfg: LMConfig):
    """The sharding rule table of ``cfg``'s layout."""
    from repro_torch.dist.sharding import LM_RULES, LM_RULES_FFSLICE

    return LM_RULES_FFSLICE if cfg.moe_layout == "ffslice" and cfg.moe_n_experts else LM_RULES


def lm_specs(cfg: LMConfig, params):
    """The partition spec of every parameter leaf (by its name and rank)."""
    from repro_torch.dist.sharding import spec_tree

    return spec_tree(params, lm_rules(cfg))


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Where a batch of B sequences of T tokens sits on a mesh of ``sizes``
    ({axis: size}), seen from the rank at ``coord`` ({axis: index}): its
    rows split over the batch axes when B divides them (else whole on every
    rank), its positions split over ``"model"`` where the context-parallel
    attention runs (``attention._use_cp``), and a KV cache's sequence split
    over ``"model"`` (over ``("data", "model")`` when the rows are whole),
    as the JAX twin's cells lay them out.  ``mesh`` is the DeviceMesh the
    collectives run on (None for the specs alone: :func:`cache_specs`)."""
    mesh: Any
    sizes: dict
    coord: dict
    B: int
    T: int

    def _fold(self, axes) -> tuple[int, int]:
        """(index, count) of this rank over ``axes``, the first major."""
        i, n = 0, 1
        for a in axes:
            s = self.sizes.get(a, 1)
            i, n = i * s + self.coord.get(a, 0), n * s
        return i, n

    @property
    def batch_axes(self) -> tuple:
        from repro_torch.dist.sharding import batch_axes

        return batch_axes(self.sizes)

    @property
    def n_row_shards(self) -> int:
        return self._fold(self.batch_axes)[1]

    @property
    def split_rows(self) -> bool:
        return self.B >= self.n_row_shards and self.B % self.n_row_shards == 0

    @property
    def rows(self) -> slice:
        if not self.split_rows:
            return slice(None)
        b = self.B // self.n_row_shards
        i = self._fold(self.batch_axes)[0]
        return slice(i * b, (i + 1) * b)

    @property
    def M(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def j(self) -> int:
        return self.coord.get("model", 0)

    @property
    def cp(self) -> bool:
        return "model" in self.sizes and attention.cp_splits(self.M, self.T)

    @property
    def T_loc(self) -> int:
        return self.T // self.M if self.cp else self.T

    @property
    def cache_seq_axes(self) -> tuple:
        if self.split_rows or "data" not in self.sizes:
            return ("model",)
        return ("data", "model")

    def cache_seq_block(self) -> tuple[int, int]:
        """(index, count) of this rank's block of a cache's sequence."""
        return self._fold(self.cache_seq_axes)


def mesh_layout(mesh, B: int, T: int) -> MeshLayout:
    """The layout of a (B, T) batch on a live DeviceMesh, from this rank."""
    from repro_torch.dist.sharding import axis_sizes

    sizes = axis_sizes(mesh)
    return MeshLayout(mesh, sizes, {a: collectives.axis_index(mesh, a) for a in sizes}, B, T)


def cache_specs(cfg: LMConfig, mesh, batch: int, caches):
    """The partition spec of every cache leaf (n_blocks, B, S, ...) on a mesh
    (or its {axis: size}): the JAX twin's ``_cache_shardings``."""
    from repro_torch.dist.sharding import P, axis_sizes

    lay = MeshLayout(None, axis_sizes(mesh), {}, batch, 1)
    bspec = lay.batch_axes if lay.split_rows else None
    return tree_map(lambda t: P(None, bspec, lay.cache_seq_axes, *([None] * (t.dim() - 3))),
                    caches)


def _layer_specs(cfg: LMConfig, params, si: int):
    """Per-layer specs of stack ``si`` (the stack dim dropped)."""
    from repro_torch.dist.sharding import P, resolve_spec
    from repro_torch.common.pytree import tree_map_with_name

    return tree_map_with_name(
        lambda n, t: P(*resolve_spec(lm_rules(cfg), f"stack_{si}/{n}", t.dim())[1:]),
        params[f"stack_{si}"])


_EXPERTS = ("moe/wi_0", "moe/wi_1", "moe/wi", "moe/wo")


def _gathered(p, specs, mesh):
    """A block's parameters whole, the expert weights the MoE consumes in
    its own layout (``_moe_weights``) left as blocks."""
    from repro_torch.common.pytree import named_leaves, tree_map_with_name
    from repro_torch.dist.sharding import gather_block

    spec = dict(named_leaves(specs))
    return tree_map_with_name(
        lambda n, x: x if n in _EXPERTS else gather_block(x, spec[n], mesh), p)


def _moe_weights(cfg: LMConfig, p, lay: MeshLayout, token_gather: bool):
    """The expert weights in the form the MoE body takes, from this rank's
    blocks of the rules' layout: gathered over "data" (the body's ZeRO
    gather), and for the token-gather body cut to the rank's stored expert
    shard.  Raises ``ValueError`` where the JAX twin's ``shard_map`` cannot
    split the experts."""
    E = cfg.moe_n_experts
    D, i = lay.sizes.get("data", 1), lay.coord.get("data", 0)
    if cfg.moe_layout == "ep":
        if E % (lay.M * D):
            raise ValueError(f"the ep MoE splits {E} experts over ('model', 'data') = "
                             f"{lay.M * D} ranks, which does not divide them")
        dims = {"wi_0": 1, "wi_1": 1, "wi": 1, "wo": 1}
        n_own = E // (lay.M * D)
    else:
        if E % D:
            raise ValueError(f"the ffslice MoE splits {E} experts over 'data' = {D} ranks, "
                             "which does not divide them")
        dims = {"wi_0": 1, "wi_1": 1, "wi": 1, "wo": 2}
        n_own = E // D
    out = {}
    for k, dim in dims.items():
        if k not in p:
            continue
        w = collectives.all_gather(p[k], lay.mesh, "data", dim)
        out[k] = w[i * n_own:(i + 1) * n_own] if token_gather else w
    return out


def _moe_mesh(cfg: LMConfig, p, h, lay: MeshLayout, threshold: int = 4096):
    """The layer's MoE on the rank's tokens: every position of its rows
    (gathered over "model" where the sequence is split), cut over the batch
    axes as the JAX twin's token spec, through ``moe.moe_apply``; returns
    its (b, T_loc, d) rows of y and the aux loss."""
    mesh = lay.mesh
    x = collectives.all_gather(h, mesh, "model", 1) if lay.cp else h     # (b, T, d)
    b, T, d = x.shape
    xf = x.reshape(-1, d)
    n_tokens = lay.B * T
    axes, n = moe.token_axes(mesh, n_tokens)
    if not lay.split_rows and axes:
        from repro_torch.dist.sharding import local_block

        xf = local_block(xf, (axes, None), mesh)
    token_gather = n_tokens <= threshold
    params = dict(_moe_weights(cfg, p, lay, token_gather), router=p["router"])
    if "shared" in p:
        params["shared"] = p["shared"]
    y, aux = moe.moe_apply(params, xf, layout=cfg.moe_layout, n_experts=cfg.moe_n_experts,
                           top_k=cfg.moe_top_k, mesh=mesh, n_tokens=n_tokens,
                           capacity_factor=cfg.capacity_factor, activation=cfg.activation,
                           token_gather_threshold=threshold, gathered=True)
    if not lay.split_rows and axes:
        for a in reversed(axes):
            y = collectives.all_gather(y, mesh, a, 0)
    y = y.reshape(b, T, d)
    if lay.cp:
        y = y[:, lay.j * lay.T_loc:(lay.j + 1) * lay.T_loc]
    return y, aux


# ---------------------------------------------------------------------------
# parameter accounting
# ---------------------------------------------------------------------------

def param_count(cfg: LMConfig) -> int:
    n = cfg.vocab * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model
    for nb, block in layer_stacks(cfg):
        per_block = 0
        for spec in block:
            if cfg.attn == "mla":
                per_block += cfg.d_model * cfg.q_lora
                per_block += cfg.q_lora * cfg.n_heads * (cfg.qk_nope + cfg.qk_rope)
                per_block += cfg.d_model * (cfg.kv_lora + cfg.qk_rope)
                per_block += cfg.kv_lora * cfg.n_heads * (cfg.qk_nope + cfg.v_head)
                per_block += cfg.n_heads * cfg.v_head * cfg.d_model
            else:
                per_block += cfg.d_model * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
                per_block += cfg.n_heads * cfg.head_dim * cfg.d_model
            mats = 3 if cfg.gated else 2
            if spec.is_moe:
                dff = cfg.moe_d_ff or cfg.d_ff
                per_block += cfg.moe_n_experts * mats * cfg.d_model * dff
                per_block += cfg.d_model * cfg.moe_n_experts
                if cfg.moe_shared:
                    per_block += mats * cfg.d_model * dff * cfg.moe_shared
            else:
                per_block += mats * cfg.d_model * cfg.d_ff
        n += nb * per_block
    return int(n)


def active_param_count(cfg: LMConfig) -> int:
    """Active params a token (MoE: only the routed top-k and the shared)."""
    if not cfg.moe_n_experts:
        return param_count(cfg)
    full = param_count(cfg)
    dff = cfg.moe_d_ff or cfg.d_ff
    mats = 3 if cfg.gated else 2
    n_moe_layers = sum(
        nb * sum(1 for s in block if s.is_moe) for nb, block in layer_stacks(cfg))
    inactive = n_moe_layers * (cfg.moe_n_experts - cfg.moe_top_k) * mats * cfg.d_model * dff
    return int(full - inactive)
