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
token), as the JAX package does without a mesh.  The models' sharded forms
wait for the sharding rules (ROADMAP Queue 1 item 10(d)): a ``mesh`` other
than None raises.

KV caches are written in place by ``decode`` (see ``nn.attention``).

Entry points:
  init_lm / forward_train / lm_loss / make_train_step
  prefill / decode / init_cache / make_prefill_step / make_decode_step
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

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


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the LM's sharded forms come with the sharding rules (ROADMAP Queue 1 "
            "item 10(d)); the expert-parallel MoE and context-parallel attention run "
            "as nn.moe.moe_apply and nn.attention.flash_attention_cp")


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
# layer application
# ---------------------------------------------------------------------------

def _attn_train(cfg: LMConfig, p, x, positions, chunk):
    if cfg.attn == "mla":
        return attention.mla_train(
            p, x, positions, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
            kv_lora=cfg.kv_lora, rope_base=cfg.rope_base, kv_block=cfg.kv_block,
            q_block=cfg.q_block)
    return attention.gqa_train(
        p, x, positions, rope_base=cfg.rope_base, chunk=chunk or None,
        q_block=cfg.q_block, kv_block=cfg.kv_block)


def _ffn(cfg: LMConfig, spec: LayerSpec, p, h):
    """The layer's FFN -> (y, aux)."""
    if spec.is_moe:
        return moe.moe_apply_dense(p["moe"], h, n_experts=cfg.moe_n_experts,
                                   top_k=cfg.moe_top_k, activation=cfg.activation)
    return layers.ffn(p["mlp"], h, cfg.activation), 0.0


def _layer_train(cfg: LMConfig, spec: LayerSpec, p, x, positions):
    h = _norm(cfg, p["ln1"], x)
    x = x + _attn_train(cfg, p["attn"], h, positions, spec.chunk)
    y, aux = _ffn(cfg, spec, p, _norm(cfg, p["ln2"], x))
    return x + y, aux


def _embed(params, tokens, cfg: LMConfig):
    x = layers.embed(params["embed"], tokens).to(cfg.cdtype)
    if cfg.embed_scale:
        # sqrt(d) in fp32, then cast to the compute dtype (55.43 -> 55.5 in bf16)
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(cfg.cdtype)
    return x


def forward_train(params, tokens, cfg: LMConfig, mesh=None):
    """tokens: (B, T) -> (hidden (B, T, d), aux_loss)."""
    _no_mesh(mesh)
    B, T = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for si, (n_blocks, block) in enumerate(layer_stacks(cfg)):
        stack = params[f"stack_{si}"]

        def block_fn(x, bp, block=block):
            aux_b = torch.zeros((), dtype=torch.float32, device=x.device)
            for pi, spec in enumerate(block):
                x, aux = _layer_train(cfg, spec, bp[f"pos_{pi}"], x, positions)
                aux_b = aux_b + aux
            return x, aux_b

        auxs = []
        for b in range(n_blocks):
            if cfg.remat == "full" and torch.is_grad_enabled():
                x, aux_b = checkpoint(block_fn, x, _block(stack, b), use_reentrant=False)
            else:
                x, aux_b = block_fn(x, _block(stack, b))
            auxs.append(aux_b)
        aux_total = aux_total + torch.stack(auxs).sum()
    return _norm(cfg, params["final_norm"], x), aux_total


def _readout(params, h, cfg: LMConfig):
    if cfg.tie_embeddings:
        return layers.embed_logits(params["embed"], h)
    return layers.dense(params["head"], h)


def lm_loss(params, hidden, labels, cfg: LMConfig):
    """Chunked softmax cross-entropy (never holds (B, T, V))."""
    B, T, d = hidden.shape
    chunk = min(cfg.loss_chunk, T)
    nb = T // chunk if T % chunk == 0 else 1
    chunk = T // nb
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nb):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = _readout(params, hidden[:, sl], cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, sl, None])[..., 0]
        total = total + (lse - gold).sum()
    return total / (B * T)


def value_and_grad(params, tokens, labels, cfg: LMConfig):
    """((loss + aux_loss_coef * aux, (loss, aux)), grads) by autograd, grads
    in ``params``' structure: ``jax.value_and_grad(..., has_aux=True)`` of
    the JAX twin's train loss."""
    def total(p):
        hidden, aux = forward_train(p, tokens, cfg)
        loss = lm_loss(p, hidden, labels, cfg)
        return loss + cfg.aux_loss_coef * aux, (loss, aux)

    return pytree.value_and_grad(total, params, has_aux=True)


def make_train_step(cfg: LMConfig, mesh=None, *, optimizer=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    As the JAX twin, the step ignores ``optimizer`` and always applies
    ``adam_update(lr=1e-3, grad_clip=1.0)`` (ROADMAP Queue 3 records this)."""
    _no_mesh(mesh)

    def train_step(params, opt_state, batch):
        (_, (loss, aux)), grads = value_and_grad(params, batch["tokens"], batch["labels"], cfg)
        with torch.no_grad():
            params, opt_state, om = adam_update(grads, opt_state, params, lr=1e-3,
                                                grad_clip=1.0)
        return params, opt_state, {"loss": loss, "aux_loss": aux, **om}

    return train_step


# ---------------------------------------------------------------------------
# serving: prefill + decode with stacked caches
# ---------------------------------------------------------------------------

def _attn_prefill(cfg, p, x, positions, cache_len, chunk):
    if cfg.attn == "mla":
        return attention.mla_prefill(
            p, x, positions, cache_len, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
            kv_lora=cfg.kv_lora, rope_base=cfg.rope_base, kv_block=cfg.kv_block,
            q_block=cfg.q_block)
    return attention.gqa_prefill(
        p, x, positions, cache_len, rope_base=cfg.rope_base, chunk=chunk or None,
        q_block=cfg.q_block, kv_block=cfg.kv_block)


def _attn_decode(cfg, p, x, cache, kv_len, chunk):
    if cfg.attn == "mla":
        return attention.mla_decode(
            p, x, cache, kv_len, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
            kv_lora=cfg.kv_lora, rope_base=cfg.rope_base)
    return attention.gqa_decode(p, x, cache, kv_len, rope_base=cfg.rope_base,
                                chunk=chunk or None)


def _layer_serve(cfg, spec, p, x, attn_fn):
    a, cache = attn_fn(p["attn"], _norm(cfg, p["ln1"], x))
    x = x + a
    y, _ = _ffn(cfg, spec, p, _norm(cfg, p["ln2"], x))
    return x + y, cache


def prefill(params, tokens, cfg: LMConfig, cache_len: int, mesh=None):
    """Returns (last_token_logits, caches).  caches: a list a stack of
    {pos_i: (k, v)} (MLA: (c_kv, k_rope)), each with leading axis n_blocks."""
    _no_mesh(mesh)
    B, T = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    caches = []
    for si, (n_blocks, block) in enumerate(layer_stacks(cfg)):
        stack = params[f"stack_{si}"]
        stack_caches = None
        for b in range(n_blocks):
            bp = _block(stack, b)
            cs = {}
            for pi, spec in enumerate(block):
                attn_fn = lambda p, h, _spec=spec: _attn_prefill(
                    cfg, p, h, positions, cache_len, _spec.chunk)
                x, cs[f"pos_{pi}"] = _layer_serve(cfg, spec, bp[f"pos_{pi}"], x, attn_fn)
            if stack_caches is None:
                stack_caches = tree_map(lambda t: t.new_empty((n_blocks, *t.shape)), cs)
            tree_map(lambda dst, src: dst[b].copy_(src), stack_caches, cs)
        caches.append(stack_caches)
    x = _norm(cfg, params["final_norm"], x)
    return _readout(params, x[:, -1:], cfg)[:, 0], caches


def decode(params, token, caches, kv_len, cfg: LMConfig, mesh=None):
    """One decode step.  token: (B, 1) int; kv_len (a scalar) includes the
    new token.  Writes the new token's K/V into ``caches`` in place and
    returns (logits (B, vocab), caches)."""
    _no_mesh(mesh)
    x = _embed(params, token, cfg)
    for si, (n_blocks, block) in enumerate(layer_stacks(cfg)):
        stack, sc = params[f"stack_{si}"], caches[si]
        for b in range(n_blocks):
            bp, bc = _block(stack, b), _block(sc, b)
            for pi, spec in enumerate(block):
                attn_fn = lambda p, h, _spec=spec, _c=bc[f"pos_{pi}"]: _attn_decode(
                    cfg, p, h, _c, kv_len, _spec.chunk)
                x, _ = _layer_serve(cfg, spec, bp[f"pos_{pi}"], x, attn_fn)
    x = _norm(cfg, params["final_norm"], x)
    return _readout(params, x, cfg)[:, 0], caches


def init_cache(cfg: LMConfig, batch: int, cache_len: int, device="cuda"):
    """Zero KV caches with ``prefill``'s structure (dtype: the compute dtype)."""
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=cfg.cdtype, device=dev)
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
