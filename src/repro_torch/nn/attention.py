"""Attention layers: RoPE, GQA/MQA/MHA, MLA (DeepSeek), KV caches (twin of
``repro/nn/attention.py``).

* ``flash_attention``: blockwise online-softmax attention in plain PyTorch,
  a loop over query blocks and, inside it, over KV blocks.  It never holds
  the whole (T, S) score matrix.  The JAX package writes it in plain
  ``jnp`` (no Pallas kernel), and so does the port.
* ``decode_attention``: a one-token query against a padded KV cache.

Scores are fp32 as JAX's ``preferred_element_type=jnp.float32``: q and k are
upcast before the product (products of bf16 values are exact in fp32), and
P.V is taken in fp32.  The package leaves TF32 off.

Layouts: activations (B, T, D); q/k/v projections (D, H, head_dim); caches
(B, S_max, n_kv, head_dim).

**KV caches are written in place.**  A decode step writes the new token's
K and V into slot ``kv_len - 1`` of the cache tensors it is given and
returns the same tensors; the JAX package rewrites the whole cache with a
``where`` (the same values).  A caller that keeps an older cache clones it
first.  ``kv_len`` is a scalar (every caller passes one).

**Mesh hooks** (the LM's mesh forms run these same layers on each rank's
blocks): the train and prefill forms take ``mesh``, given where the
sequence is split over its ``"model"`` axis; K and V are then gathered over
it (``flash_attention_cp``'s body) and a prefill's caches hold every
position.  The decode forms take ``seq = (mesh, axes, index)`` where the
caches are block ``index`` of a sequence split over the ranks of ``axes``:
only the rank whose block holds position ``kv_len - 1`` writes the new K/V,
and the softmax is merged over those ranks (a max and two sums).
"""
from __future__ import annotations

import torch

from repro_torch.common import collectives
from repro_torch.common.prng import PRNGSeq
from repro_torch.nn import layers

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, base: float = 10000.0, device=None):
    return 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))


def apply_rope(x, positions, base: float = 10000.0):
    """x: (B, T, H, D); positions: (B, T) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, base, x.device)
    angles = positions[..., None].float() * inv                       # (B, T, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masking rule (evaluated a block at a time)
# ---------------------------------------------------------------------------

def _allowed(q_pos, kv_pos, *, causal: bool, chunk: int | None = None, kv_len=None):
    """q_pos: (..., Tq), kv_pos: (Sb,) -> bool (..., Tq, Sb)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                    device=qp.device)
    if causal:
        ok = ok & (kp <= qp)
    if chunk is not None:
        ok = ok & ((kp // chunk) == (qp // chunk))
    if kv_len is not None:
        ok = ok & (kp < kv_len)
    return ok


# ---------------------------------------------------------------------------
# blockwise flash attention
# ---------------------------------------------------------------------------

def _flash_q_block(q, k, v, q_pos, kv_pos, *, scale, causal, chunk, kv_block):
    """q: (B, K, G, Tq, D) fp32; k/v: (B, K, S, D) fp32; q_pos (B, Tq);
    kv_pos (S,).  Returns (B, K, G, Tq, Dv) fp32.

    The online softmax of the JAX twin, step for step: masked scores at
    NEG_INF, their probabilities forced to 0, the rescale factor forced to 0
    while a row has seen no allowed key, and the final sum floored at 1e-30,
    so a row with no allowed key (a padded query) comes out 0."""
    B, K, G, Tq, D = q.shape
    S, Dv = k.shape[2], v.shape[-1]
    o = torch.zeros((B, K, G, Tq, Dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, K, G, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, Tq), dtype=torch.float32, device=q.device)
    qf = q.reshape(B, K, G * Tq, D)
    for j in range(S // kv_block):
        sl = slice(j * kv_block, (j + 1) * kv_block)
        s = torch.matmul(qf, k[:, :, sl].transpose(-1, -2)).view(B, K, G, Tq, -1) * scale
        ok = _allowed(q_pos, kv_pos[sl], causal=causal, chunk=chunk)[:, None, None]
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.where(m <= NEG_INF * 0.5, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.view(B, K, G * Tq, -1), v[:, :, sl]).view(B, K, G, Tq, Dv)
        o = o * alpha[..., None] + pv
        m = m_new
    return o / torch.clamp(l, min=1e-30)[..., None]


def flash_attention(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                    chunk: int | None = None, q_block: int = 1024, kv_block: int = 1024,
                    scale: float | None = None):
    """q: (B, T, Hq, D), k/v: (B, S, Kv, D[v]), Hq % Kv == 0 (GQA groups).

    Returns (B, T, Hq, Dv) in q.dtype.  Positions are absolute token indices;
    masking (causal / chunked-local) is computed a block at a time from them.
    Padded query rows sit at position -1 and padded keys at 2^30.
    """
    B, T, H, D = q.shape
    S, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Kv
    scale = scale if scale is not None else D ** -0.5
    Tp = -(-T // q_block) * q_block
    Sp = -(-S // kv_block) * kv_block
    pad_t = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))
    qp = pad_t(q, Tp - T).float().view(B, Tp, Kv, G, D).permute(0, 2, 3, 1, 4)
    kp = pad_t(k, Sp - S).float().permute(0, 2, 1, 3)                 # (B, Kv, Sp, D)
    vp = pad_t(v, Sp - S).float().permute(0, 2, 1, 3)
    qpos = torch.nn.functional.pad(q_positions, (0, Tp - T), value=-1)
    kvpos = torch.nn.functional.pad(kv_positions, (0, Sp - S), value=2 ** 30)
    outs = [_flash_q_block(qp[:, :, :, i:i + q_block], kp, vp, qpos[:, i:i + q_block],
                           kvpos, scale=scale, causal=causal, chunk=chunk,
                           kv_block=kv_block)
            for i in range(0, Tp, q_block)]
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, Tp, H, Dv)
    return out[:, :T].to(q.dtype)


def flash_attention_cp(q, k, v, q_positions, mesh, *, causal=True, chunk=None,
                       q_block: int = 1024, kv_block: int = 1024, scale=None):
    """Context-parallel flash attention over the ``"model"`` axis of a
    ``DeviceMesh``.

    Each rank passes its own blocks, laid out as the JAX twin's ``shard_map``
    in-specs ``P(("pod", "data"), "model", None, None)``: q/k/v (B_loc, T_loc,
    H, D) and q_positions (B_loc, T_loc).  It gathers K and V once along the
    sequence over ``"model"`` and runs the blockwise core on its T_loc query
    rows; it returns its (B_loc, T_loc, H, Dv) block of the output.
    """
    (k_f, v_f), kv_pos, q_block = _over_sequence((k, v), q_positions, mesh, q_block)
    return flash_attention(q, k_f, v_f, q_positions, kv_pos, causal=causal, chunk=chunk,
                           q_block=q_block, kv_block=kv_block, scale=scale)


def _over_sequence(kv: tuple, positions, mesh, q_block: int):
    """(K/V tensors, their positions, the query block) for the causal core
    over the queries at ``positions``: the same positions on one device;
    with ``mesh`` (the sequence split over its "model" axis) K/V gathered
    from every rank and the query block cut to the rank's rows."""
    if mesh is None:
        return kv, positions[0], q_block
    kv = tuple(collectives.all_gather(t, mesh, "model", dim=1) for t in kv)
    return (kv, torch.arange(kv[0].shape[1], device=positions.device),
            min(q_block, positions.shape[1]))


def _use_cp(mesh, T: int) -> bool:
    """Whether the JAX twin takes the context-parallel form at global length
    ``T`` on ``mesh``."""
    if mesh is None or "model" not in collectives.axis_names(mesh):
        return False
    return cp_splits(collectives.axis_size(mesh, "model"), T)


def cp_splits(n_model: int, T: int) -> bool:
    """The context-parallel rule: ``n_model`` ranks split ``T`` positions
    into blocks of at least 128."""
    return T % n_model == 0 and T // n_model >= 128


def _scalar_kv_len(kv_len) -> int | torch.Tensor:
    if isinstance(kv_len, torch.Tensor) and kv_len.dim() != 0:
        raise ValueError(f"kv_len must be a scalar, got shape {tuple(kv_len.shape)}")
    return kv_len


def _cache_positions(S: int, seq, device):
    """The positions a cache of S slots holds: 0..S-1, or with ``seq`` its
    block of the split sequence."""
    return torch.arange(S, device=device) + (0 if seq is None else seq[2] * S)


def _softmax_v(s, v, ok, seq):
    """softmax(s) @ v over the allowed positions ``ok`` (s fp32 (..., S), v
    fp32 (..., S, Dv)); with ``seq`` the max and the sums are combined over
    the ranks that hold the sequence's other blocks."""
    s = torch.where(ok, s, NEG_INF)
    if seq is None:
        return torch.matmul(torch.softmax(s, dim=-1), v)
    mesh, axes, _ = seq
    m = collectives.pmax(s.amax(-1, keepdim=True), mesh, axes)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    return (collectives.psum(p @ v, mesh, axes)
            / collectives.psum(p.sum(-1, keepdim=True), mesh, axes))


def decode_attention(q, k_cache, v_cache, kv_len, *, chunk: int | None = None, scale=None,
                     seq=None):
    """One-step decode.  q: (B, 1, Hq, D); caches: (B, S, Kv, D); kv_len: ();
    ``seq``: see the module docstring."""
    kv_len = _scalar_kv_len(kv_len)
    B, _, H, D = q.shape
    S, Kv = k_cache.shape[1], k_cache.shape[2]
    G = H // Kv
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().view(B, Kv, G, D)
    s = torch.matmul(qg, k_cache.float().permute(0, 2, 3, 1)) * scale      # (B, K, G, S)
    kv_len_t = torch.as_tensor(kv_len, device=q.device)
    q_pos = (kv_len_t - 1).expand(B)[:, None]
    ok = _allowed(q_pos, _cache_positions(S, seq, q.device), causal=True, chunk=chunk,
                  kv_len=kv_len_t)                                         # (B, 1, S)
    o = _softmax_v(s, v_cache.float().permute(0, 2, 1, 3), ok[:, None], seq)  # (B, K, G, Dv)
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def _cache_write(cache, new, kv_len, seq=None):
    """Write ``new`` (B, 1, ...) into slot ``kv_len - 1`` of ``cache`` in
    place; with ``seq`` (``kv_len`` an int), only where this rank's block
    holds that position."""
    if seq is not None:
        kv_len = int(kv_len) - seq[2] * cache.shape[1]
        if not 0 < kv_len <= cache.shape[1]:
            return cache
    idx = (torch.as_tensor(kv_len, device=cache.device) - 1).reshape(1)
    cache.index_copy_(1, idx, new.to(cache.dtype))
    return cache


# ---------------------------------------------------------------------------
# GQA attention block (init / train / prefill / decode)
# ---------------------------------------------------------------------------

def init_gqa(generator, d_model, n_heads, n_kv, head_dim, qkv_bias=False,
             dtype=torch.float32, device="cuda"):
    gs = PRNGSeq(generator, device).take(4)
    vs = lambda g, shape, mode="fan_in": layers.variance_scaling(
        g, shape, mode=mode, dtype=dtype, device=device)
    p = {
        "wq": vs(gs[0], (d_model, n_heads, head_dim)),
        "wk": vs(gs[1], (d_model, n_kv, head_dim)),
        "wv": vs(gs[2], (d_model, n_kv, head_dim)),
        "wo": vs(gs[3], (n_heads, head_dim, d_model), "fan_out"),
    }
    if qkv_bias:
        dev = p["wq"].device
        p["bq"] = torch.zeros((n_heads, head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv, head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv, head_dim), dtype=dtype, device=dev)
    return p


def _proj(x, w):
    """einsum("btd,dhk->bthk") as one product."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _out_proj(o, w):
    """einsum("bthk,hkd->btd") as one product."""
    return o.reshape(*o.shape[:-2], -1) @ w.to(o.dtype).reshape(-1, w.shape[-1])


def _qkv(params, x):
    q, k, v = (_proj(x, params[n]) for n in ("wq", "wk", "wv"))
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _gqa(params, x, positions, *, rope_base, chunk, q_block, kv_block, mesh):
    """-> (out, K, V over the attended positions)."""
    q, k, v = _qkv(params, x)
    q = apply_rope(q, positions, rope_base)
    k = apply_rope(k, positions, rope_base)
    (k, v), kv_pos, q_block = _over_sequence((k, v), positions, mesh, q_block)
    o = flash_attention(q, k, v, positions, kv_pos, causal=True, chunk=chunk,
                        q_block=q_block, kv_block=kv_block)
    return _out_proj(o, params["wo"]), k, v


def gqa_train(params, x, positions, *, rope_base=10000.0, chunk=None, q_block=1024,
              kv_block=1024, mesh=None):
    """Full causal self-attention over x: (B, T, D); ``mesh``: see the module
    docstring."""
    return _gqa(params, x, positions, rope_base=rope_base, chunk=chunk, q_block=q_block,
                kv_block=kv_block, mesh=mesh)[0]


def gqa_prefill(params, x, positions, cache_len, *, rope_base=10000.0, chunk=None,
                q_block=1024, kv_block=1024, mesh=None):
    """Prefill: returns (out, (k_cache, v_cache)) with caches padded to cache_len."""
    out, k, v = _gqa(params, x, positions, rope_base=rope_base, chunk=chunk,
                     q_block=q_block, kv_block=kv_block, mesh=mesh)
    pad = cache_len - k.shape[1]
    pad_t = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
    return out, (pad_t(k), pad_t(v))


def gqa_decode(params, x, cache, kv_len, *, rope_base=10000.0, chunk=None, seq=None):
    """Decode one token.  x: (B, 1, D); cache: (k, v) each (B, S, Kv, hd),
    written in place.  ``kv_len`` includes the new token, whose position is
    kv_len - 1.  Returns (out, cache).  ``seq``: see the module docstring."""
    kv_len = _scalar_kv_len(kv_len)
    kc, vc = cache
    B = x.shape[0]
    pos = (torch.as_tensor(kv_len, device=x.device) - 1).expand(B)[:, None]
    q, k, v = _qkv(params, x)
    q = apply_rope(q, pos, rope_base)
    k = apply_rope(k, pos, rope_base)
    _cache_write(kc, k, kv_len, seq)
    _cache_write(vc, v, kv_len, seq)
    o = decode_attention(q, kc, vc, kv_len, chunk=chunk, seq=seq)
    return _out_proj(o, params["wo"]), (kc, vc)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3 multi-head latent attention), absorbed formulation
# ---------------------------------------------------------------------------

def init_mla(generator, d_model, n_heads, q_lora, kv_lora, qk_nope, qk_rope, v_head,
             dtype=torch.float32, device="cuda"):
    gs = PRNGSeq(generator, device).take(7)
    vs = lambda g, shape, mode="fan_in": layers.variance_scaling(
        g, shape, mode=mode, dtype=dtype, device=device)
    return {
        "wq_a": vs(gs[0], (d_model, q_lora)),
        "q_norm": layers.init_rmsnorm(q_lora, dtype, device),
        "wq_b": vs(gs[1], (q_lora, n_heads, qk_nope + qk_rope)),
        "wkv_a": vs(gs[2], (d_model, kv_lora + qk_rope)),
        "kv_norm": layers.init_rmsnorm(kv_lora, dtype, device),
        "wk_b": vs(gs[3], (kv_lora, n_heads, qk_nope)),
        "wv_b": vs(gs[4], (kv_lora, n_heads, v_head)),
        "wo": vs(gs[5], (n_heads, v_head, d_model), "fan_out"),
    }


def _mla_query(params, x, positions, qk_nope, rope_base):
    ql = layers.rmsnorm(params["q_norm"], x @ params["wq_a"].to(x.dtype))
    q = _proj(ql, params["wq_b"])
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, rope_base)
    # absorb k_up: q_nope (B,T,H,nope) x (kv_lora,H,nope) -> (B,T,H,kv_lora)
    q_lat = torch.einsum("bthk,lhk->bthl", q_nope, params["wk_b"].to(x.dtype))
    return q_lat, q_rope


def _mla_kv(params, x, positions, kv_lora, rope_base):
    kv = x @ params["wkv_a"].to(x.dtype)                     # (B, T, kv_lora + qk_rope)
    c_kv = layers.rmsnorm(params["kv_norm"], kv[..., :kv_lora])
    k_rope = apply_rope(kv[..., kv_lora:][:, :, None, :], positions, rope_base)[:, :, 0, :]
    return c_kv, k_rope


def _wv_b(o_lat, wv_b):
    """einsum("bthl,lhv->bthv")."""
    return torch.einsum("bthl,lhv->bthv", o_lat, wv_b.to(o_lat.dtype))


def _mla_attend(params, q_lat, q_rope, c_kv, k_rope, q_pos, kv_pos, *, scale, kv_len=None,
                seq=None):
    """Absorbed MLA attention.  q_lat: (B,T,H,L); c_kv: (B,S,L); k_rope: (B,S,R)."""
    s = torch.einsum("bthl,bsl->bhts", q_lat.float(), c_kv.float())
    s = s + torch.einsum("bthr,bsr->bhts", q_rope.float(), k_rope.float())
    s = s * scale
    ok = _allowed(q_pos, kv_pos, causal=True, kv_len=kv_len)       # (B, T, S) or (T, S)
    ok = ok[:, None] if ok.dim() == 3 else ok[None, None]
    o_lat = _softmax_v(s, c_kv.float()[:, None], ok, seq).permute(0, 2, 1, 3)
    return _wv_b(o_lat.to(q_lat.dtype), params["wv_b"])


def _mla(params, x, positions, *, qk_nope, qk_rope, kv_lora, rope_base, kv_block, q_block,
         mesh):
    """MLA causal self-attention through the flash core: the absorbed form is
    MQA over the latent cache (query concat(q_lat, q_rope), one shared key
    concat(c_kv, k_rope), value c_kv), with the true 1/sqrt(qk_nope+qk_rope)
    scale passed explicitly.  -> (out, c_kv, k_rope over the attended
    positions)."""
    scale = (qk_nope + qk_rope) ** -0.5
    q_lat, q_rope = _mla_query(params, x, positions, qk_nope, rope_base)
    c_kv, k_rope = _mla_kv(params, x, positions, kv_lora, rope_base)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)                      # (B, T, H, L+R)
    k_cat = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]       # (B, S, 1, L+R)
    (k_cat,), kv_pos, q_block = _over_sequence((k_cat,), positions, mesh, q_block)
    o = flash_attention(q_cat, k_cat, k_cat[..., :kv_lora], positions, kv_pos, causal=True,
                        q_block=q_block, kv_block=kv_block, scale=scale)
    out = _out_proj(_wv_b(o, params["wv_b"]), params["wo"])
    return out, k_cat[:, :, 0, :kv_lora], k_cat[:, :, 0, kv_lora:]


def mla_train(params, x, positions, *, qk_nope, qk_rope, kv_lora, rope_base=10000.0,
              kv_block: int = 2048, q_block: int = 1024, mesh=None):
    """MLA causal self-attention (``_mla``); ``mesh``: see the module
    docstring."""
    return _mla(params, x, positions, qk_nope=qk_nope, qk_rope=qk_rope, kv_lora=kv_lora,
                rope_base=rope_base, kv_block=kv_block, q_block=q_block, mesh=mesh)[0]


def mla_prefill(params, x, positions, cache_len, *, qk_nope, qk_rope, kv_lora,
                rope_base=10000.0, kv_block: int = 2048, q_block: int = 1024, mesh=None):
    out, c_kv, k_rope = _mla(params, x, positions, qk_nope=qk_nope, qk_rope=qk_rope,
                             kv_lora=kv_lora, rope_base=rope_base, kv_block=kv_block,
                             q_block=q_block, mesh=mesh)
    pad = cache_len - c_kv.shape[1]
    pad_t = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
    return out, (pad_t(c_kv), pad_t(k_rope))


def mla_decode(params, x, cache, kv_len, *, qk_nope, qk_rope, kv_lora, rope_base=10000.0,
               seq=None):
    """Decode one token with the compressed latent cache (B, S, kv_lora) +
    (B, S, rope), written in place; ``seq``: see the module docstring."""
    kv_len = _scalar_kv_len(kv_len)
    c_cache, r_cache = cache
    scale = (qk_nope + qk_rope) ** -0.5
    B = x.shape[0]
    kv_len_t = torch.as_tensor(kv_len, device=x.device)
    pos = (kv_len_t - 1).expand(B)[:, None]
    q_lat, q_rope = _mla_query(params, x, pos, qk_nope, rope_base)
    c_new, r_new = _mla_kv(params, x, pos, kv_lora, rope_base)
    _cache_write(c_cache, c_new, kv_len, seq)
    _cache_write(r_cache, r_new, kv_len, seq)
    kv_pos = _cache_positions(c_cache.shape[1], seq, x.device)
    o = _mla_attend(params, q_lat, q_rope, c_cache, r_cache, pos, kv_pos,
                    scale=scale, kv_len=kv_len_t, seq=seq)
    return _out_proj(o, params["wo"]), (c_cache, r_cache)
