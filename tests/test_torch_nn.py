"""The port's ``nn`` layers held against the JAX package on the same inputs.

JAX draws the parameters; they cross as numpy.  Tolerances, with reasons:
* layers, RoPE, norms, FFN, MLP: rtol 1e-5 / atol 1e-6 (fp32, the same
  formulas; matmuls and reductions sum in other orders).
* attention (blocked flash, decode, GQA, MLA): rtol 1e-5 / atol 2e-6 (fp32
  scores; exp and the online rescale round differently at ulp level).
* MoE dispatch: ``_capacity`` equal; ``_pack_dispatch`` equal (every slot
  holds one token's row or zeros); ``moe_apply_dense`` rtol 1e-5 / atol
  1e-6; top-k indices equal under ties (lowest index first).
* initializers: shapes and dtypes equal; each leaf's std within 4 / sqrt(n)
  of JAX's, relative (four standard errors of the difference of two
  independent draws of n values: different generators, so only the law can
  agree) and no value of a truncated normal beyond 2 std.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import one_torch_thread  # noqa: F401 (a fixture)
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import moe as jmoe

from repro_torch.common.prng import PRNGSeq
from repro_torch.nn import attention, layers, moe

RTOL, ATOL = 1e-5, 1e-6
A_RTOL, A_ATOL = 1e-5, 2e-6


def T(x):
    return torch.as_tensor(np.array(x))


def tt(tree):
    return jax.tree_util.tree_map(T, tree)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def arr(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_dense_norms_activations_match_jax():
    rng = np.random.default_rng(0)
    x = arr(rng, 3, 5, 16)
    p = jlayers.init_dense(jax.random.PRNGKey(0), 16, 8, use_bias=True)
    p["bias"] = jnp.asarray(arr(rng, 8))
    close(layers.dense(tt(p), T(x)), jlayers.dense(p, jnp.asarray(x)))
    ln = {"scale": arr(rng, 16), "bias": arr(rng, 16)}
    close(layers.layernorm(tt(ln), T(x)), jlayers.layernorm(ln, jnp.asarray(x)))
    close(layers.rmsnorm({"scale": T(ln["scale"])}, T(x)),
          jlayers.rmsnorm({"scale": ln["scale"]}, jnp.asarray(x)))
    xb = torch.tensor(x, dtype=torch.bfloat16)
    jb = jnp.asarray(x, jnp.bfloat16)
    got = layers.rmsnorm({"scale": T(ln["scale"])}, xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(
        jlayers.rmsnorm({"scale": ln["scale"]}, jb)).astype(np.float32))
    for name, fn in layers.ACTIVATIONS.items():
        close(fn(T(x)), jlayers.ACTIVATIONS[name](jnp.asarray(x)))
    emb = {"embedding": arr(rng, 40, 16)}
    ids = rng.integers(0, 40, (3, 7))
    close(layers.embed(tt(emb), T(ids)), jlayers.embed(emb, jnp.asarray(ids)))
    close(layers.embed_logits(tt(emb), T(x)), jlayers.embed_logits(emb, jnp.asarray(x)))


@pytest.mark.parametrize("gated,act", [(True, "gelu"), (True, "silu"), (False, "gelu")])
def test_ffn_and_mlp_match_jax(gated, act):
    rng = np.random.default_rng(1)
    x = arr(rng, 2, 6, 16)
    p = jlayers.init_ffn(jax.random.PRNGKey(1), 16, 32, gated, use_bias=not gated)
    close(layers.ffn(tt(p), T(x), act), jlayers.ffn(p, jnp.asarray(x), act))
    m = jlayers.init_mlp(jax.random.PRNGKey(2), (16, 24, 8, 4))
    close(layers.mlp(tt(m), T(x), final_activation=gated),
          jlayers.mlp(m, jnp.asarray(x), final_activation=gated))


def test_initializers_match_jax_in_law():
    """Same leaves, shapes and dtypes; per-leaf std and the truncation as
    JAX's draw."""
    gen = PRNGSeq(0, "cpu")
    cases = [
        (layers.init_ffn(next(gen), 64, 256, True, dtype=torch.bfloat16, device="cpu"),
         jlayers.init_ffn(jax.random.PRNGKey(0), 64, 256, True, dtype=jnp.bfloat16)),
        (layers.init_mlp(next(gen), (64, 128, 32), device="cpu"),
         jlayers.init_mlp(jax.random.PRNGKey(1), (64, 128, 32))),
        (attention.init_gqa(next(gen), 64, 4, 2, 32, qkv_bias=True, device="cpu"),
         jattn.init_gqa(jax.random.PRNGKey(2), 64, 4, 2, 32, qkv_bias=True)),
        (attention.init_mla(next(gen), 64, 4, 32, 16, 16, 8, 16, device="cpu"),
         jattn.init_mla(jax.random.PRNGKey(3), 64, 4, 32, 16, 16, 8, 16)),
        (moe.init_moe(next(gen), 8, 64, 128, n_shared=1, device="cpu"),
         jmoe.init_moe(jax.random.PRNGKey(4), 8, 64, 128, n_shared=1)),
        ({"emb": layers.init_embedding(next(gen), 512, 64, device="cpu")},
         {"emb": jlayers.init_embedding(jax.random.PRNGKey(5), 512, 64)}),
    ]
    from repro.common.pytree import named_leaves as jnamed

    from repro_torch.common.pytree import named_leaves

    for port, ref in cases:
        got, want = named_leaves(port), jnamed(ref)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (n, a), (_, b) in zip(got, want):
            b = np.asarray(b).astype(np.float32)
            a32 = a.float().numpy()
            assert a32.shape == b.shape, n
            assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype) or (
                a.dtype == torch.bfloat16), n
            if b.std() == 0:
                assert np.array_equal(a32, b), n
                continue
            assert abs(a32.std() / b.std() - 1) < 4 / np.sqrt(b.size), (n, a32.std(), b.std())
    t = layers.variance_scaling(next(gen), (256, 512), device="cpu") * 256 ** 0.5
    assert float(t.abs().max()) <= 2.0 and abs(float(t.std()) - 0.8796) < 0.01


def test_large_draws_are_made_a_slice_at_a_time(monkeypatch):
    """A draw past the chunk size writes bf16 slices, in the same law."""
    monkeypatch.setattr(layers, "_DRAW_CHUNK", 1000)
    t = layers.variance_scaling(torch.Generator().manual_seed(0), (8, 64, 32),
                                dtype=torch.bfloat16, device="cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (8, 64, 32)
    per = t.float().reshape(8, -1).std(dim=1) * (8 * 64) ** 0.5      # fan_in 8 x 64
    assert torch.all((per - 0.8796).abs() < 0.05)
    assert not torch.equal(t[0], t[1])


# --------------------------------------------------------------------------
# RoPE, masking, flash attention
# --------------------------------------------------------------------------

def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = arr(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 3000, (2, 9))
    for base in (10000.0, 1_000_000.0):
        close(attention.apply_rope(T(x), T(pos), base),
              jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), base), atol=1e-5)


@pytest.mark.parametrize("causal,chunk", [(True, None), (True, 5), (False, None), (False, 4)])
def test_allowed_matches_jax(causal, chunk):
    q = np.array([[-1, 0, 3, 7, 9], [2, 4, 5, 6, 11]])
    kv = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 2 ** 30])
    got = attention._allowed(T(q), T(kv), causal=causal, chunk=chunk, kv_len=T(9))
    want = jattn._allowed(jnp.asarray(q), jnp.asarray(kv), causal=causal, chunk=chunk,
                          kv_len=jnp.asarray(9))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("T_,S,H,Kv,qb,kb,causal,chunk", [
    (16, 16, 4, 4, 8, 8, True, None),     # block multiples, MHA
    (13, 13, 4, 2, 8, 4, True, None),     # T and S off the blocks, GQA
    (21, 21, 6, 1, 16, 8, True, 6),       # chunked local attention, MQA
    (7, 19, 2, 2, 4, 8, False, None),     # S > T, padded keys are zero rows
    (5, 5, 2, 1, 16, 16, True, None),     # one block larger than T
])
def test_flash_attention_matches_jax(T_, S, H, Kv, qb, kb, causal, chunk):
    rng = np.random.default_rng(3)
    B, D = 2, 16
    q, k, v = arr(rng, B, T_, H, D), arr(rng, B, S, Kv, D), arr(rng, B, S, Kv, 24)
    qpos = np.broadcast_to(np.arange(S - T_, S), (B, T_)).copy()
    kvpos = np.arange(S)
    kw = dict(causal=causal, chunk=chunk, q_block=qb, kv_block=kb)
    got = attention.flash_attention(T(q), T(k), T(v), T(qpos), T(kvpos), **kw)
    want = jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v, qpos, kvpos)), **kw)
    assert got.shape == (B, T_, H, 24)
    close(got, want, A_RTOL, A_ATOL)


def test_flash_attention_padded_rows_are_zero():
    """Query rows that see no key (position -1) come out 0, not NaN, with
    and without the autograd tape."""
    rng = np.random.default_rng(4)
    q, k, v = arr(rng, 1, 6, 2, 8), arr(rng, 1, 6, 2, 8), arr(rng, 1, 6, 2, 8)
    qpos = np.array([[-1, -1, 0, 1, 2, 3]])
    want = jattn.flash_attention(*(jnp.asarray(a) for a in (q, k, v, qpos, np.arange(6))),
                                 q_block=4, kv_block=4)
    tq = T(q).requires_grad_(True)
    got = attention.flash_attention(tq, T(k), T(v), T(qpos), torch.arange(6), q_block=4,
                                    kv_block=4)
    assert torch.equal(got[0, :2], torch.zeros_like(got[0, :2]))
    close(got, want, A_RTOL, A_ATOL)
    got.sum().backward()
    assert torch.isfinite(tq.grad).all() and torch.equal(tq.grad[0, :2], torch.zeros(2, 2, 8))


@pytest.mark.parametrize("chunk", [None, 4])
def test_decode_attention_matches_jax(chunk):
    rng = np.random.default_rng(5)
    q, kc, vc = arr(rng, 3, 1, 4, 16), arr(rng, 3, 12, 2, 16), arr(rng, 3, 12, 2, 16)
    for kv_len in (1, 7, 12):
        got = attention.decode_attention(T(q), T(kc), T(vc), kv_len, chunk=chunk)
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), kv_len,
                                      chunk=chunk)
        close(got, want, A_RTOL, A_ATOL)
    with pytest.raises(ValueError, match="scalar"):
        attention.decode_attention(T(q), T(kc), T(vc), torch.tensor([3, 4, 5]))


# --------------------------------------------------------------------------
# GQA and MLA blocks
# --------------------------------------------------------------------------

def _gqa_case(rng, bias):
    p = jattn.init_gqa(jax.random.PRNGKey(6), 32, 4, 2, 8, qkv_bias=bias)
    if bias:
        p = {**p, **{k: jnp.asarray(arr(rng, *p[k].shape, scale=0.1)) for k in ("bq", "bk", "bv")}}
    return p


@pytest.mark.parametrize("bias,chunk", [(False, None), (True, 4)])
def test_gqa_train_prefill_decode_match_jax(bias, chunk):
    rng = np.random.default_rng(7)
    p = _gqa_case(rng, bias)
    B, Tn = 2, 11
    x = arr(rng, B, Tn, 32)
    pos = np.broadcast_to(np.arange(Tn), (B, Tn)).copy()
    kw = dict(rope_base=500000.0, chunk=chunk, q_block=4, kv_block=4)
    close(attention.gqa_train(tt(p), T(x), T(pos), **kw),
          jattn.gqa_train(p, jnp.asarray(x), jnp.asarray(pos), **kw), A_RTOL, A_ATOL)
    out, cache = attention.gqa_prefill(tt(p), T(x[:, :-1]), T(pos[:, :-1]), 16, **kw)
    jout, jcache = jattn.gqa_prefill(p, jnp.asarray(x[:, :-1]), jnp.asarray(pos[:, :-1]), 16,
                                     **kw)
    close(out, jout, A_RTOL, A_ATOL)
    for a, b in zip(cache, jcache):
        close(a, b, A_RTOL, A_ATOL)
    kc_before = cache[0]
    d, dcache = attention.gqa_decode(tt(p), T(x[:, -1:]), cache, Tn, rope_base=500000.0,
                                     chunk=chunk)
    jd, jdcache = jattn.gqa_decode(p, jnp.asarray(x[:, -1:]), jcache, Tn, rope_base=500000.0,
                                   chunk=chunk)
    close(d, jd, A_RTOL, A_ATOL)
    for a, b in zip(dcache, jdcache):
        close(a, b, A_RTOL, A_ATOL)
    assert dcache[0] is kc_before                       # written in place


def test_mla_train_prefill_decode_match_jax():
    rng = np.random.default_rng(8)
    dims = dict(qk_nope=8, qk_rope=4, kv_lora=12)
    p = jattn.init_mla(jax.random.PRNGKey(9), 32, 4, 16, 12, 8, 4, 8)
    p = {**p, "q_norm": {"scale": jnp.asarray(1 + arr(rng, 16, scale=0.1))}}
    B, Tn = 2, 10
    x = arr(rng, B, Tn, 32)
    pos = np.broadcast_to(np.arange(Tn), (B, Tn)).copy()
    kw = dict(**dims, q_block=4, kv_block=8)
    close(attention.mla_train(tt(p), T(x), T(pos), **kw),
          jattn.mla_train(p, jnp.asarray(x), jnp.asarray(pos), **kw), A_RTOL, A_ATOL)
    out, cache = attention.mla_prefill(tt(p), T(x[:, :-1]), T(pos[:, :-1]), 12, **kw)
    jout, jcache = jattn.mla_prefill(p, jnp.asarray(x[:, :-1]), jnp.asarray(pos[:, :-1]), 12,
                                     **kw)
    close(out, jout, A_RTOL, A_ATOL)
    for a, b in zip(cache, jcache):
        assert a.shape == b.shape
        close(a, b, A_RTOL, A_ATOL)
    d, dcache = attention.mla_decode(tt(p), T(x[:, -1:]), cache, torch.tensor(Tn), **dims)
    jd, jdcache = jattn.mla_decode(p, jnp.asarray(x[:, -1:]), jcache, Tn, **dims)
    close(d, jd, A_RTOL, A_ATOL)
    for a, b in zip(dcache, jdcache):
        close(a, b, A_RTOL, A_ATOL)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

def test_capacity_matches_jax():
    for args in [(16, 2, 8, 1.25), (3, 1, 128, 1.25), (1000, 8, 256, 1.0), (7, 2, 4, 8.0),
                 (1, 1, 1, 0.5)]:
        assert moe._capacity(*args) == jmoe._capacity(*args)


def test_top_k_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(10)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    vals, idx = moe._top_k(T(probs), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 5)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("case", ["keeps", "drops", "parked_overlap"])
def test_pack_dispatch_matches_jax(case):
    rng = np.random.default_rng(11)
    N, k, n_local, d = 12, 2, 3, 5
    x = arr(rng, N, d)
    eid = rng.integers(-1, n_local + 1, (N, k))                # out-of-range ids are dropped
    cap = {"keeps": 2 * N, "drops": 3, "parked_overlap": 2}[case]
    if case == "parked_overlap":
        eid[:, 0] = n_local - 1          # expert n_local-1 fills its last slot, the rest park there
    gate = rng.random((N, k)).astype(np.float32)
    got = moe._pack_dispatch(T(x), T(eid), T(gate), n_local, cap)
    want = jmoe._pack_dispatch(jnp.asarray(x), jnp.asarray(eid), jnp.asarray(gate), n_local, cap)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    buf, _, _, keep, _ = got
    if case != "keeps":
        assert not keep.all()
    if case == "parked_overlap":
        assert torch.equal(buf[n_local - 1, cap - 1], T(x[1]))   # the kept row survives


@pytest.mark.parametrize("gated,shared,tied", [(True, 1, False), (False, 0, False),
                                               (True, 0, True)])
def test_moe_apply_dense_matches_jax(gated, shared, tied):
    rng = np.random.default_rng(12)
    p = jmoe.init_moe(jax.random.PRNGKey(13), 8, 16, 24, gated=gated, n_shared=shared)
    if tied:   # every router probability equal: the top-k is experts 0..k-1
        p = {**p, "router": jnp.zeros_like(p["router"])}
    x = arr(rng, 2, 7, 16)
    y, aux = moe.moe_apply_dense(tt(p), T(x), n_experts=8, top_k=3)
    jy, jaux = jmoe.moe_apply_dense(p, jnp.asarray(x), n_experts=8, top_k=3)
    close(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if tied:
        _, eid, _ = moe._route(T(x).reshape(-1, 16), T(p["router"]), 8, 3)
        assert (eid == torch.arange(3)).all()


def test_moe_param_specs_match_jax():
    for layout in ("ep", "ffslice"):
        for stacked in (False, True):
            want = jmoe.moe_param_specs(layout, stacked=stacked)
            got = moe.moe_param_specs(layout, stacked=stacked)
            assert got == {k: tuple(v) for k, v in want.items()}


def test_nn_exports_jax_names():
    import repro.nn as jnn

    import repro_torch.nn as tnn

    assert tnn.__all__ == jnn.__all__
    for name in tnn.__all__:
        assert getattr(tnn, name).__name__ == f"repro_torch.nn.{name}"



def test_use_cp_matches_jax():
    """The context-parallel choice: a "model" axis that divides T into
    blocks of at least 128 rows."""
    from types import SimpleNamespace

    for names, shape in [(("data", "model"), (2, 4)), (("model",), (8,)), (("data",), (8,)),
                         (("pod", "data", "model"), (2, 2, 2))]:
        jmesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
        tmesh = SimpleNamespace(mesh_dim_names=names, shape=shape)
        for T_ in (128, 256, 512, 1000, 1024, 4096):
            assert attention._use_cp(tmesh, T_) == jattn._use_cp(jmesh, T_), (names, T_)
    assert not attention._use_cp(None, 4096) and not jattn._use_cp(None, 4096)
