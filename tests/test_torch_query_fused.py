"""The port's one-launch kernels, query_fused and mips_topk, held against the
JAX package's on the same inputs.

The port's wrappers run their plain versions for CPU tensors (what this
file reaches; ``tests/test_torch_cuda.py`` holds the CUDA kernels to those
plain versions on the card), and they are compared with the JAX oracles
(``repro.kernels.ref.query_fused_ref`` / ``mips_topk_ref``) and the JAX
Pallas kernels in interpret mode.  The grid covers fp32 and SQ8 lists or
rows, -1 pad slots, exact score ties from duplicated rows and slots, B=1,
cap and m off the tile, ``valid`` holes, kp above the valid rows and kp
above the whole strip.  Inputs are made with numpy from a seed.

Tolerances: scores rtol 1e-5 / atol 1e-4 against the fp32 oracles (another
sum order); SQ8 within 2^-16 * 4 of the largest score against the interpret
kernels (their hi/lo bf16 split); ids equal up to counted near-ties
(relative gap < 1e-5), and exactly equal wherever the reference has an
exact tie (the tie rule: the lower flat position first).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.query_fused import mips_topk as jax_mips_topk
from repro.kernels.query_fused import query_fused as jax_query_fused

from repro_torch.anns.quantization import sq8_quant
from repro_torch.kernels import ops, query_fused as qf

SQ8_RTOL = 2 ** -16 * 4
TIE = 1e-5


def T(x):
    return torch.as_tensor(np.array(x))


def assert_same_topk(want_s, want_i, got_s, got_i, *, rtol=1e-5, atol=1e-4, sq8=False,
                     exact_ties=True):
    """Scores within tolerance (SQ8: 2^-16 * 4 of the largest), ids equal up
    to counted near-ties, and equal exactly at the reference's exact ties
    (``exact_ties``)."""
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    fin = np.isfinite(want_s)
    assert np.array_equal(np.isfinite(got_s), fin)
    assert (got_s[~fin] == -np.inf).all() and (got_i[~fin] == -1).all()
    if sq8:
        scale = max(1.0, float(np.abs(want_s[fin]).max()))
        assert np.abs(got_s[fin] - want_s[fin]).max() <= SQ8_RTOL * scale
    else:
        np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=rtol, atol=atol)
    diff = got_i != want_i
    gap = np.abs(np.where(fin, got_s, 0.0) - np.where(fin, want_s, 0.0))
    gap /= np.maximum(np.abs(want_s), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"
    assert diff.sum() <= max(1, diff.size // 50), f"{diff.sum()} near-ties"
    tied = np.zeros_like(diff)
    tied[:, 1:] |= want_s[:, 1:] == want_s[:, :-1]
    tied[:, :-1] |= want_s[:, 1:] == want_s[:, :-1]
    tied &= fin
    assert not (exact_ties and diff[tied].any()), "an exact tie broke another way"
    return int(tied.sum())


def _psi(rng, d, dp):
    return ((rng.standard_normal((d, dp)) * 0.1).astype(np.float32),
            (rng.standard_normal(dp) * 0.01).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(dp)).astype(np.float32),
            (0.1 * rng.standard_normal(dp)).astype(np.float32))


def _setup(rng, B, Tq, d, dp, nlist, cap, n_pad, tie_slots, nprobe):
    w = _psi(rng, d, dp)
    qt = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    ids = rng.permutation(10_000)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    vecs = rng.standard_normal((nlist, cap, dp)).astype(np.float32)
    if n_pad:
        ids[:, cap - n_pad:] = -1
        vecs[:, cap - n_pad:] = 0
    live = max(cap - n_pad, 1)
    for j in range(tie_slots):       # duplicated rows: exact score ties
        vecs[(j + 1) % nlist, (2 * j + 1) % live] = vecs[j % nlist, j % live]
    cents = rng.standard_normal((nlist, dp)).astype(np.float32)
    psi_q = jax_ref.psi_pool_ref(jnp.asarray(qt), jnp.asarray(qm),
                                 *map(jnp.asarray, w))
    probe = np.asarray(jnp.argsort(-(psi_q @ jnp.asarray(cents).T), axis=1,
                                   stable=True)[:, :nprobe]).astype(np.int32)
    return w, qt, qm, ids, vecs, cents, probe


@pytest.mark.parametrize("B,Tq,d,dp,nlist,cap,nprobe,kp,n_pad,ties", [
    (4, 6, 16, 32, 8, 10, 3, 12, 3, 0),     # -1 pad slots in the strip
    (4, 6, 16, 32, 8, 10, 3, 12, 0, 6),     # exact score ties
    (1, 5, 16, 32, 6, 7, 2, 9, 2, 3),       # B=1, cap odd
    (3, 4, 16, 32, 4, 5, 4, 40, 4, 0),      # kp > the valid slots
    (2, 3, 8, 16, 5, 11, 5, 60, 0, 2),      # kp > the whole strip
])
@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
def test_query_fused_matches_jax(B, Tq, d, dp, nlist, cap, nprobe, kp, n_pad, ties, sq8):
    rng = np.random.default_rng(B * 100 + cap + n_pad + ties)
    w, qt, qm, ids, vecs, _, probe = _setup(rng, B, Tq, d, dp, nlist, cap, n_pad,
                                            ties, nprobe)
    lists = [vecs]
    if sq8:
        codes, scales = sq8_quant(T(vecs))
        lists = [codes.numpy(), scales.numpy()]
    n0 = qf.query_fused.launches
    got_s, got_i = qf.query_fused(T(qt), T(qm), *map(T, w), T(probe), T(ids),
                                  *map(T, lists), kp=kp)
    assert qf.query_fused.launches == n0                 # the CPU runs no kernel
    assert got_s.shape == (B, kp) and got_i.dtype == torch.int32
    jargs = (jnp.asarray(qt), jnp.asarray(qm), *map(jnp.asarray, w), jnp.asarray(probe),
             jnp.asarray(ids), *map(jnp.asarray, lists))
    want_s, want_i = jax_ref.query_fused_ref(*jargs, kp=kp)
    assert_same_topk(want_s, want_i, got_s, got_i)
    ks, ki = jax_query_fused(*jargs, kp=kp, interpret=True)
    assert_same_topk(ks, ki, got_s, got_i, sq8=sq8)
    # the chunked plain version: products of another shape, which on the CPU
    # may round two equal rows apart (a one-row product takes another path)
    cs, ci = qf.query_fused(T(qt), T(qm), *map(T, w), T(probe), T(ids),
                            *map(T, lists), kp=kp, chunk=1)
    assert_same_topk(got_s, got_i, cs, ci, exact_ties=False)


def test_query_fused_ties_keep_the_lower_flat_position():
    """Every slot of two probed lists holds the same row: all scores tie and
    the ids come out in flat order (probe by probe, slot by slot)."""
    rng = np.random.default_rng(5)
    w, qt, qm, ids, vecs, _, _ = _setup(rng, 2, 4, 8, 16, 3, 6, 1, 0, 2)
    vecs[:] = vecs[0, 0]
    probe = np.array([[2, 0], [1, 2]], np.int32)
    s, i = qf.query_fused(T(qt), T(qm), *map(T, w), T(probe), T(ids), T(vecs), kp=8)
    for b in range(2):
        flat = ids[probe[b]].reshape(-1)
        want = flat[flat >= 0][:8]
        assert np.array_equal(i[b, :len(want)].numpy(), want)


def test_fused_query_prelude_matches_jax():
    """ops.fused_query selects the probes itself (pool, centroid product,
    top-nprobe) before the fused kernel, as the JAX ops.fused_query does."""
    from repro.kernels import ops as jax_ops
    from repro_torch.core.model import Psi

    rng = np.random.default_rng(9)
    w, qt, qm, ids, vecs, cents, _ = _setup(rng, 5, 6, 16, 32, 8, 10, 2, 0, 3)
    jpsi = {"dense": {"kernel": jnp.asarray(w[0]), "bias": jnp.asarray(w[1])},
            "ln": {"scale": jnp.asarray(w[2]), "bias": jnp.asarray(w[3])}}
    want_s, want_i = jax_ops.fused_query(jnp.asarray(qt), jnp.asarray(qm), jpsi,
                                         jnp.asarray(cents), jnp.asarray(ids),
                                         jnp.asarray(vecs), nprobe=3, kp=20)
    got_s, got_i = ops.fused_query(T(qt), T(qm), Psi.from_arrays(*w, device="cpu"),
                                   T(cents), T(ids), T(vecs), nprobe=3, kp=20)
    assert_same_topk(want_s, want_i, got_s, got_i)


@pytest.mark.parametrize("B,m,dp,kp,holes", [
    (4, 37, 16, 9, 0.2),      # m off the tile, valid holes
    (1, 16, 16, 16, 0.0),     # B=1, kp == m
    (3, 50, 32, 50, 0.3),     # kp == m: NEG rows enter with their positions
    (2, 40, 16, 55, 0.25),    # kp > m: (-inf, -1) pads
    (5, 700, 24, 64, 0.1),    # more rows than a kernel tile
])
@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
def test_mips_topk_matches_jax(B, m, dp, kp, holes, sq8):
    rng = np.random.default_rng(m + kp)
    q = rng.standard_normal((B, dp)).astype(np.float32)
    W = rng.standard_normal((m, dp)).astype(np.float32)
    W[m // 2] = W[m // 3]                 # duplicated rows: an exact tie
    W[m - 1] = W[0]
    valid = rng.random(m) >= holes
    args = [W, None]
    if sq8:
        codes, scales = sq8_quant(T(W))
        args = [codes.numpy(), scales.numpy()]
    n0 = qf.mips_topk.launches
    got_s, got_i = qf.mips_topk(T(q), *(None if a is None else T(a) for a in args),
                                T(valid), kp=kp)
    assert qf.mips_topk.launches == n0
    assert got_s.shape == (B, kp) and got_i.dtype == torch.int32
    jargs = (jnp.asarray(q), *(None if a is None else jnp.asarray(a) for a in args),
             jnp.asarray(valid))
    # with kp > m the JAX kernel also returns the rows it pads m up to its
    # tile with (NEG, positions >= m); the port has no such rows and pads
    # with (-inf, -1) instead, so the first m columns are compared
    mm = min(kp, m)
    ks, ki = jax_mips_topk(*jargs, kp=kp, block_m=16, interpret=True)
    assert_same_topk(np.asarray(ks)[:, :mm], np.asarray(ki)[:, :mm], got_s[:, :mm],
                     got_i[:, :mm], sq8=sq8)
    if kp <= m:                         # the JAX oracle's top_k needs kp <= m
        want_s, want_i = jax_ref.mips_topk_ref(*jargs, kp=kp)
        assert_same_topk(want_s, want_i, got_s, got_i)
    else:
        assert (got_i[:, m:] == -1).all() and torch.isneginf(got_s[:, m:]).all()
    # invalid rows score NEG and keep their positions
    neg = got_s == jax_ref.NEG
    assert bool((~torch.as_tensor(valid)[got_i[neg].long()]).all())
    cs, ci = qf.mips_topk(T(q), *(None if a is None else T(a) for a in args),
                          T(valid), kp=kp, chunk=2)
    assert_same_topk(got_s, got_i, cs, ci, exact_ties=False)


def test_mips_topk_fused_is_the_blocked_scan():
    """ops.mips_topk_fused and the blocked exact scan give the same ids over
    a slot capacity with dead slots (the facade's two exact routes)."""
    from repro_torch.anns.bruteforce import mips_topk as blocked

    rng = np.random.default_rng(3)
    q = T(rng.standard_normal((6, 32)).astype(np.float32))
    W = T(rng.standard_normal((300, 32)).astype(np.float32))
    alive = T(rng.random(300) > 0.2)
    s0, i0 = blocked(q, W, 40, block=64, valid=alive)
    s1, i1 = ops.mips_topk_fused(q, W, None, 40, valid=alive)
    assert_same_topk(s0, i0, s1, i1)


@pytest.mark.parametrize("kp", [0, 8192])
def test_kernels_take_any_kp_from_one(kp, monkeypatch):
    """The CUDA path checks kp before it touches the card; tensors on the
    meta device take that path here.  kp = 0 is refused; k' = 8192, past
    the shared-memory lists' old limits (4,096 dense, 2,048 one-launch),
    passes every argument check and reaches the kernels' library (the
    one-launch kernel on a pooled latent, as the route calls it)."""
    from repro_torch.kernels import build

    class Reached(Exception):
        pass

    def library(name):
        raise Reached(name)

    monkeypatch.setattr(build, "library", library)
    meta = torch.device("meta")
    q = torch.empty((2, 64), device=meta)
    qt = torch.empty((2, 3, 8), device=meta)
    w = (torch.empty((8, 64), device=meta), *[torch.empty(64, device=meta)] * 3)
    calls = [lambda: qf.mips_topk(q, torch.empty((20000, 64), device=meta), kp=kp),
             lambda: qf.query_fused(qt, None, *w,
                                    torch.empty((2, 16), dtype=torch.int32, device=meta),
                                    torch.empty((4, 1024), dtype=torch.int32, device=meta),
                                    torch.empty((4, 1024, 64), device=meta), kp=kp,
                                    latent=q)]
    for call in calls:
        with pytest.raises(ValueError if kp == 0 else Reached,
                           match="kp >= 1" if kp == 0 else "query_fused"):
            call()


def test_mips_topk_at_the_sharded_default_kp():
    """k' = 4096, the sharded path's per-shard default on one shard
    (``default_k_prime_local(100, 1024, 1)``): the port's plain version
    against JAX's oracle."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    W = rng.standard_normal((6000, 32)).astype(np.float32)
    valid = rng.random(6000) > 0.1
    for sq8 in (False, True):
        args = [W, None]
        if sq8:
            codes, scales = sq8_quant(T(W))
            args = [codes.numpy(), scales.numpy()]
        got = qf.mips_topk(T(q), *(None if a is None else T(a) for a in args), T(valid),
                           kp=4096)
        want = jax_ref.mips_topk_ref(jnp.asarray(q), *(None if a is None else jnp.asarray(a)
                                                       for a in args),
                                     jnp.asarray(valid), kp=4096)
        assert got[0].shape == (3, 4096)
        assert_same_topk(*want, *got)


@pytest.mark.parametrize("case", ["mips_fp32", "mips_sq8", "query_fused", "query_fused_sq8"])
def test_plain_versions_past_the_old_caps(case):
    """k' = 8,192 over 20,000 rows (the dense scan) and over a 10,000-slot
    strip (the one-launch IVF), above both old card limits: the port's plain
    versions against JAX's oracles."""
    rng = np.random.default_rng(len(case))
    kp = 8192
    if case.startswith("mips"):
        q = rng.standard_normal((3, 32)).astype(np.float32)
        W = rng.standard_normal((20000, 32)).astype(np.float32)
        W[12345] = W[7]                       # an exact tie
        valid = rng.random(20000) > 0.2
        args = [W, None]
        if case == "mips_sq8":
            codes, scales = sq8_quant(T(W))
            args = [codes.numpy(), scales.numpy()]
        got = qf.mips_topk(T(q), *(None if a is None else T(a) for a in args), T(valid),
                           kp=kp)
        want = jax_ref.mips_topk_ref(jnp.asarray(q), *(None if a is None else jnp.asarray(a)
                                                       for a in args),
                                     jnp.asarray(valid), kp=kp)
    else:
        w, qt, qm, ids, vecs, _, probe = _setup(rng, 3, 4, 16, 32, 10, 1000, 100, 4, 10)
        lists = [vecs]
        if case == "query_fused_sq8":
            codes, scales = sq8_quant(T(vecs))
            lists = [codes.numpy(), scales.numpy()]
        got = qf.query_fused(T(qt), T(qm), *map(T, w), T(probe), T(ids), *map(T, lists),
                             kp=kp)
        want = jax_ref.query_fused_ref(jnp.asarray(qt), jnp.asarray(qm), *map(jnp.asarray, w),
                                       jnp.asarray(probe), jnp.asarray(ids),
                                       *map(jnp.asarray, lists), kp=kp)
    assert got[0].shape == (3, kp) and got[1].dtype == torch.int32
    assert_same_topk(*want, *got)


@pytest.mark.parametrize("sq8", [False, True], ids=["3xtf32", "q_split"])
def test_tf32_split_error(sq8):
    """The tensor-core product's split (csrc/tc_scan.cuh), emulated: the
    pieces by ref.tf32_rna (cvt.rna.tf32.f32), at d' = 2048 on the served
    query distribution (psi-pooled queries of 32 unit-norm tokens against
    rows of psi of a normalised mean token, the chip smoke's index).  Against
    an fp64 product: the split alone stays within its analytic bound, 3 x
    2^-22 x sum_k |q_k W_k| (each piece leaves 2^-22 of its value, and the
    dropped Wl.ql is as small), and summed as the kernel sums (64-column
    chunks, added in fp32) within ref.TF32_SPLIT_RTOL x max(1, max |score|),
    the tolerance of the card's checks."""
    from repro_torch.core.model import Psi, pool_queries
    from repro_torch.kernels import ref

    rng = np.random.default_rng(3)
    d, dp = 128, 2048
    psi = Psi.init(d, dp, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.nn.functional.normalize(T(rng.standard_normal((64, 32, d)).astype(np.float32)),
                                        dim=-1)
    q = pool_queries(psi, tok, torch.ones(64, 32, dtype=torch.bool))
    docs = torch.nn.functional.normalize(
        T(rng.standard_normal((3000, d)).astype(np.float32)), dim=-1)
    W = psi(docs)
    scales = None
    if sq8:
        W, scales = sq8_quant(W)
    exact = q.double() @ (W.double() if not sq8 else W.double()).T
    if sq8:
        exact = exact * scales.double()[None, :]
    split = ref.tf32_split_scores(q, W, scales).double()
    mag = q.double().abs() @ W.double().abs().T
    if sq8:
        mag = mag * scales.double()[None, :]
    # the fp64 sum of the pieces, rounded once to fp32 (half an ulp)
    assert bool(((split - exact).abs() <= 3 * 2.0 ** -22 * mag
                 + exact.abs() * 2.0 ** -24).all())
    fp32 = ref.tf32_split_scores(q, W, scales, chunk=64).double()
    err = float((fp32 - exact).abs().max())
    assert err <= ref.TF32_SPLIT_RTOL * max(1.0, float(exact.abs().max())), err
