"""The default route's two kernels as the card runs them, held on the CPU.

- The IVF probe scan walks lists, not queries: the (b, p) pairs are grouped
  by probe[b, p] first (csrc/ivf_probe_scan.cu: scan_group_kernel).
  ``ref.probe_groups`` is that grouping's plain twin, held exactly: each pair
  once, in the group of its list, empty lists, duplicates, out-of-range
  probes in one more group, the groups cut into runs of at most 8 pairs.
  ``ref.ivf_scan_grouped`` scores through it: as ``ref.ivf_scan_ref`` (to
  1e-6 of the largest score: the same dots, batched otherwise) and as
  JAX's ``ivf_probe_scan`` in interpret mode (the JAX suite's bounds) on the
  in-range strips; out-of-range strips -inf.
- The paged fp32 rerank runs on the tensor cores at the served widths:
  ``ref.tf32_split_rerank_paged`` emulates its TF32 split (3xTF32, sums
  restarted every 64 columns) and is held to fp64 MaxSim and to JAX's
  ``rerank_paged_scores`` in interpret mode within ref.TF32_SPLIT_RTOL x
  max(1, max |exact|), the card checks' tolerance, at d 128, 20 and 1,024
  and Tq 32 and 100, with -1, zero-token and duplicated candidates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.anns.quantization import sq8_quant as jax_sq8
from repro.kernels import gather_scan as jax_gs

from repro_torch.data import synthetic
from repro_torch.kernels import ref

SQ8_RTOL = 2 ** -16 * 4   # the JAX suite's SQ8 bound (tests/test_gather_scan.py)


def T(x):
    return torch.as_tensor(np.array(x))


def _probes(case, rng, B, nlist, nprobe):
    probe = np.stack([rng.permutation(max(nlist, nprobe))[:nprobe] for _ in range(B)])
    probe = probe.astype(np.int32)
    if case == "one_list":                      # every query probes list 0: 20 > 8 readers
        probe[:, 0] = 0
        probe[:, 1:][probe[:, 1:] == 0] = 1
    elif case == "dup_out_of_range":
        probe[0, 1] = probe[0, 0]
        probe[1, 2] = -1
        probe[2, 0] = nlist + 3
    return probe


@pytest.mark.parametrize("case,B,nlist,nprobe", [
    ("uniform", 9, 7, 3), ("one_list", 20, 6, 3), ("empty_lists", 6, 40, 2),
    ("dup_out_of_range", 5, 6, 4), ("nlist_1", 11, 1, 1)])
def test_probe_groups(case, B, nlist, nprobe):
    rng = np.random.default_rng(B + nlist)
    probe = _probes(case, rng, B, nlist, nprobe)
    off, pairs, chunks = ref.probe_groups(T(probe), nlist, chunk=8)
    flat = probe.reshape(-1)
    lst = np.where((flat >= 0) & (flat < nlist), flat, nlist)
    assert sorted(pairs.tolist()) == list(range(B * nprobe))     # each pair once
    assert off[0] == 0 and off[-1] == B * nprobe
    for l in range(nlist + 1):
        assert pairs[off[l]:off[l + 1]].tolist() == np.flatnonzero(lst == l).tolist()
    # the chunks cover each group in order, runs of at most 8
    want = [(l, int(off[l]) + k, min(8, int(off[l + 1] - off[l]) - k))
            for l in range(nlist + 1) for k in range(0, int(off[l + 1] - off[l]), 8)]
    assert [tuple(c) for c in chunks.tolist()] == want
    if case == "one_list":
        assert int(off[1] - off[0]) == B and (chunks[:, 0] == 0).sum() == 3
    if case == "empty_lists":
        assert int(((off[1:] - off[:-1])[:nlist] == 0).sum()) >= nlist - B * nprobe
    if case == "dup_out_of_range":
        assert int(off[nlist + 1] - off[nlist]) == 2


@pytest.mark.parametrize("case,B,nlist,cap,d,nprobe", [
    ("uniform", 4, 8, 5, 12, 3),
    ("one_list", 20, 6, 40, 16, 3),
    ("holes", 5, 6, 300, 20, 3),                # cap off the 32- and 256-slot tiles
    ("dup_out_of_range", 5, 6, 40, 2048, 4),
    ("cap_1", 7, 9, 1, 16, 4),
])
@pytest.mark.parametrize("sq8", [False, True])
def test_ivf_scan_grouped(case, B, nlist, cap, d, nprobe, sq8):
    rng = np.random.default_rng(B * nlist + cap + sq8)
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    live = rng.integers(0, cap + 1, nlist)
    ids[np.arange(cap)[None, :] >= live[:, None]] = -1
    ids[1] = -1                                     # an empty list
    if case == "holes":
        ids[rng.random(ids.shape) < 0.2] = -1
    vecs = (rng.standard_normal((nlist, cap, d)) * (ids >= 0)[..., None]).astype(np.float32)
    args = [jnp.asarray(vecs)]
    if sq8:
        args = list(jax_sq8(jnp.asarray(vecs)))
    q = rng.standard_normal((B, d)).astype(np.float32)
    probe = _probes(case, rng, B, nlist, nprobe)
    targs = [T(a) for a in args]
    got = ref.ivf_scan_grouped(T(q), T(probe), T(ids), *targs)
    inr = (probe >= 0) & (probe < nlist)
    clamped = np.clip(probe, 0, nlist - 1)
    want = ref.ivf_scan_ref(T(q), T(clamped), T(ids), *targs)
    want = torch.where(T(inr)[..., None], want, float("-inf"))
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and bool(torch.isneginf(got[~fin]).all())
    assert fin.any()
    denom = max(1.0, float(want[fin].abs().max()))
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-6 * denom
    pallas = np.asarray(jax_gs.ivf_probe_scan(jnp.asarray(q), jnp.asarray(clamped),
                                              jnp.asarray(ids), *args, interpret=True))
    g, f = got.numpy()[inr], np.isfinite(want.numpy()[inr])
    np.testing.assert_array_equal(np.isfinite(pallas[inr]), f)
    rel = SQ8_RTOL if sq8 else 1e-5                 # Pallas SQ8 is the hi/lo-bf16 split
    assert np.abs(g[f] - pallas[inr][f]).max(initial=0.0) / denom < rel


@pytest.mark.parametrize("d", [128, 20, 1024])
@pytest.mark.parametrize("Tq", [32, 100])
def test_rerank_paged_split_error(d, Tq):
    """The paged rerank's tensor-core arithmetic, emulated, on pages cut
    from the chip smoke's corpus distribution (Poisson(67.5) lengths in [4,
    80], unit tokens at topic weight 1.2), queries drawn as it draws them."""
    C, pmax, B, kp = 24, 5, 2, 12
    corpus = synthetic.make_corpus(m=C, d=d, avg_tokens=67.5, max_tokens=80, n_centers=64,
                                   seed=d + Tq)
    rng = np.random.default_rng(d + Tq)
    n_tokens = corpus.doc_mask.sum(1).astype(np.int32)
    n_tokens[1] = 0                                 # a doc without tokens
    perm = rng.permutation(C * pmax)
    pages = np.empty((C * pmax, 16, d), np.float32)
    pages[perm] = corpus.doc_tokens.reshape(C * pmax, 16, d)
    table = perm.reshape(C, pmax).astype(np.int32)
    table[np.arange(pmax)[None, :] >= (-(-n_tokens // 16))[:, None]] = -1
    q = synthetic.queries_from_corpus_query(corpus, B, q_tokens=Tq, seed=d)
    qm = np.ones((B, Tq), bool)
    qm[0, Tq // 2:] = False                         # a short query
    cand = rng.integers(-1, C, (B, kp)).astype(np.int32)
    cand[0, :3] = [-1, 1, 5]                        # a pad, the doc without tokens
    cand[1, 3] = cand[1, 4]
    args = (q, qm, cand, pages, table, n_tokens)
    got = ref.tf32_split_rerank_paged(*map(T, args))
    toks = T(pages)[T(table).long().clamp_min(0)].double().reshape(C, pmax * 16, d)
    c = T(cand).long().clamp_min(0)
    s = torch.einsum("bqd,bktd->bkqt", T(q).double(), toks[c])
    nt = torch.where(T(cand) >= 0, T(n_tokens)[c], 0)
    s = torch.where((torch.arange(pmax * 16) < nt[..., None])[:, :, None, :], s, ref.NEG)
    exact = torch.where(T(qm)[:, None, :], s.amax(-1), 0.0).sum(-1)
    real = exact > ref.NEG / 2
    tol = ref.TF32_SPLIT_RTOL * max(1.0, float(exact[real].abs().max()))
    assert float((got[real].double() - exact[real]).abs().max()) <= tol
    pallas = T(jax_gs.rerank_paged_scores(*(jnp.asarray(a) for a in args), interpret=True))
    assert float((got[real] - pallas[real]).abs().max()) <= tol
    assert bool(got[1, 3] == got[1, 4])
    # a -1 candidate and a doc without tokens score Tq_valid x NEG
    torch.testing.assert_close(got[0, :2], torch.full((2,), float(qm[0].sum()) * ref.NEG),
                               rtol=1e-6, atol=0.0)
