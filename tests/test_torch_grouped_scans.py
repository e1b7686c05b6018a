"""The one-launch IVF first stage and the residual scan as the card runs
them, grouped by list, held on the CPU.

- ``ref.query_fused_grouped`` is ``query_fused``'s plain twin as the card
  computes it (csrc/query_fused.cu): the psi-pool, the scan through
  ``ref.ivf_scan_grouped`` (the (b, p) pairs grouped by list, 8 a work
  item), the stable flat top-k'.  It is held to ``ref.query_fused_ref`` bit
  for bit where every row has one nonzero value (each dot is one rounded
  product, whatever the order or the shape of the product), and otherwise
  with ids equal up to counted near-ties; to JAX's ``query_fused`` in
  interpret mode within the JAX suite's bounds, fp32 and SQ8 lists.
- The residual scan (csrc/ivf_probe_res_scan.cu) groups the (b, p) pairs
  by list, 4 a work item, and gives each (row, query) the bits of
  ``ref.res_scan_split`` (q . c of the list plus the table's terms summed a
  512-dim tile at a time); out-of-range probes are a strip of -inf.  Under
  the grouping's hard cases (one list with 20 readers, empty lists, holes,
  duplicate and out-of-range probes, cap 1 and cap 300) at 2 and 4 bits and
  d' 2,048, 2,044 and 2,040, ``ref.res_scan_split`` with those strips is
  held to JAX's ``ivf_probe_res_scan`` in interpret mode (rtol 1e-5, atol
  1e-4: another sum order), and ``ref.probe_groups`` to the chunks the
  kernel takes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gather_scan as jax_gs
from repro.kernels.query_fused import query_fused as jax_query_fused

from repro_torch.anns.quantization import sq8_quant
from repro_torch.kernels import ref

SQ8_RTOL = 2 ** -16 * 4
RTOL, ATOL, TIE = 1e-5, 1e-4, 1e-5


def T(x):
    return torch.as_tensor(np.array(x))


def _ids(rng, case, nlist, cap):
    ids = rng.permutation(10 ** 6)[:nlist * cap].reshape(nlist, cap).astype(np.int32)
    live = rng.integers(cap // 2, cap + 1, nlist) if cap > 1 else np.ones(nlist, np.int64)
    ids[np.arange(cap)[None, :] >= live[:, None]] = -1
    if case == "empty_lists":
        ids[[1, 5]] = -1
    elif case == "holes":
        ids[rng.random(ids.shape) < 0.2] = -1
    return ids


def _probes(rng, case, B, nlist, nprobe):
    probe = np.stack([rng.permutation(nlist)[:nprobe] for _ in range(B)]).astype(np.int32)
    if case == "one_list":                         # every query probes list 2: 20 readers
        probe[:, 1] = 2
        probe[probe[:, 0] == 2, 0] = 0
        probe[probe[:, 2] == 2, 2] = 0
    elif case == "empty_lists":
        probe[0, :2] = [1, 5]
    elif case == "dup_out_of_range":
        probe[0, 1] = probe[0, 0]
        probe[1, 2] = -1
        probe[2, 0] = nlist + 3
    return probe


@pytest.mark.parametrize("case,B,nlist,cap,dp,nprobe,bits", [
    ("one_list", 20, 6, 40, 64, 3, 4),
    ("one_list", 20, 6, 40, 64, 3, 2),
    ("empty_lists", 6, 8, 16, 64, 4, 4),
    ("holes", 5, 6, 300, 64, 3, 2),                # cap 300: off the 256-slot items
    ("dup_out_of_range", 5, 6, 24, 2048, 4, 4),
    ("cap_1", 7, 9, 1, 2048, 4, 2),
    ("whole_words", 3, 4, 12, 2048, 2, 2),
    ("bytes", 3, 4, 12, 2044, 2, 4),               # rows of 1,022 B: not whole words
    ("bytes", 3, 4, 12, 2040, 2, 2),               # 510 B
])
def test_res_scan_grouped(case, B, nlist, cap, dp, nprobe, bits):
    rng = np.random.default_rng(B * nlist + cap + dp + bits)
    ids = _ids(rng, case, nlist, cap)
    probe = _probes(rng, case, B, nlist, nprobe)
    codes = rng.integers(0, 256, (nlist, cap, dp * bits // 8)).astype(np.uint8)
    cent = rng.standard_normal((nlist, dp))
    cent = (cent / np.linalg.norm(cent, axis=1, keepdims=True)).astype(np.float32)
    values = np.sort(rng.standard_normal((dp, 1 << bits)) * 0.02, axis=1).astype(np.float32)
    qv = rng.standard_normal((B, dp))
    qv = (qv / np.linalg.norm(qv, axis=1, keepdims=True)).astype(np.float32)
    lists = (ids, codes, cent, values)
    inr = (probe >= 0) & (probe < nlist)
    clamped = np.clip(probe, 0, nlist - 1).astype(np.int32)
    got = ref.res_scan_split(T(qv), T(clamped), *map(T, lists))
    got = torch.where(T(inr)[..., None], got, float("-inf"))
    fin = torch.isfinite(got)
    assert fin.any()
    if case == "one_list":                         # 20 readers: five chunks of list 2
        _, _, chunks = ref.probe_groups(T(probe), nlist, 4)
        assert int((chunks[:, 0] == 2).sum()) == 5
    pallas = np.asarray(jax_gs.ivf_probe_res_scan(*(jnp.asarray(a) for a in (
        qv, clamped, *lists)), interpret=True))
    g, f = got.numpy()[inr], fin.numpy()[inr]
    np.testing.assert_array_equal(np.isfinite(pallas[inr]), f)
    np.testing.assert_allclose(g[f], pallas[inr][f], rtol=RTOL, atol=ATOL)


def _psi(rng, d, dp):
    return ((rng.standard_normal((d, dp)) * 0.1).astype(np.float32),
            (rng.standard_normal(dp) * 0.01).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(dp)).astype(np.float32),
            (0.1 * rng.standard_normal(dp)).astype(np.float32))


def _same_topk(want_s, want_i, got_s, got_i, tol):
    """Pads equal, scores within tol x max(1, max|want|), ids equal up to
    near-ties (relative gap < 1e-5)."""
    want_s, want_i, got_s, got_i = map(np.asarray, (want_s, want_i, got_s, got_i))
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    assert (got_i[~fin] == -1).all() and (want_i[~fin] == -1).all()
    scale = max(1.0, float(np.abs(want_s[fin]).max()))
    assert np.abs(got_s[fin] - want_s[fin]).max() <= tol * scale
    diff = got_i != want_i
    gap = np.zeros(want_s.shape)
    gap[fin] = np.abs(got_s[fin] - want_s[fin]) / np.maximum(np.abs(want_s[fin]), 1.0)
    assert np.all(gap[diff] < TIE), "an id differs without a near-tie"


@pytest.mark.parametrize("case,B,nlist,cap,nprobe,kp", [
    ("one_hot", 20, 6, 40, 3, 50),       # 20 readers of list 2: three chunks of 8
    ("one_hot", 5, 6, 24, 4, 200),       # kp > the valid slots
    ("dense", 20, 6, 40, 3, 50),
    ("dense_dup", 5, 6, 24, 4, 30),      # a list probed twice by a query
])
@pytest.mark.parametrize("sq8", [False, True], ids=["fp32", "sq8"])
def test_query_fused_grouped(case, B, nlist, cap, nprobe, kp, sq8):
    rng = np.random.default_rng(B * nlist + cap + kp + sq8)
    d, dp, Tq = 16, 64, 5
    w = _psi(rng, d, dp)
    qt = rng.standard_normal((B, Tq, d)).astype(np.float32)
    qm = rng.random((B, Tq)) > 0.3
    qm[:, 0] = True
    ids = _ids(rng, "holes", nlist, cap)
    probe = _probes(rng, "one_list" if B == 20 else "", B, nlist, nprobe)
    if case == "dense_dup":
        probe[0, 1] = probe[0, 0]
    if case == "one_hot":            # one nonzero a row: every dot one rounded product
        vecs = np.zeros((nlist, cap, dp), np.float32)
        vecs[np.arange(nlist)[:, None], np.arange(cap)[None, :],
             rng.integers(0, dp, (nlist, cap))] = rng.integers(-8, 9, (nlist, cap))
    else:
        vecs = rng.standard_normal((nlist, cap, dp)).astype(np.float32)
    vecs *= (ids >= 0)[..., None]
    lists = [T(vecs)]
    if sq8:
        lists = list(sq8_quant(T(vecs)))
    args = (T(qt), T(qm), *map(T, w), T(probe), T(ids), *lists)
    got = ref.query_fused_grouped(*args, kp=kp)
    want = ref.query_fused_ref(*args, kp=kp)
    if case == "one_hot":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        _same_topk(*want, *got, 1e-6)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    ks, ki = jax_query_fused(*jargs, kp=kp, interpret=True)
    _same_topk(ks, ki, *got, SQ8_RTOL if sq8 else RTOL)
