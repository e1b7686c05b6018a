"""The frozen reference against brute force at a tiny size."""
import torch

from bench import reference as R
from bench.corpus import Corpus


def brute_maxsim(q, qm, docs, counts):
    """MaxSim in fp64, one pair at a time."""
    out = []
    for i in range(q.shape[0]):
        d = docs[i, :int(counts[i])].double()
        s = q[i].double() @ d.T
        out.append(float(s.max(1).values[qm[i]].sum()))
    return torch.tensor(out, dtype=torch.float64)


def test_maxsim_against_brute_force():
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(7, 5, 16, generator=g), dim=-1)
    qm = torch.rand(7, 5, generator=g) < 0.7
    qm[:, 0] = True
    docs = torch.randn(7, 9, 16, generator=g)
    counts = torch.randint(1, 10, (7,), generator=g)
    got = R.maxsim(q, qm, docs, counts)
    torch.testing.assert_close(got.double(), brute_maxsim(q, qm, docs, counts),
                               rtol=1e-6, atol=1e-5)


def test_pair_scores_read_the_docs_the_corpus_made(tiny_cell):
    cell = tiny_cell()
    c = Corpus(cell.cfg, 7, "cpu", 64)
    ref = R.Reference(c, cell.cfg).build(fill_pool=True)
    q, qm = c.queries(0, cell.traffic, torch.Generator())
    rows = torch.tensor([0, 1, 2, 3, 3])
    docs = torch.tensor([5, 1500, 2999, 0, 1001])
    toks = [c.chunk(int(d) // 1000)[0][int(d) % 1000] for d in docs]
    want = brute_maxsim(q[rows], qm[rows], torch.stack(toks), c.counts[docs])
    torch.testing.assert_close(ref.pair_scores(q, qm, rows, docs).double(), want,
                               rtol=1e-6, atol=1e-5)


def test_first_stage_probing_every_list_is_the_exact_scan(tiny_cell):
    """With nprobe = nlist the IVF scans every row: its top-k' is the exact
    top-k' of the latent product over the SQ8 rows, tombstones masked."""
    cell = tiny_cell()
    c = Corpus(cell.cfg, 3, "cpu", 64)
    ref = R.Reference(c, cell.cfg).build(fill_pool=True)
    q, qm = c.queries(1, cell.traffic, torch.Generator())
    nlist = ref.ivf.centroids.shape[0]
    cand, probes = ref.search_first_stage(q, qm, nlist, 40)
    assert probes.shape == (q.shape[0], nlist)
    pq = R.psi_pool(q, qm, c.psi).double()
    full = (ref.ivf.rows.double() @ pq.T).T * ref.ivf.scales.double()
    want = torch.topk(full, 40).indices
    want = torch.where(c.alive[want], want, -1)
    for b in range(q.shape[0]):
        assert set(cand[b].tolist()) == set(want[b].tolist())


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265])
    got = R.round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                               # a tie: to even
    assert got[3] == 1.0 + 2 * 2 ** -10                # a tie: to even
    assert abs(float(got[4]) + 3.14159265) < 2 ** -9 * 4
    bits = got.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())


def test_codec_roundtrip_decodes_to_centroid_plus_bucket_values():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(600, 8, generator=g)
    codec = R.train_codec(torch.Generator().manual_seed(2), x, 4, 16, 4, 512)
    dec = R.codec_roundtrip(codec, x)
    c = torch.argmax(x @ codec.centroids.T - 0.5 * codec.centroids.square().sum(1), -1)
    idx = ((x - codec.centroids[c])[..., None] > codec.cuts).sum(-1)
    assert torch.equal(dec, codec.centroids[c] + codec.values[torch.arange(8), idx])
    assert float((dec - x).abs().mean()) < float(x.abs().mean()) / 4
