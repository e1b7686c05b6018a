"""Uneven IVF lists over a trained W, in the JAX package as in the port.

On a weakly clustered corpus (the topic model of ``data/synthetic`` at topic
weight 1.2 over 4,096 centres, d = 128: a token's cosine to its topic centre
is about 0.1) the OLS rows W form a cloud without cluster structure, and
Lloyd's k-means under the ``argmax(x.c - ||c||^2 / 2)`` rule comes out
lopsided: a cluster that gathers many rows gets a centroid near the centred
origin and gathers more, while a cluster seeded on a long row keeps little
beyond its seed.  The test holds that the JAX package's ``build_ivf`` does
the same on the port's W, so the skew is the algorithm's and not the port's,
and that the port's assignment equals JAX's given JAX's centroids.

The test runs at a small size.  At a larger one,

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ivf_skew.py --m 20000

builds the port and the JAX package on one such corpus (each its own
training; d' = 2048 and k' = m / 195, the paper's k' at 200k docs; fewer
training tokens and epochs than the paper so that it runs on a CPU) and
prints each build's list sizes and the recall of the exact top-10 by the
latent scan (top-k' of q.W over all docs) and by the IVF first stage
(top-k' of q.W over the docs of the nprobe probed lists).
"""
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.anns import ivf as jax_ivf

from repro_torch.anns import ivf
from repro_torch.core import maxsim
from repro_torch.core.config import LemurConfig
from repro_torch.core.model import pool_queries
from repro_torch.data.synthetic import make_corpus, queries_from_corpus_query
from repro_torch.retriever import LemurRetriever


def corpus(m, seed=0):
    """The serving corpus's distribution: d = 128, Poisson(67) lengths
    clipped to [4, 80], topic weight 1.2 over 4,096 centres."""
    return make_corpus(m=m, d=128, avg_tokens=67, max_tokens=80, n_centers=4096,
                       topic_strength=1.2, seed=seed)


def profile(counts) -> dict:
    c = np.sort(np.asarray(counts))
    return {"nlist": len(c), "mean": float(c.mean()), "median": float(np.median(c)),
            "max": int(c[-1]), "lists_le_3": float((c <= 3).mean())}


def first_stage_recall(pq, W, centroids, ids, nprobe, k_prime, truth):
    """Recall of ``truth`` by the top-k' of q.W over all docs (latent) and
    over the docs of the nprobe lists whose centroids score highest (IVF,
    fp32 rows: the lists' SQ8 codes are left out)."""
    lat = torch.topk(pq @ W.T, k_prime, dim=1).indices
    probe = torch.topk(pq @ centroids.T, nprobe, dim=1).indices
    cand = []
    for b in range(pq.shape[0]):
        c = ids[probe[b]].flatten()
        c = c[c >= 0].long()
        top = torch.topk(pq[b] @ W[c].T, min(k_prime, len(c))).indices
        cand.append(torch.nn.functional.pad(c[top], (0, k_prime - len(top)), value=-1))
    return (float(maxsim.recall_at(lat, truth).mean()),
            float(maxsim.recall_at(torch.stack(cand), truth).mean()))


def jax_lists(W, seed):
    j = jax_ivf.build_ivf(jax.random.PRNGKey(seed), jnp.asarray(W.numpy()), sq8=True)
    return j, torch.as_tensor(np.array(j.centroids)), torch.as_tensor(np.array(j.ids))


def _small_build():
    c = corpus(3000)
    cfg = LemurConfig(d_prime=2048, m_pretrain=512, n_train=4096, n_ols=1024,
                      epochs=3, k_prime=16)
    r = LemurRetriever.build(c, cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return r.index.store.W[:c.m].contiguous()


def test_jax_build_ivf_is_as_uneven_on_the_port_w():
    W = _small_build()
    j, jcent, jids = jax_lists(W, 0)
    port = ivf.build_ivf(W, sq8=True, generator=torch.Generator().manual_seed(0))
    # given JAX's centroids, the port assigns and packs every row as JAX does
    same = ivf.build_ivf(W, sq8=True, centroids=jcent)
    torch.testing.assert_close(same.mean, torch.as_tensor(np.asarray(j.mean)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(same.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(same.ids.numpy(), np.asarray(j.ids))
    # from their own draws, both are lopsided in the same way: most lists
    # hold far fewer rows than the mean, a few far more
    pj, pt = profile(np.asarray(j.counts)), profile(port.counts.numpy())
    for p in (pj, pt):
        assert p["median"] <= p["mean"] / 3 and p["max"] >= 5 * p["mean"], p
    assert abs(pj["lists_le_3"] - pt["lists_le_3"]) <= 0.15, (pj, pt)


def main():
    from repro.core.config import LemurConfig as JaxConfig
    from repro.core.model import pool_queries as jax_pool_queries
    from repro.data.synthetic import MultiVectorCorpus as JaxCorpus
    from repro.retriever import LemurRetriever as JaxRetriever

    ap = argparse.ArgumentParser(description="IVF list skew, port and JAX builds")
    ap.add_argument("--m", type=int, default=20000)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--queries", type=int, default=128)
    args = ap.parse_args()
    torch.set_num_threads(8)
    c = corpus(args.m)
    k_prime = max(16, round(1024 * args.m / 200_000))
    kw = dict(d_prime=2048, m_pretrain=2048, n_train=20000, n_ols=8192,
              epochs=args.epochs, k_prime=k_prime)
    nprobe = LemurConfig().ivf.nprobe
    q = torch.as_tensor(queries_from_corpus_query(c, args.queries, q_tokens=32, seed=7))
    qm = torch.ones(q.shape[:2], dtype=torch.bool)
    _, truth = maxsim.true_topk(q, qm, torch.as_tensor(c.doc_tokens),
                                torch.as_tensor(c.doc_mask), 10, block=256)
    print(f"m {args.m}, d' 2048, k' {k_prime}, nprobe {nprobe}, epochs {args.epochs}, "
          f"{args.queries} queries of 32 tokens", flush=True)

    t = time.time()
    r = LemurRetriever.build(c, LemurConfig(**kw), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    W = r.index.store.W[:c.m].contiguous()
    pq = pool_queries(r.index.psi, q, qm)
    ann = r.index.ann
    rec = first_stage_recall(pq, W, ann.centroids, ann.ids, nprobe, k_prime, truth)
    print(f"port build ({time.time() - t:.0f} s): lists {profile(ann.counts.numpy())}, "
          f"latent recall {rec[0]:.4f}, IVF recall {rec[1]:.4f}", flush=True)
    for seed in (0, 1):
        _, jcent, jids = jax_lists(W, seed)
        rec = first_stage_recall(pq, W, jcent, jids, nprobe, k_prime, truth)
        print(f"JAX build_ivf on the port's W, key {seed}: lists "
              f"{profile(jids.ge(0).sum(1).numpy())}, IVF recall {rec[1]:.4f}", flush=True)

    t = time.time()
    jr = JaxRetriever.build(JaxCorpus(c.doc_tokens, c.doc_mask, c.topics, c.centers),
                            JaxConfig(**kw), key=jax.random.PRNGKey(0))
    jW = torch.as_tensor(np.asarray(jr.index.store.W))[:c.m].contiguous()
    jpq = torch.as_tensor(np.asarray(jax_pool_queries(
        jr.index.psi, jnp.asarray(q.numpy()), jnp.asarray(qm.numpy()))))
    ja = jr.index.ann
    rec = first_stage_recall(jpq, jW, torch.as_tensor(np.asarray(ja.centroids)),
                             torch.as_tensor(np.asarray(ja.ids)), nprobe, k_prime, truth)
    print(f"JAX build ({time.time() - t:.0f} s): lists {profile(np.asarray(ja.counts))}, "
          f"latent recall {rec[0]:.4f}, IVF recall {rec[1]:.4f}", flush=True)


if __name__ == "__main__":
    main()
