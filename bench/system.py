"""The system under test: the port's ``LemurRetriever`` built from a run's
inputs, the way a deployment loads a corpus too large for its dense layout.

The docs are paged a chunk at a time (``pages.allocate`` + ``pages.write_docs``,
encoded by the program's codec on the compressed tier, never as an fp32
pool), then ``LemurRetriever.from_arrays`` builds the IVF over the W rows
(k-means, lists, SQ8 or residual codes) and ``delete`` tombstones 0.1 % of
the docs.  Everything the program derives it derives itself; the benchmark
hands it only the corpus' tokens, W, psi's weights and the deletions.
"""
from __future__ import annotations

import time

import torch

from bench.corpus import mix
from bench.reference import next_pow2


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resident_bytes(cfg: dict, n_pages: int) -> int:
    """What set-up must hold at once besides the IVF lists: the W slots, the
    page pools and the IVF build's centred copy of the W rows."""
    m, d, dp = int(cfg["m"]), int(cfg["d"]), int(cfg["d_prime"])
    res = cfg["residual"]
    tok = (4 + d * int(res["bits"]) // 8) if res["enabled"] else 4 * d
    return next_pow2(m) * dp * 4 + next_pow2(n_pages) * 16 * tok + m * dp * 4


def build(corpus, cfg: dict, search: dict):
    """-> (retriever, SearchParams, notes).  ``search`` pins k, k', nprobe
    and the backend; the route flags are left to the program's defaults."""
    from repro_torch.anns.params import IVFBackendConfig, IVFSearchParams, ResidualConfig
    from repro_torch.anns.quantization import train_residual_codec
    from repro_torch.core import pages
    from repro_torch.core.config import LemurConfig
    from repro_torch.core.model import Psi
    from repro_torch.retriever import LemurRetriever, SearchParams

    if search["backend"] != "ivf":
        raise ValueError(f"backend {search['backend']!r}: this configuration serves ivf")
    dev = corpus.dev
    ivf, res = cfg["ivf"], cfg["residual"]
    ppd = (corpus.counts + 15) // 16
    n_pages, pmax = int(ppd.sum()), int(ppd.max())
    notes = {"pages": n_pages}
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        need = resident_bytes(cfg, n_pages)
        notes.update(mem_free_before=free, mem_needed_before_lists=need)
        if need > free:
            raise RuntimeError(f"set-up needs {need} bytes before the IVF lists, "
                               f"{free} free of {total}: the configuration does not fit")
    t0 = time.perf_counter()
    psi = Psi.from_arrays(*corpus.psi, device=dev)
    tok, mask, W = corpus.chunk(0)
    codec = None
    if res["enabled"]:
        sample = corpus.codec_sample(tok, mask, int(res["train_sample"]))
        codec = train_residual_codec(torch.Generator().manual_seed(mix(corpus.seed, "codec")),
                                     sample, bits=int(res["bits"]), ncent=int(res["ncent"]),
                                     iters=int(res["kmeans_iters"]),
                                     sample=int(res["train_sample"]))
        del sample
    store = pages.allocate(corpus.m, n_pages, pmax, corpus.d, corpus.dp, device=dev,
                           codec=codec)
    page = 0
    for c in range(corpus.n_chunks):
        if c:
            tok, mask, W = corpus.chunk(c)
        corpus.fill_pool(c, tok)
        page += pages.write_docs(store, c * corpus.chunk_docs, page, W, tok, mask)
        del tok, mask, W
    sync(dev)
    t1 = time.perf_counter()
    lcfg = LemurConfig(
        d=corpus.d, d_prime=corpus.dp, k=int(search["k"]), k_prime=int(search["k_prime"]),
        anns="ivf",
        ivf=IVFBackendConfig(nlist=int(ivf["nlist"]), nprobe=int(search["nprobe"]),
                             sq8=bool(ivf["sq8"]), residual_bits=int(ivf["residual_bits"])),
        residual=ResidualConfig(enabled=bool(res["enabled"]), bits=int(res["bits"]),
                                ncent=int(res["ncent"]), kmeans_iters=int(res["kmeans_iters"]),
                                train_sample=int(res["train_sample"])))
    r = LemurRetriever.from_arrays(lcfg, psi, store,
                                   generator=torch.Generator().manual_seed(mix(corpus.seed, "ivf")))
    sync(dev)
    t2 = time.perf_counter()
    r.delete(corpus.dead.cpu().numpy())
    sync(dev)
    notes.update(pages_s=t1 - t0, ivf_s=t2 - t1, delete_s=time.perf_counter() - t2)
    params = SearchParams(k=int(search["k"]), k_prime=int(search["k_prime"]),
                          backend=IVFSearchParams(nprobe=int(search["nprobe"])))
    notes.update(nlist=r.index.ann.nlist, list_capacity=r.index.ann.capacity)
    return r, params, notes
