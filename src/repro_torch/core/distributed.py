"""The distributed LEMUR serving and indexing steps under their v0 import
path (twin of ``repro/core/distributed.py``): they live in
:mod:`repro_torch.dist.serve`.  New code uses
:meth:`repro_torch.retriever.LemurRetriever.shard` or ``repro_torch.dist``."""
from repro_torch.dist.serve import (  # noqa: F401
    ShardedRetrievalState,
    corpus_axes,
    default_k_prime_local,
    make_index_step,
    make_serve_step,
    n_corpus_shards,
    state_shardings,
)

__all__ = [
    "ShardedRetrievalState",
    "corpus_axes",
    "default_k_prime_local",
    "make_index_step",
    "make_serve_step",
    "n_corpus_shards",
    "state_shardings",
]
