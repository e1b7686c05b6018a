"""Multi-device layer of the port: the LEMUR corpus-sharded serving and
indexing steps on ``torch.distributed`` (:mod:`repro_torch.dist.serve`;
the user-facing wrapper is :meth:`repro_torch.retriever.LemurRetriever.shard`)
and the sharding rule tables with the block helpers of the models' mesh
forms (:mod:`repro_torch.dist.sharding`)."""
from repro_torch.dist.serve import (
    ShardedRetrievalState,
    corpus_axes,
    default_k_prime_local,
    local_rows,
    make_index_step,
    make_serve_step,
    merge,
    n_corpus_shards,
    shard_index,
    state_shardings,
)

__all__ = [
    "ShardedRetrievalState",
    "corpus_axes",
    "default_k_prime_local",
    "local_rows",
    "make_index_step",
    "make_serve_step",
    "merge",
    "n_corpus_shards",
    "shard_index",
    "state_shardings",
]
