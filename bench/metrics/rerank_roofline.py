"""The rerank's share of its roofline, in %: on the sampled batches, the
least time their reranks could take on the card (``counts.rerank`` at the
data-sheet peaks) over the time they took (rerank_ms's spans of the same
batches).  Layer: rerank; moves qps."""


def read(ctx):
    spans, sample = ctx["spans"], ctx["sample"]
    if not spans or not sample:
        return None
    bound = sum(ctx["peaks"].bound_s(*b["rerank"]) for b in sample)
    took = sum(spans["rerank_ms"][b["batch"]] for b in sample) / 1e3
    return 100.0 * bound / took
