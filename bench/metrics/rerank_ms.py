"""Device time of the rerank a batch: CUDA events around the rerank entry
``search_pipeline`` calls (``ops.fused_rerank_paged`` or
``fused_rerank_paged_res``: exact MaxSim of the candidates and the top-k),
mean over every batch of the traced window.  Layer: rerank; moves qps."""


def read(ctx):
    spans = ctx["spans"]
    if not spans:
        return None
    v = spans["rerank_ms"]
    return sum(v) / len(v)
