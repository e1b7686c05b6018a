"""Device time of the first stage a batch: CUDA events from the start of
``LemurRetriever.search`` to the call of its rerank entry (psi-pool, probe
selection, scan, top-k', tombstone mask), mean over every batch of the
traced window.  Layer: first stage; moves qps."""


def read(ctx):
    spans = ctx["spans"]
    if not spans:
        return None
    v = spans["first_stage_ms"]
    return sum(v) / len(v)
