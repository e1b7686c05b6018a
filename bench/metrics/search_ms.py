"""Device time of a whole search a batch: CUDA events around
``LemurRetriever.search``, mean over every batch of the traced window.
Beside first_stage_ms + rerank_ms it shows what the two spans leave out (the
facade's work after the rerank): a search that no longer composes as the
two spans assume is a cue to re-point them.  Layer: search step; moves qps."""


def read(ctx):
    spans = ctx["spans"]
    if not spans:
        return None
    v = spans["search_ms"]
    return sum(v) / len(v)
