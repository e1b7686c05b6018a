"""The first stage's share of its roofline, in %: on the sampled batches,
the least time their first stages could take on the card (``counts.
first_stage`` at the data-sheet peaks, ``peaks.bound_s``) over the time
they took (first_stage_ms's spans of the same batches).  Layer: first stage;
moves qps."""


def read(ctx):
    spans, sample = ctx["spans"], ctx["sample"]
    if not spans or not sample:
        return None
    bound = sum(ctx["peaks"].bound_s(*b["first_stage"]) for b in sample)
    took = sum(spans["first_stage_ms"][b["batch"]] for b in sample) / 1e3
    return 100.0 * bound / took
