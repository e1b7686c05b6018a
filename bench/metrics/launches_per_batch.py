"""Device operations (kernels and memsets; copies not counted) that start
inside a search, a search, over the profiled second of the same loop: the
host's dispatch work a batch.  Layer: host dispatch; moves qps."""


def read(ctx):
    p = ctx["profile"]
    if not p or not p["search_busy_s"]:
        return None
    return p["launches"] / p["batches"]
