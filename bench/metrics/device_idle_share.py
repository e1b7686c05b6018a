"""The device's idle share inside the searches of a profiled second of the
same closed loop, in %: one less the union of the device's operations'
intervals within each search (submit to synchronize) over the searches'
length (``tracing.profile_loop``).  The benchmark's own query draw, between
searches, is left out.  The profiler slows the host, so this reads above
the untraced loop's.  Layer: device; moves qps."""


def read(ctx):
    p = ctx["profile"]
    if not p or not p["search_busy_s"]:
        return None
    return 100.0 * (1.0 - p["search_busy_s"] / p["search_s"])
