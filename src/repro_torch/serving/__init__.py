"""Online serving runtime of the port (twin of ``repro/serving``):
shape-bucketed dynamic micro-batching and streaming mutation over the
Retriever API (single-device and sharded facades), on the retriever's
device.

* :mod:`repro_torch.serving.buckets` — :class:`BucketLadder`: the Tq-ladder /
  power-of-two-batch shape policy that keeps the served shapes bounded.
* :mod:`repro_torch.serving.server` — :class:`RetrieverServer`: thread-safe
  request queue, micro-batcher (``max_batch`` / ``max_wait_us``), streaming
  ``add()``/``delete()``/``update()``/``apply()`` as FIFO barriers between
  micro-batches, and :class:`ServerStats` (latency percentiles, QPS,
  occupancy histograms).
* :mod:`repro_torch.serving.replay` — seeded Poisson arrival traces + the
  open-loop replay/warmup loop.
"""
from repro_torch.serving.buckets import DEFAULT_TQ_LADDER, BucketLadder, pad_single
from repro_torch.serving.replay import (
    poisson_trace,
    ragged_queries,
    replay,
    warm_buckets,
)
from repro_torch.serving.server import (
    DeadlineExceeded,
    Overloaded,
    RetrieverServer,
    ServerStats,
)

__all__ = [
    "BucketLadder",
    "DEFAULT_TQ_LADDER",
    "DeadlineExceeded",
    "Overloaded",
    "RetrieverServer",
    "ServerStats",
    "pad_single",
    "poisson_trace",
    "ragged_queries",
    "replay",
    "warm_buckets",
]
