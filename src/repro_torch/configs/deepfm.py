"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed 10, FM + deep 400³.

Criteo-scale per-field vocabularies (5 huge head fields + long tail),
~16.3M total rows — the table is the hot sharded object.

Twin of ``repro/configs/deepfm.py``, value for value.
"""
from repro_torch.models.recsys import RecsysConfig

VOCABS = (
    (10_000_000, 4_000_000, 1_000_000, 500_000, 250_000)
    + (100_000,) * 4
    + (10_000,) * 10
    + (1_000,) * 10
    + (100,) * 9
    + (1_244,)  # pad field: total 16 262 144 = 31 762 × 512 (shardable anywhere)
)
assert len(VOCABS) == 39
assert sum(VOCABS) % 512 == 0

CONFIG = RecsysConfig(
    name="deepfm",
    model="deepfm",
    vocab_sizes=VOCABS,
    embed_dim=10,
    mlp_dims=(400, 400, 400),
)

FAMILY = "recsys"
SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", n_candidates=1_000_000),
}
SMOKE = CONFIG.replace(vocab_sizes=(100,) * 8, embed_dim=8, mlp_dims=(32, 32))
