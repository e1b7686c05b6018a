"""two-tower-retrieval [Yi et al., RecSys'19]: 256-d towers (1024-512-256),
dot-product interaction, in-batch sampled softmax with logQ correction.
``retrieval_cand`` scores 1 query against 1M candidates via the mesh-sharded
MIPS path (the same machinery LEMUR's latent stage uses).

Twin of ``repro/configs/two_tower.py``, value for value.
"""
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    model="two_tower",
    vocab_sizes=(1_000_000, 500_000, 100_000, 100_000, 10_000, 10_000, 1_000, 1_000),
    embed_dim=256,
    tower_dims=(1024, 512, 256),
    out_dim=256,
    n_items=10_000_000,
)

FAMILY = "recsys"
SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", n_candidates=1_000_000),
}
SMOKE = CONFIG.replace(vocab_sizes=(100,) * 4, embed_dim=16, tower_dims=(32, 16),
                       out_dim=16, n_items=1000)
