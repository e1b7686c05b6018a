"""bst [arXiv:1905.06874] Behavior Sequence Transformer (Alibaba): embed 32,
seq 20 history + target, 1 transformer block (8 heads), MLP 1024-512-256.

Twin of ``repro/configs/bst.py``, value for value.
"""
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="bst",
    model="bst",
    vocab_sizes=(),
    embed_dim=32,
    seq_len=20,
    n_heads=8,
    n_blocks=1,
    n_items=2_000_000,
    mlp_dims=(1024, 512, 256),
)

FAMILY = "recsys"
SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", n_candidates=1_000_000),
}
SMOKE = CONFIG.replace(n_items=1000, embed_dim=16, seq_len=8, n_heads=4,
                       mlp_dims=(64, 32))
