"""xdeepfm [arXiv:1803.05170]: CIN 200-200-200 + deep 400-400 over the same
Criteo-scale 39-field table as deepfm.

Twin of ``repro/configs/xdeepfm.py``, value for value.
"""
from repro_torch.configs.deepfm import VOCABS
from repro_torch.models.recsys import RecsysConfig

CONFIG = RecsysConfig(
    name="xdeepfm",
    model="xdeepfm",
    vocab_sizes=VOCABS,
    embed_dim=10,
    mlp_dims=(400, 400),
    cin_dims=(200, 200, 200),
)

FAMILY = "recsys"
SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", n_candidates=1_000_000),
}
SMOKE = CONFIG.replace(vocab_sizes=(100,) * 8, embed_dim=8, mlp_dims=(32, 32),
                       cin_dims=(16, 16))
