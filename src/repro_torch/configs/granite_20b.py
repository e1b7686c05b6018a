"""granite-20b [arXiv:2405.04324]: MQA (kv=1), non-gated GELU FFN, LayerNorm
(GPT-BigCode lineage code model).

Twin of ``repro/configs/granite_20b.py``, value for value.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    activation="gelu",
    gated=False,
    mlp_bias=True,
    qkv_bias=True,
    norm="ln",
    rope_base=10000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    q_block=2048,
    kv_block=2048,
    loss_chunk=512,
    remat="full",
)

FAMILY = "lm"
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}
SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab=512, param_dtype="float32", compute_dtype="float32",
    q_block=16, kv_block=16, loss_chunk=16,
)
