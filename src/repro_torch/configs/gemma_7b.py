"""gemma-7b [arXiv:2403.08295]: GeGLU, head_dim=256, MHA (kv=16), tied+scaled
embeddings.

Twin of ``repro/configs/gemma_7b.py``, value for value.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="gelu",
    gated=True,
    norm="rms",
    rope_base=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    q_block=2048,
    kv_block=2048,
    loss_chunk=256,
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
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=128,
    vocab=512, param_dtype="float32", compute_dtype="float32",
    q_block=16, kv_block=16, loss_chunk=16,
)
