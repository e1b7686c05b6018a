"""qwen2.5-32b [hf:Qwen/Qwen2.5-32B]: dense, GQA kv=8, QKV bias, untied.

Twin of ``repro/configs/qwen2_5_32b.py``, value for value.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    activation="silu",
    gated=True,
    qkv_bias=True,
    norm="rms",
    rope_base=1_000_000.0,
    tie_embeddings=False,
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
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, param_dtype="float32", compute_dtype="float32",
    q_block=16, kv_block=16, loss_chunk=16,
)
