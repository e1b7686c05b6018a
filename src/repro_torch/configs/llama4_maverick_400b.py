"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*]: MoE 128e top-1 + 1
shared expert on alternating layers; chunked attention (8192) with full
attention every 4th layer (iRoPE); ffslice expert layout (128 experts do not
divide the 256/512-chip mesh — see nn.moe).

Twin of ``repro/configs/llama4_maverick_400b.py``, value for value.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    activation="silu",
    gated=True,
    norm="rms",
    rope_base=500000.0,
    moe_n_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    moe_shared=1,
    moe_period=2,
    moe_layout="ffslice",
    chunk_attn=8192,
    full_attn_every=4,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    q_block=2048,
    kv_block=2048,
    loss_chunk=512,
    remat="full",
)

FAMILY = "lm"
USE_ADAM8 = True
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq=524288, global_batch=1),
}
SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, moe_n_experts=4, moe_d_ff=64, chunk_attn=16,
    param_dtype="float32", compute_dtype="float32",
    q_block=16, kv_block=16, loss_chunk=16,
)
