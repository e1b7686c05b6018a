"""deepseek-v3-671b [arXiv:2412.19437]: MLA (q_lora 1536, kv_lora 512+64 rope),
MoE 1 shared + 256 routed top-8 (d_ff 2048), 3 dense prefix layers (d_ff
18432).  MTP head omitted (training objective, not serving topology — DESIGN
§6).  Expert-parallel "ep" layout; 8-bit Adam for the train cell.

Twin of ``repro/configs/deepseek_v3_671b.py``, value for value.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,
    vocab=129280,
    activation="silu",
    gated=True,
    norm="rms",
    rope_base=10000.0,
    attn="mla",
    q_lora=1536,
    kv_lora=512,
    qk_nope=128,
    qk_rope=64,
    v_head=128,
    moe_n_experts=256,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_shared=1,
    moe_period=1,
    prefix_dense_layers=3,
    moe_layout="ep",
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
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16,
    moe_n_experts=4, moe_top_k=2, moe_d_ff=32, prefix_dense_layers=1,
    param_dtype="float32", compute_dtype="float32",
    q_block=16, kv_block=16, loss_chunk=16,
)
