"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, 128 routed experts top-1 + 1 shared, MoE every other layer
(matches 400B total / 17B active). [hf:meta-llama/Llama-4-*; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe_num_experts=128,
    moe_top_k=1,
    moe_num_shared=1,
    moe_d_ff=8192,
    moe_every=2,
    rope_theta=500000.0,
    scan_period=2,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    moe_num_experts=8,
    moe_top_k=1,
    moe_num_shared=1,
    moe_d_ff=128,
    moe_capacity_factor=8.0,
    moe_every=2,
    scan_period=2,
)
