"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536. Mamba:attention 7:1 interleave, MoE (16e top-2) every other
layer. [arXiv:2403.19887; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    attn_every=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    scan_period=8,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    moe_num_experts=4,
    moe_top_k=2,
    moe_d_ff=128,
    moe_capacity_factor=8.0,
    moe_every=2,
    attn_every=8,
    mamba_d_state=8,
    mamba_d_conv=4,
    mamba_expand=2,
    scan_period=8,
)
