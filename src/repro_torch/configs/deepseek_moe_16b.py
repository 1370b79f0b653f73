"""deepseek-moe-16b [moe]: 28L d=2048 16H (MHA kv=16) vocab=102400,
2 shared + 64 routed top-6 fine-grained experts (d_ff=1408).
[arXiv:2401.06066; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    moe_d_ff=1408,
    moe_every=1,
    scan_period=1,
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    moe_num_experts=8,
    moe_top_k=3,
    moe_num_shared=2,
    moe_d_ff=96,
    moe_capacity_factor=8.0,
    moe_every=1,
    scan_period=1,
)
