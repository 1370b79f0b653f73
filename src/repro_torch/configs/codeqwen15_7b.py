"""codeqwen1.5-7b [dense]: 32L d=4096 32H (MHA kv=32) d_ff=13440
vocab=92416, qkv bias (qwen1.5 arch). [hf:Qwen/CodeQwen1.5-7B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1000000.0,
    scan_period=1,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    scan_period=1,
)
