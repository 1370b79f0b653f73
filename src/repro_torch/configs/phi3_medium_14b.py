"""phi3-medium-14b [dense]: 40L d=5120 40H (GQA kv=10) d_ff=17920
vocab=100352. RoPE + SwiGLU + GQA. [arXiv:2404.14219; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    scan_period=1,
)

SMOKE = ModelConfig(
    name="phi3-medium-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    scan_period=1,
)
