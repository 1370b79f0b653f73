"""starcoder2-7b [dense]: 32L d=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
GELU 2-matrix MLP, RoPE. [arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    scan_period=1,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    mlp_type="gelu",
    scan_period=1,
)
