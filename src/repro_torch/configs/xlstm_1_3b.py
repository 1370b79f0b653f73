"""xlstm-1.3b [ssm]: 48 blocks d=2048 4H, alternating mLSTM/sLSTM,
no separate MLP (d_ff=0), vocab=50304. [arXiv:2405.04517; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    xlstm=True,
    scan_period=2,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    xlstm=True,
    scan_period=2,
)
