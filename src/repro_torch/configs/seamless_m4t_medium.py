"""seamless-m4t-medium [audio]: enc-dec 12L+12L d=1024 16H (MHA kv=16)
d_ff=4096 vocab=256206. Audio frontend STUBBED: input_specs provides
precomputed frame embeddings. ReLU MLP, tied embeddings.
[arXiv:2308.11596; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_type="relu",
    modality="audio_frames",
    tie_embeddings=True,
    scan_period=1,
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="relu",
    modality="audio_frames",
    tie_embeddings=True,
    scan_period=1,
)
