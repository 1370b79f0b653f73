"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (MHA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend STUBBED (input_specs
provides patch embeddings prepended to text).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    modality="vision_patches",
    num_prefix_embeds=256,
    scan_period=1,
)

SMOKE = ModelConfig(
    name="phi3-vision-smoke",
    family="vlm",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    modality="vision_patches",
    num_prefix_embeds=8,
    scan_period=1,
)
