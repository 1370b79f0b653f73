"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4, head_dim 256) d_ff=9216
vocab=256000. Alternating local(4096)/global attention, attn softcap 50,
final logit softcap 30, tied embeddings. [arXiv:2408.00118; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    window_size=4096,
    alt_local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    scan_period=2,
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    window_size=16,
    alt_local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    scan_period=2,
)
