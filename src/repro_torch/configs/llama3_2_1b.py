"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    block_pattern=("attn",),
    mlp="gated_silu",
    attn=AttnConfig(pattern=("full",), rope_theta=5e5),
    norm="rmsnorm",
    tie_embeddings=True,
    max_seq_len=131072,
).validate()
