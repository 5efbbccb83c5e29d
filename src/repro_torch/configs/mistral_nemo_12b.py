"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    block_pattern=("attn",),
    mlp="gated_silu",
    attn=AttnConfig(pattern=("full",), rope_theta=1e6),
    norm="rmsnorm",
    max_seq_len=131072,
).validate()
