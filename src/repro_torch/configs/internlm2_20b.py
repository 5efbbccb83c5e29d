"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=("attn",),
    mlp="gated_silu",
    attn=AttnConfig(pattern=("full",), rope_theta=1e6),
    norm="rmsnorm",
    max_seq_len=32768,
).validate()
