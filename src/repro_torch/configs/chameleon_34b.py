"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536; early-fusion over VQ image tokens (frontend STUB:
``input_specs()`` provides precomputed patch embeddings), qk-norm.
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    block_pattern=("attn",),
    mlp="gated_silu",
    attn=AttnConfig(pattern=("full",), rope_theta=1e4, qk_norm=True),
    norm="rmsnorm",
    frontend="embeddings",
    max_seq_len=4096,
).validate()
