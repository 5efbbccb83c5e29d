"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24, i.e. MHA)
d_ff=6144 vocab=2048; decoder-only over EnCodec tokens. The EnCodec
frontend is a STUB per the brief: ``input_specs()`` provides precomputed
frame embeddings. Plain (non-gated) GELU MLP, LayerNorm.
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    mlp="gelu",
    attn=AttnConfig(pattern=("full",), rope_theta=1e4),
    norm="layernorm",
    frontend="embeddings",
    max_seq_len=16384,
).validate()
