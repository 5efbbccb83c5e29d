"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    block_pattern=("attn",),
    mlp="gated_silu",
    attn=AttnConfig(pattern=("sliding",), window=4096, rope_theta=1e6),
    moe=MoEConfig(n_experts=8, top_k=2, period=1),
    norm="rmsnorm",
    max_seq_len=65536,
).validate()
