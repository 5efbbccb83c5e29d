"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16 experts top-2 on every other layer; Mamba+attention 1:7
interleave (period-8 blocks: 1 attention + 7 mamba). ~398B total params.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import (AttnConfig, MambaConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=("attn",) + ("mamba",) * 7,
    mlp="gated_silu",
    attn=AttnConfig(pattern=("full",), rope_theta=1e4),
    moe=MoEConfig(n_experts=16, top_k=2, period=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    norm="rmsnorm",
    max_seq_len=262144,
).validate()
