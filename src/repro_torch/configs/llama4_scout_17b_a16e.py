"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + always-on shared expert, early-fusion
multimodal (frontend stubbed per brief).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn",),
    mlp="gated_silu",
    attn=AttnConfig(pattern=("full",), rope_theta=5e5, qk_norm=True),
    moe=MoEConfig(n_experts=16, top_k=1, period=1, shared_expert=True,
                  router_norm_topk=False),
    norm="rmsnorm",
    max_seq_len=131072,
).validate()
