"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local(sliding-4096)+global alternating attention, attention
logit softcap 50.0, final logit softcap 30.0, gelu-gated MLP, head_dim 256,
embedding scaling. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=("attn",),
    mlp="gated_gelu",
    attn=AttnConfig(pattern=("sliding", "full"), window=4096,
                    logit_softcap=50.0, rope_theta=1e4),
    final_logit_softcap=30.0,
    norm="rmsnorm",
    tie_embeddings=True,
    emb_scale=True,
    max_seq_len=8192,
).validate()
