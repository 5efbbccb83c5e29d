"""rwkv6-7b (Finch) [ssm] — 32L d_model=4096 attention-free, d_ff=14336
vocab=65536; data-dependent decay time-mix + channel-mix.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # wkv heads = d_model / rwkv.head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    mlp="gelu",           # unused by rwkv blocks (channel-mix is built in)
    attn=AttnConfig(pattern=("full",)),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=128),
    norm="layernorm",
    max_seq_len=1048576,
).validate()
