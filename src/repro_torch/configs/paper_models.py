"""The paper's own evaluation models (Atleus SS V.A): GPT-2 (Medium) and
BLOOM-560m shaped decoder configs, used by the paper-figure benchmarks
(compute breakdown, quantization perplexity, pipeline stage delays).
RoBERTa-Base / BERT-Large are encoder models; their kernel mix (Table II)
is identical, so the perfmodel evaluates them analytically by dims."""
from repro_torch.configs.base import AttnConfig, ModelConfig

GPT2_MEDIUM = ModelConfig(
    name="paper-gpt2-medium",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=50257,
    block_pattern=("attn",),
    mlp="gelu",
    attn=AttnConfig(pattern=("full",)),
    norm="layernorm",
    tie_embeddings=True,
    max_seq_len=1024,
).validate()

BLOOM_560M = ModelConfig(
    name="paper-bloom-560m",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=250880,
    block_pattern=("attn",),
    mlp="gelu",
    attn=AttnConfig(pattern=("full",)),
    norm="layernorm",
    tie_embeddings=True,
    max_seq_len=2048,
).validate()

# Analytic-only dims for the encoder models (perfmodel paper figures).
PAPER_DIMS = {
    "roberta-base": dict(n_layers=12, d_model=768, n_max=512),
    "bert-large": dict(n_layers=24, d_model=1024, n_max=512),
    "gpt2-medium": dict(n_layers=24, d_model=1024, n_max=1024),
    "bloom-560m": dict(n_layers=24, d_model=1024, n_max=2048),
}
