"""Model/config system of the PyTorch port: a copy of ``repro.configs.base``.

Every assigned architecture is a frozen ``ModelConfig``. A config fully
determines parameter shapes, the per-layer block pattern (attention / mamba /
rwkv), the FF type per layer (dense / MoE), and the attention flavour per
attention layer (full / sliding / alternating).

The port keeps its own copy so that it imports nothing of the JAX package;
the two must stay field-for-field identical (the parity tests build a config
on each side from the same arguments). The same config drives parameter
init (``repro_torch.models.transformer.init_params``) and the prefill /
decode / serving step.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttnConfig:
    """Attention behaviour. ``pattern`` cycles across *attention* layers:
    e.g. ("sliding",) = every attn layer sliding-window; ("sliding", "full")
    = gemma2-style local/global alternation."""

    pattern: Tuple[str, ...] = ("full",)
    window: Optional[int] = None          # sliding-window size (tokens)
    logit_softcap: Optional[float] = None  # gemma2 attn softcap (50.0)
    qk_norm: bool = False                 # chameleon-style query/key norm
    rope_theta: float = 10000.0

    def kind_for(self, attn_layer_idx: int) -> str:
        return self.pattern[attn_layer_idx % len(self.pattern)]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    period: int = 1          # MoE FF on layers with (idx % period == period-1)
    shared_expert: bool = False  # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k probs to sum to 1


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default: ceil(d_model / 16)
    chunk: int = 256               # chunked-scan block length

    def rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64       # rank of the data-dependent decay LoRA (w)
    mix_lora: int = 32         # rank of the token-shift mix LoRA (x)
    gate_lora: int = 128


@dataclass(frozen=True)
class LoRAConfig:
    """Paper default: LoRA on W_Q and W_V with r=32 (Atleus SS V.A)."""

    rank: int = 32
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("wq", "wv")
    dropout: float = 0.0


@dataclass(frozen=True)
class QuantConfig:
    """Crossbar-wise quantization (Atleus SS IV.D). ``MnFm``: n bits for the
    MHA (attention projection) weights, m bits for the FF weights. Block size
    128x128 == the ReRAM crossbar geometry == the MXU tile."""

    mha_bits: int = 16        # 16 == not quantized
    ff_bits: int = 16
    block: int = 128

    @property
    def tag(self) -> str:
        return f"M{self.mha_bits}F{self.ff_bits}"

    @property
    def enabled(self) -> bool:
        return self.mha_bits < 16 or self.ff_bits < 16


# ---------------------------------------------------------------------------
# Main config
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str

    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: Optional[int] = None        # explicit (gemma2/nemo differ from d/H)
    d_ff: int = 3072
    vocab_size: int = 32000

    # per-layer block kinds, cycled: ("attn",), ("rwkv",), jamba 1:7 etc.
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp: str = "gated_silu"               # gated_silu | gated_gelu | gelu
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "tokens"              # tokens | embeddings (audio/vlm stub)
    max_seq_len: int = 131072
    emb_scale: bool = False               # gemma-style sqrt(d) embed scaling
    final_logit_softcap: Optional[float] = None

    lora: LoRAConfig = field(default_factory=LoRAConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % self.period]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.n_layers))

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.period == self.moe.period - 1

    def attn_layer_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layer_kinds()) if k == "attn")

    def attn_kind(self, layer_idx: int) -> str:
        """full|sliding for a given *global* layer index (must be attn)."""
        attn_idxs = self.attn_layer_indices()
        return self.attn.kind_for(attn_idxs.index(layer_idx))

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does unbounded full attention (long_500k eligible)
        or the arch is SSM/hybrid (per the brief: run long_500k for
        SSM/hybrid/linear-attn; sliding-window is O(w))."""
        if self.family in ("ssm", "hybrid"):
            return True
        kinds = [self.attn.kind_for(i) for i in range(len(self.attn_layer_indices()))]
        if not kinds:
            return True
        if all(k == "sliding" for k in kinds):
            return True
        # local/global alternation (gemma2): not *pure* full attention
        return "sliding" in kinds

    # ----- parameter counting (for 6ND MODEL_FLOPS & memory budgeting) -----
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.hd
        total = 0
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif kind == "mamba":
                mc = self.mamba
                d_in = mc.expand * d
                r = mc.rank(d)
                total += d * 2 * d_in            # in_proj (x and z)
                total += d_in * (r + 2 * mc.d_state)  # x_proj
                total += r * d_in                # dt_proj
                total += mc.d_conv * d_in        # conv1d (depthwise)
                total += d_in * mc.d_state       # A_log
                total += d_in                    # D
                total += d_in * d                # out_proj
            elif kind == "rwkv":
                rc = self.rwkv
                total += 5 * d * d               # r,k,v,g(out-approx),o  time-mix
                total += d * rc.decay_lora * 2   # decay lora
                total += 2 * d * ff              # channel mix (k, v) rwkv ffn
                continue                         # rwkv has no separate FF block
            n_mat = 3 if self.mlp.startswith("gated") else 2
            if kind != "rwkv":
                if self.is_moe_layer(i):
                    total += self.moe.n_experts * n_mat * d * ff
                    if self.moe.shared_expert:
                        total += n_mat * d * ff
                    total += d * self.moe.n_experts  # router
                    if active_only:
                        total -= (self.moe.n_experts - self.moe.top_k) * n_mat * d * ff
                else:
                    total += n_mat * d * ff
        return total

    def lora_param_count(self) -> int:
        """Trainable LoRA params (the only trainable params in PEFT mode)."""
        r = self.lora.rank
        d = self.d_model
        dims = {"wq": (d, self.q_dim), "wk": (d, self.kv_dim),
                "wv": (d, self.kv_dim), "wo": (self.q_dim, d),
                "w1": (d, self.d_ff), "w2": (self.d_ff, d), "w3": (d, self.d_ff)}
        n_attn = len(self.attn_layer_indices())
        total = 0
        for t in self.lora.targets:
            din, dout = dims[t]
            n = n_attn if t in ("wq", "wk", "wv", "wo") else self.n_layers
            total += n * r * (din + dout)
        return total

    def validate(self) -> "ModelConfig":
        assert self.family in FAMILIES, self.family
        assert self.n_heads % self.n_kv_heads == 0
        assert self.n_layers % self.period == 0
        if self.moe is not None:
            assert any(self.is_moe_layer(i) for i in range(self.n_layers))
        if "mamba" in self.block_pattern:
            assert self.mamba is not None
        if "rwkv" in self.block_pattern:
            assert self.rwkv is not None
        for k in self.attn.pattern:
            assert k in ("full", "sliding"), k
        if "sliding" in self.attn.pattern:
            assert self.attn.window is not None
        return self


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig, *, n_periods: int = 2, d_model: int = 64,
                  n_heads: int = 4, d_ff: int = 128, vocab: int = 257,
                  window: int = 8) -> ModelConfig:
    """Shrink a config to smoke-test size while preserving its *structure*
    (block pattern, MoE period, attention alternation, norm/mlp kinds)."""
    kv = max(1, n_heads // max(1, cfg.n_heads // cfg.n_kv_heads))
    new = replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=cfg.period * n_periods,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=d_ff,
        vocab_size=vocab,
        max_seq_len=4096,
        attn=replace(cfg.attn, window=(window if cfg.attn.window else None)),
        lora=replace(cfg.lora, rank=4, alpha=4.0),
    )
    if cfg.moe is not None:
        new = replace(new, moe=replace(cfg.moe, n_experts=4,
                                       top_k=min(cfg.moe.top_k, 2)))
    if cfg.mamba is not None:
        new = replace(new, mamba=replace(cfg.mamba, d_state=4, d_conv=4,
                                         dt_rank=8, chunk=16))
    if cfg.rwkv is not None:
        new = replace(new, rwkv=replace(cfg.rwkv, head_dim=16, decay_lora=8,
                                        mix_lora=4, gate_lora=8))
    return new.validate()
