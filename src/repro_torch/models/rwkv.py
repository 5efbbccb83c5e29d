"""RWKV6 "Finch" block (rwkv6-7b): attention-free time-mix with
data-dependent decay + channel-mix (PyTorch port of ``repro.models.rwkv``).

All projections (r/k/v/g/o, channel-mix k/v) are STATIC-engine frozen
weights and run the crossbar kernel once quantized; the wkv recurrence
(state S in R^{H x N x N} with per-token decay w_t) is DYNAMIC and runs the
hand-written CUDA kernel ``repro_torch.kernels.rwkv6_wkv``, which keeps the
state in registers for the whole chunk.

Recurrence (official Finch form), per head, N = head_dim:
    y_t     = r_t · (S_t + u ⊙ (k_t ⊗ v_t))
    S_{t+1} = diag(w_t) S_t + k_t ⊗ v_t

Training: under grad, ``wkv_scan(impl="auto")`` goes through the wkv
wrapper's autograd Function (``WkvFn``): the forward kernels and the CUDA
backward kernel on the card, the plain recurrence and its plain backward
on the CPU. ``impl="ref"`` runs the plain recurrence under ordinary
autograd anywhere (it keeps every step's state for the backward).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hetero
from repro_torch.core.lora import lora_delta, lora_scale
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import layers

MIX_NAMES = ("r", "w", "k", "v", "g")

# Per-slot decode-state leaves: token-shift buffers hold the previous
# token's activations and the wkv matrix accumulates over the whole
# stream, all indexed by slot row (batch dim). The serving
# ``SlotStateArena`` zeroes them by slot id when a slot is recycled.
SLOT_STATE_LEAVES = ("shift_t", "shift_c", "wkv")


def init_rwkv(cfg: ModelConfig, generator: torch.Generator, *, device, dtype,
              lead=()) -> Dict:
    """The JAX package's rwkv parameter tree, stacked along ``lead``; the
    random leaves are drawn from ``generator`` (on ``device``)."""
    rc = cfg.rwkv
    d = cfg.d_model
    H = d // rc.head_dim
    kw = dict(device=device, dtype=dtype)

    def fixed(t, dt=dtype):
        """A deterministic leaf, repeated along ``lead``."""
        return t.to(dt).expand(*lead, *t.shape).contiguous()

    def normal(shape, std):
        t = torch.randn((*lead, *shape), generator=generator, device=device,
                        dtype=torch.float32)
        return (std * t).to(dtype)

    ratio = torch.arange(d, device=device, dtype=torch.float32) / d
    ones, zeros = torch.ones(d, device=device), torch.zeros(d, device=device)
    mu_x = 1.0 - ratio ** 0.3
    return {
        "ln1": {"scale": fixed(ones), "bias": fixed(zeros)},
        "ln2": {"scale": fixed(ones), "bias": fixed(zeros)},
        "time_mix": {
            "mu": fixed(torch.stack([1.0 - ratio ** (0.3 + 0.1 * i)
                                     for i in range(5)])),
            "mu_x": fixed(mu_x),
            "w_mix_a": layers.dense_init(generator, (*lead, d, 5 * rc.mix_lora),
                                         **kw),
            "w_mix_b": normal((5, rc.mix_lora, d), 0.02),
            "w_base": fixed(-6.0 + 5.0 * ratio, torch.float32),
            "w_lora_a": layers.dense_init(generator, (*lead, d, rc.decay_lora),
                                          **kw),
            "w_lora_b": normal((rc.decay_lora, d), 0.02),
            "u": fixed(0.5 * torch.ones(H, rc.head_dim, device=device),
                       torch.float32),
            **{f"{n}_proj": layers.dense_init(generator, (*lead, d, d),
                                              name=f"{n}_proj", **kw)
               for n in ("r", "k", "v", "g", "o")},
            "ln_x": {"scale": fixed(ones), "bias": fixed(zeros)},
        },
        "channel_mix": {
            "mu_k": fixed(mu_x),
            "mu_r": fixed(mu_x),
            "ck_proj": layers.dense_init(generator, (*lead, d, cfg.d_ff),
                                         name="ck_proj", **kw),
            "cv_proj": layers.dense_init(generator, (*lead, cfg.d_ff, d),
                                         fan_in=cfg.d_ff, name="cv_proj",
                                         **kw),
            "cr_proj": layers.dense_init(generator, (*lead, d, d), **kw),
        },
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """xx_t = x_{t-1}; the first step uses ``prev`` (decode cache) or zeros.
    With T == 1 only the carried row is returned."""
    B, T, d = x.shape
    first = (torch.zeros((B, 1, d), device=x.device, dtype=x.dtype)
             if prev is None else prev[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1, :]], dim=1) if T > 1 else first


def wkv_scan(r, k, v, w, u, s0, *, impl: str = "auto"):
    """The wkv recurrence over a chunk, with the JAX package's FLOP tally.

    r/k/v/w (B, T, H, N) f32; u (H, N); s0 (B, H, N, N). ``impl``: "auto"
    — the CUDA kernel on CUDA tensors, its plain version on the CPU, and
    under grad both through ``WkvFn`` (whose backward is the CUDA backward
    kernel, or its plain version); "ref" — the plain version anywhere,
    under ordinary autograd. Returns y (B, T, H, N), s_final."""
    B, T, H, N = r.shape
    hetero.record_nonlinear(r.numel())
    hetero._record(hetero.DYNAMIC, 4.0 * B * T * H * N ** 2)
    if impl == "ref":
        return wkv_ops.rwkv6_wkv_plain(r, k, v, w, u, s0)
    if impl != "auto":
        raise ValueError(f"rwkv impl {impl!r} (expected 'auto' or 'ref')")
    return wkv_ops.rwkv6_wkv(r, k, v, w, u, s0)


def apply_rwkv_block(
    cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    lora: Optional[Dict] = None, adapter_idx: Optional[torch.Tensor] = None,
    impl: str = "auto", chunk_lens: Optional[torch.Tensor] = None,
    noise: Optional[NoiseConfig] = None, rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full RWKV6 block: x + time_mix(ln1(x)); then + channel_mix(ln2(.)).

    cache: {shift_t (B,d), shift_c (B,d), wkv (B,H,N,N) f32}; the new state
    comes back as new tensors (the caller decides where it lives).

    ``chunk_lens`` (B,) marks ragged chunks: padded steps run the wkv
    recurrence with k=0, w=1 (state unchanged) and the emitted shift
    states come from each row's last *valid* token; a row with an empty
    chunk keeps its incoming shift state. ``noise`` perturbs the frozen
    projections (as the JAX package: r/k/v/g/o and the channel mix) with
    noise drawn from ``rng``."""
    rc = cfg.rwkv
    nk = dict(noise=noise, rng=rng)
    tm = p["time_mix"]
    B, T, d = x.shape
    H, N = d // rc.head_dim, rc.head_dim
    scale = lora_scale(cfg)

    # ---------------- time mix ----------------
    xn = layers.layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], cfg.norm_eps)
    xx = _token_shift(xn, cache["shift_t"] if cache is not None else None)
    diff = xx - xn
    # dynamic token-shift mixing (the "ddd" lora)
    xmix = xn + diff * tm["mu_x"]
    ddd = torch.tanh(hetero.static_matmul(xmix, tm["w_mix_a"]))
    ddd = ddd.reshape(B, T, 5, rc.mix_lora)
    dyn = hetero.dynamic_einsum("btfr,frd->btfd", ddd,
                                tm["w_mix_b"].to(x.dtype))
    mixed = {name: xn + diff * (tm["mu"][i] + dyn[:, :, i, :])
             for i, name in enumerate(MIX_NAMES)}

    def proj(name, target):
        y = hetero.static_matmul(mixed[name], tm[f"{name}_proj"], **nk)
        if lora is not None and target in lora:
            y = y + lora_delta(mixed[name], lora[target], scale, adapter_idx)
        return y

    f32 = torch.float32
    r = proj("r", "wq").reshape(B, T, H, N).to(f32)
    k = proj("k", "wk").reshape(B, T, H, N).to(f32)
    v = proj("v", "wv").reshape(B, T, H, N).to(f32)
    g = torch.nn.functional.silu(hetero.static_matmul(mixed["g"], tm["g_proj"],
                                                      **nk))

    # data-dependent decay w_t in (0, 1), in f32 from the f32 w_base
    w_raw = tm["w_base"] + hetero.dynamic_matmul(
        torch.tanh(hetero.static_matmul(mixed["w"], tm["w_lora_a"])),
        tm["w_lora_b"].to(x.dtype)).to(f32)
    w = torch.exp(-torch.exp(w_raw)).reshape(B, T, H, N)
    hetero.record_nonlinear(w.numel() * 2)

    if chunk_lens is not None:
        # padded steps: k=0, w=1 -> wkv state passes through unchanged
        valid = (torch.arange(T, device=x.device)[None, :]
                 < chunk_lens[:, None])[..., None, None]
        k = torch.where(valid, k, torch.zeros((), device=x.device, dtype=f32))
        w = torch.where(valid, w, torch.ones((), device=x.device, dtype=f32))

    s0 = (cache["wkv"].to(f32) if cache is not None
          else torch.zeros((B, H, N, N), device=x.device, dtype=f32))
    y, s_fin = wkv_scan(r, k, v, w, tm["u"], s0, impl=impl)

    # per-head group norm (population variance), gate, output proj
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yf = (y - mu) * torch.rsqrt(var + 64e-5)
    yf = yf.reshape(B, T, d) * tm["ln_x"]["scale"] + tm["ln_x"]["bias"]
    hetero.record_nonlinear(yf.numel())
    gated = yf.to(x.dtype) * g
    att = hetero.static_matmul(gated, tm["o_proj"], **nk)
    if lora is not None and "wo" in lora:
        att = att + lora_delta(gated, lora["wo"], scale, adapter_idx)
    x = x + att

    # ---------------- channel mix ----------------
    cm = p["channel_mix"]
    xn2 = layers.layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"],
                            cfg.norm_eps)
    xx2 = _token_shift(xn2, cache["shift_c"] if cache is not None else None)
    xk = xn2 + (xx2 - xn2) * cm["mu_k"]
    xr = xn2 + (xx2 - xn2) * cm["mu_r"]
    kf = hetero.static_matmul(xk, cm["ck_proj"], **nk)
    kf = torch.square(torch.relu(kf))
    hetero.record_nonlinear(kf.numel())
    vf = hetero.static_matmul(kf, cm["cv_proj"], **nk)
    rg = torch.sigmoid(hetero.static_matmul(xr, cm["cr_proj"], **nk))
    x = x + rg * vf

    new_cache = None
    if cache is not None:
        if chunk_lens is None:
            shift_t, shift_c = xn[:, -1, :], xn2[:, -1, :]
        else:
            rows = torch.arange(B, device=x.device)
            last = torch.clamp(chunk_lens.long() - 1, 0, T - 1)
            # rows with an empty chunk keep their incoming shift state
            alive = (chunk_lens > 0)[:, None]
            shift_t = torch.where(alive, xn[rows, last],
                                  cache["shift_t"].to(xn.dtype))
            shift_c = torch.where(alive, xn2[rows, last],
                                  cache["shift_c"].to(xn2.dtype))
        new_cache = {"shift_t": shift_t.to(cache["shift_t"].dtype),
                     "shift_c": shift_c.to(cache["shift_c"].dtype),
                     "wkv": s_fin.to(cache["wkv"].dtype)}
    return x, new_cache
