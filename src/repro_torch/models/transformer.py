"""Config-driven decoder: embeds -> loop over period-blocks -> norm -> head
(PyTorch port of ``repro.models.transformer`` for full- and
sliding-window-attention and RWKV blocks, each with a dense or a
mixture-of-experts FF, from tokens or from precomputed embeddings).

The JAX package scans over stacked scan periods with ``lax.scan``; the port
runs the same layout as a Python loop, slicing one period's weights, LoRA
leaves and cache views out of the stacked tensors. Mamba blocks wait for
ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, QuantConfig
from repro_torch.core import quant
from repro_torch.core.lora import layer_slice, scan_period, tree_map
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention, layers, moe, rwkv
from repro_torch.models.kvcache import (cache_len, position_cache_spec,
                                        zeros_from_spec)


@dataclass(frozen=True)
class ExecConfig:
    """Runtime execution knobs (orthogonal to the model config).

    ``attn_impl``: "auto" — the flash kernels (CUDA) or their plain
    versions (CPU); "ref" — ``ref_attention`` over materialized scores.
    ``rwkv_impl``: "auto" — the wkv kernel (CUDA) or its plain version
    (CPU); "ref" — the plain recurrence anywhere. ``noise``: weight noise
    on the frozen projections in train mode (noise-aware fine-tuning; the
    forward then needs a generator). ``remat``: in a train-mode forward
    under grad, each scan period runs under ``torch.utils.checkpoint``,
    its activations recomputed in the backward, as the JAX package
    rematerializes its scanned periods; the gradients are the same bits,
    and every forward kernel of a period launches twice. ``moe_dispatch``
    ("capacity", the training default, or "dropless", which the serving
    engines force), ``capacity_factor`` (None: the config's) and
    ``moe_group_size``: the MoE layers' routing (``models.moe``)."""

    attn_impl: str = "auto"
    act_dtype: Any = torch.float32
    rwkv_impl: str = "auto"
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    remat: bool = False
    capacity_factor: Optional[float] = None
    moe_group_size: Optional[int] = None
    moe_dispatch: str = "capacity"


def _check_supported(cfg: ModelConfig) -> None:
    for pos in range(scan_period(cfg)):
        if cfg.block_kind(pos) not in ("attn", "rwkv"):
            raise NotImplementedError(
                f"{cfg.block_kind(pos)!r} blocks are not ported yet (ROADMAP "
                "Queue 1 item 13)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: DeviceLike = None, dtype=torch.float32) -> Dict:
    """Random weights in the JAX package's layout, drawn from ``generator``
    (which must live on ``device``). Layer leaves are stacked
    (n_scan_periods, ...). The two frameworks' generators differ, so parity
    tests carry the JAX weights across with ``repro_torch.bridge``."""
    _check_supported(cfg)
    device = resolve_device(device)
    kw = dict(device=device, dtype=dtype)
    layer_trees = _init_layers(cfg, generator,
                               cfg.n_layers // scan_period(cfg), **kw)
    return {
        "embed": layers.init_embed(cfg, generator, **kw),
        "final_norm": layers.init_norm(cfg, **kw),
        "layers": layer_trees,
    }


def _init_layers(cfg: ModelConfig, generator: torch.Generator, n_sp: int, *,
                 device, dtype) -> Tuple[Dict, ...]:
    """Each scan-period position's layer tree, leaves stacked (n_sp, ...)."""
    kw = dict(device=device, dtype=dtype)
    layer_trees = []
    for pos in range(scan_period(cfg)):
        if cfg.block_kind(pos) == "rwkv":
            layer_trees.append(rwkv.init_rwkv(cfg, generator, lead=(n_sp,),
                                              **kw))
            continue
        ff = (moe.init_moe(cfg, generator, lead=(n_sp,), **kw)
              if cfg.is_moe_layer(pos)
              else layers.init_mlp(cfg, generator, lead=(n_sp,), **kw))
        layer_trees.append({
            "norm": layers.init_norm(cfg, lead=(n_sp,), **kw),
            "norm2": layers.init_norm(cfg, lead=(n_sp,), **kw),
            "attn": attention.init_attn(cfg, generator, lead=(n_sp,), **kw),
            "ff": ff,
        })
    return tuple(layer_trees)


def init_quantized_params(cfg: ModelConfig, generator: torch.Generator,
                          quant_cfg: QuantConfig, *, device: DeviceLike = None,
                          min_size: int = 1 << 16) -> Dict:
    """Random weights as ``init_params`` gives them, quantized by
    ``quant.quantize_params`` one scan period at a time, so that the f32
    base is never whole on the device (llama4-scout's 24 layers would take
    211 GB in f32). Each period is drawn, quantized and copied into stacked
    codes and scales; the embeddings stay f32. The random stream is not
    ``init_params``' (its leaves are drawn per period, not per leaf), and
    ``min_size`` is judged on one period's leaf."""
    _check_supported(cfg)
    device = resolve_device(device)
    kw = dict(device=device, dtype=torch.float32)
    n_sp = cfg.n_layers // scan_period(cfg)
    stacked = None

    def alloc(leaf):
        if quant.is_quantized(leaf):
            return quant.QuantizedTensor(
                leaf.codes.new_empty((n_sp, *leaf.codes.shape[1:])),
                leaf.scales.new_empty((n_sp, *leaf.scales.shape[1:])),
                leaf.bits, leaf.block, (n_sp, *leaf.orig_shape[1:]))
        return leaf.new_empty((n_sp, *leaf.shape[1:]))

    def put(dst, src, sp):
        if quant.is_quantized(dst):
            dst.codes[sp].copy_(src.codes[0])
            dst.scales[sp].copy_(src.scales[0])
        else:
            dst[sp].copy_(src[0])

    for sp in range(n_sp):
        one = quant.quantize_params(_init_layers(cfg, generator, 1, **kw),
                                    quant_cfg, min_size=min_size)
        if stacked is None:
            stacked = tree_map(alloc, one)
        tree_map(lambda d, s_: put(d, s_, sp), stacked, one)
        del one
    return {"embed": layers.init_embed(cfg, generator, **kw),
            "final_norm": layers.init_norm(cfg, **kw),
            "layers": stacked}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_position(cfg: ModelConfig, ec: ExecConfig, pos: int,
                    x: torch.Tensor, pparams, plora, pcache, positions, mode,
                    prefill_cache_len, adapter_idx, paged, chunk_lens, rng):
    """One layer: (x, its new cache entry, its MoE aux or {})."""
    noise = ec.noise if (ec.noise.enabled and mode == "train") else None
    if cfg.block_kind(pos) == "rwkv":
        x, newc = rwkv.apply_rwkv_block(
            cfg, pparams, x, cache=pcache, lora=plora,
            adapter_idx=adapter_idx, impl=ec.rwkv_impl, chunk_lens=chunk_lens,
            noise=noise, rng=rng)
        return x, (None if mode == "train" else newc), {}
    h = layers.apply_norm(cfg, pparams["norm"], x)
    delta, newc = attention.apply_attention_block(
        cfg, pparams["attn"], h, positions, kind=cfg.attn_kind(pos),
        mode=mode, cache=pcache, prefill_cache_len=prefill_cache_len,
        lora=plora, adapter_idx=adapter_idx, impl=ec.attn_impl, paged=paged,
        chunk_lens=chunk_lens if mode == "prefill" else None, noise=noise,
        rng=rng)
    x = x + delta
    h2 = layers.apply_norm(cfg, pparams["norm2"], x)
    aux = {}
    if cfg.is_moe_layer(pos):
        token_mask = None
        if chunk_lens is not None:
            token_mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                          < chunk_lens[:, None])
        ff_out, aux = moe.apply_moe(
            cfg, pparams["ff"], h2, noise=noise, rng=rng,
            capacity_factor=ec.capacity_factor, group_size=ec.moe_group_size,
            token_mask=token_mask, dispatch=ec.moe_dispatch)
    else:
        ff_out = layers.apply_mlp(cfg, pparams["ff"], h2, noise=noise,
                                  rng=rng)
    return x + ff_out, newc, aux


def _remat_period(cfg: ModelConfig, ec: ExecConfig, sp: int,
                  x: torch.Tensor, params: Dict, lora: Optional[Dict],
                  positions, adapter_idx, chunk_lens,
                  rng: Optional[torch.Generator], stats: List[Dict]
                  ) -> torch.Tensor:
    """Scan period ``sp`` of a train-mode forward under
    ``torch.utils.checkpoint``: nothing inside it is kept for the backward,
    which runs it again (the JAX package's ``jax.checkpoint`` of its scan
    body with ``nothing_saveable``). The whole period reruns (no early
    stop), so every forward kernel of it launches twice. Weight noise
    draws from ``rng``, whose state checkpointing does not keep: the rerun
    starts ``rng`` from the state the period started from, and gives back
    the state it found, so it draws the same noise and leaves ``rng`` as
    the rest of the step expects it. The first run's MoE aux of each layer
    is appended to ``stats``."""
    start = rng.get_state() if rng is not None else None
    ran = []

    def period(x):
        rerun = bool(ran) and rng is not None
        first = not ran
        ran.append(True)
        if rerun:
            found = rng.get_state()
            rng.set_state(start)
        try:
            for pos in range(scan_period(cfg)):
                plora = (layer_slice(lora["layers"][pos], sp)
                         if lora is not None else None)
                x, _, aux = _apply_position(
                    cfg, ec, pos, x, layer_slice(params["layers"][pos], sp),
                    plora, None, positions, "train", None, adapter_idx, None,
                    chunk_lens, rng)
                if aux and first:
                    stats.append(aux)
        finally:
            if rerun:
                rng.set_state(found)
        return x

    # the model draws no random numbers but from ``rng``
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            period, x, use_reentrant=False, preserve_rng_state=False)


def _remat_stats(stats: List[Dict]):
    """(lb_loss, dropped) summed over the MoE aux of a remat period."""
    return (sum(a["lb_loss"] for a in stats),
            sum(a["dropped_tokens"] for a in stats))


def forward(cfg: ModelConfig, params: Dict, inputs: Dict[str, torch.Tensor],
            *, lora: Optional[Dict] = None, cache: Optional[Dict] = None,
            positions: Optional[torch.Tensor] = None, mode: str = "train",
            prefill_cache_len: Optional[int] = None,
            exec_cfg: ExecConfig = ExecConfig(),
            adapter_idx: Optional[torch.Tensor] = None,
            paged: Optional[Dict] = None,
            chunk_lens: Optional[torch.Tensor] = None,
            last_idx: Optional[torch.Tensor] = None,
            rng: Optional[torch.Generator] = None,
            ) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Returns (logits (B,T,V), new_cache, aux).

    inputs: {"tokens": (B,T) int} or {"embeds": (B,T,d)} (the stub
    frontend of musicgen/chameleon: precomputed embeddings, cast to
    ``exec_cfg.act_dtype``). positions: (B,T) global token positions
    (default: arange, or the dense cache's length in decode). mode:
    "train" (no cache), "prefill" (emit a dense cache of
    ``prefill_cache_len``; RWKV state starts from zero), "decode" (update
    ``cache`` in place and return it: K/V are appended, lengths advance and
    RWKV state is overwritten; with ``paged`` the attention cache is the
    page pool, see ``attention.apply_attention_block``, and RWKV state is
    per slot row). ``last_idx`` (B,) keeps one row
    per sequence before the final norm and the unembed, so logits are
    (B,1,V): a serving step samples only that row. ``aux``: "lb_loss" (the
    MoE load-balance loss) and "moe_dropped_tokens" (assignments dropped
    by capacity; 0 under dropless dispatch), each summed over the layers
    (0 without MoE layers).
    ``rng``: the generator that weight noise draws from (train mode with
    ``exec_cfg.noise`` enabled), on the model's device; the JAX package
    threads a key the same way."""
    _check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    ec = exec_cfg
    remat = ec.remat and mode == "train" and torch.is_grad_enabled()
    P = scan_period(cfg)
    n_sp = cfg.n_layers // P

    if "tokens" in inputs:
        x = layers.embed_tokens(cfg, params["embed"], inputs["tokens"],
                                ec.act_dtype)
    else:
        x = inputs["embeds"].to(ec.act_dtype)
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    if positions is None:
        ar = torch.arange(T, device=dev, dtype=torch.int32)[None]
        cur = cache_len(cache) if (mode == "decode" and cache is not None
                                   and paged is None) else None
        positions = (cur[:, None] + ar if cur is not None
                     else ar.expand(B, T))

    new_layers = [[] for _ in range(P)]
    lb_total = torch.zeros((), dtype=torch.float32, device=dev)
    drop_total = torch.zeros((), dtype=torch.float32, device=dev)
    for sp in range(n_sp):
        if remat:
            stats: List[Dict] = []
            x = _remat_period(cfg, ec, sp, x, params, lora, positions,
                              adapter_idx, chunk_lens, rng, stats)
            if stats:
                lb, drop = _remat_stats(stats)
                lb_total, drop_total = lb_total + lb, drop_total + drop
            continue
        for pos in range(P):
            pparams = layer_slice(params["layers"][pos], sp)
            plora = (layer_slice(lora["layers"][pos], sp)
                     if lora is not None else None)
            pcache = None
            if mode == "decode" and cache is not None:
                pcache = layer_slice(cache["layers"][pos], sp)
            elif mode == "prefill" and cfg.block_kind(pos) != "attn":
                # recurrent state must come out of prefill: start at zero
                pcache = zeros_from_spec(
                    position_cache_spec(cfg, pos, B, 1, ec.act_dtype), (), dev)
            x, newc, aux = _apply_position(
                cfg, ec, pos, x, pparams, plora, pcache, positions, mode,
                prefill_cache_len, adapter_idx, paged, chunk_lens, rng)
            new_layers[pos].append(newc)
            if aux:
                lb_total = lb_total + aux["lb_loss"]
                drop_total = drop_total + aux["dropped_tokens"]

    if last_idx is not None:
        rows = torch.arange(B, device=dev)
        x = (x[rows, last_idx][:, None] if last_idx.ndim == 1
             else x[rows[:, None], last_idx])
    x = layers.apply_norm(cfg, params["final_norm"], x)
    logits = layers.unembed(cfg, params["embed"], x)

    new_cache = None
    if mode == "decode":
        # K/V (dense or pool) were written in place into the caller's
        # stacked tensors and come back as views of them; every other leaf
        # (lengths, RWKV state) is a new tensor, copied into its layer here
        for entry, per_sp in zip(cache["layers"], new_layers):
            for sp, newc in enumerate(per_sp):
                for name, leaf in newc.items():
                    dst = entry[name][sp]
                    if leaf.data_ptr() != dst.data_ptr():
                        dst.copy_(leaf)
        new_cache = cache
    elif mode == "prefill":
        new_cache = {"layers": tuple(
            {name: torch.stack([c[name] for c in per_sp])
             for name in per_sp[0]} for per_sp in new_layers)}
    return logits, new_cache, {"lb_loss": lb_total,
                               "moe_dropped_tokens": drop_total}


def _quantized(tree):
    """Every QuantizedTensor leaf of a parameter tree."""
    if quant.is_quantized(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _quantized(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _quantized(v)


def reserve_workspaces(cfg: ModelConfig, params: Dict, exec_cfg: ExecConfig,
                       device: torch.device, *, rows: int, chunks,
                       kv_lens, ring_len: Optional[int] = None) -> None:
    """Size the kernels' split workspaces on ``device`` for every
    decode-mode ``forward`` over ``rows`` rows with a chunk of each width
    in ``chunks``: the crossbar matmul of every quantized weight at M =
    rows * C (and at M = rows, the head's under ``last_idx``), the grouped
    kernel of every quantized expert stack over its routed rows, the flash
    kernel of the attention layers over each key length in ``kv_lens`` (a
    paged step's block-table widths times the page size, or a dense
    cache's length; a dense cache's ring is no longer), and, with
    ``ring_len``, the ring kernel of a paged step's sliding layers over
    ``ring_len + C`` keys. A CUDA graph captured afterwards finds them
    large enough (``kernels.workspace``)."""
    weights = list(_quantized(params))
    # a layer's matrix is stacked (n_sp, K, N), its experts (n_sp, slots,
    # K, N): those go to the grouped kernel over rows * C * k * tpe routed
    # assignments
    mats = [w for w in weights if w.ndim != 4]
    experts = [w.layer(0) for w in weights if w.ndim == 4]
    if mats:
        cb_ops.reserve_workspace(device, mats,
                                 sorted({rows} | {rows * C for C in chunks}))
    if experts:
        k_slots = cfg.moe.top_k * (experts[0].codes.shape[0]
                                   // cfg.moe.n_experts)
        cb_ops.reserve_grouped_workspace(
            device, experts, sorted({rows * C * k_slots for C in chunks}))
    attn = any(cfg.block_kind(pos) == "attn" for pos in range(scan_period(cfg)))
    if attn and exec_cfg.attn_impl == "auto":
        heads = (cfg.n_heads, cfg.n_kv_heads)
        shapes = [(rows, C, *heads, S, cfg.hd)
                  for C in chunks for S in kv_lens]
        if ring_len is not None:
            shapes += [(rows, C, *heads, ring_len + C, cfg.hd)
                       for C in chunks]
        fa_ops.reserve_workspace(device, shapes)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None):
    """Token-mean cross entropy. Returns (loss, {"nll_sum", "tokens"})."""
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    mask = mask.to(torch.float32)
    tot = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum(nll * mask) / tot
    return loss, {"nll_sum": torch.sum(nll * mask), "tokens": tot}
