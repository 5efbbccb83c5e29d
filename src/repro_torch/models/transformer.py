"""Config-driven decoder: embeds -> loop over period-blocks -> norm -> head
(PyTorch port of ``repro.models.transformer`` for full-attention and RWKV
models).

The JAX package scans over stacked scan periods with ``lax.scan``; the port
runs the same layout as a Python loop, slicing one period's weights, LoRA
leaves and cache views out of the stacked tensors. MoE and Mamba blocks
wait for ROADMAP Queue 1 items 12-13.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.lora import layer_slice, scan_period
from repro_torch.core.noise import NoiseConfig
from repro_torch.kernels.crossbar_matmul import ops as cb_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention, layers, rwkv
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
    and every forward kernel of a period launches twice."""

    attn_impl: str = "auto"
    act_dtype: Any = torch.float32
    rwkv_impl: str = "auto"
    noise: NoiseConfig = field(default_factory=NoiseConfig)
    remat: bool = False


def _check_supported(cfg: ModelConfig) -> None:
    for pos in range(scan_period(cfg)):
        if cfg.block_kind(pos) not in ("attn", "rwkv"):
            raise NotImplementedError(
                f"{cfg.block_kind(pos)!r} blocks are not ported yet (ROADMAP "
                "Queue 1 item 13)")
        if cfg.is_moe_layer(pos):
            raise NotImplementedError("MoE layers are not ported yet "
                                      "(ROADMAP Queue 1 item 12)")
    if cfg.frontend != "tokens":
        raise NotImplementedError("embedding frontends are not ported yet "
                                  "(ROADMAP Queue 1 item 19)")


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
    p = scan_period(cfg)
    n_sp = cfg.n_layers // p
    kw = dict(device=device, dtype=dtype)
    layer_trees = []
    for pos in range(p):
        if cfg.block_kind(pos) == "rwkv":
            layer_trees.append(rwkv.init_rwkv(cfg, generator, lead=(n_sp,),
                                              **kw))
            continue
        layer_trees.append({
            "norm": layers.init_norm(cfg, lead=(n_sp,), **kw),
            "norm2": layers.init_norm(cfg, lead=(n_sp,), **kw),
            "attn": attention.init_attn(cfg, generator, lead=(n_sp,), **kw),
            "ff": layers.init_mlp(cfg, generator, lead=(n_sp,), **kw),
        })
    return {
        "embed": layers.init_embed(cfg, generator, **kw),
        "final_norm": layers.init_norm(cfg, **kw),
        "layers": tuple(layer_trees),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _apply_position(cfg: ModelConfig, ec: ExecConfig, pos: int,
                    x: torch.Tensor, pparams, plora, pcache, positions, mode,
                    prefill_cache_len, adapter_idx, paged, chunk_lens, rng):
    noise = ec.noise if (ec.noise.enabled and mode == "train") else None
    if cfg.block_kind(pos) == "rwkv":
        x, newc = rwkv.apply_rwkv_block(
            cfg, pparams, x, cache=pcache, lora=plora,
            adapter_idx=adapter_idx, impl=ec.rwkv_impl, chunk_lens=chunk_lens,
            noise=noise, rng=rng)
        return x, (None if mode == "train" else newc)
    h = layers.apply_norm(cfg, pparams["norm"], x)
    delta, newc = attention.apply_attention_block(
        cfg, pparams["attn"], h, positions, kind=cfg.attn_kind(pos),
        mode=mode, cache=pcache, prefill_cache_len=prefill_cache_len,
        lora=plora, adapter_idx=adapter_idx, impl=ec.attn_impl, paged=paged,
        chunk_lens=chunk_lens if mode == "prefill" else None, noise=noise,
        rng=rng)
    x = x + delta
    h2 = layers.apply_norm(cfg, pparams["norm2"], x)
    x = x + layers.apply_mlp(cfg, pparams["ff"], h2, noise=noise, rng=rng)
    return x, newc


def _remat_period(cfg: ModelConfig, ec: ExecConfig, sp: int,
                  x: torch.Tensor, params: Dict, lora: Optional[Dict],
                  positions, adapter_idx, chunk_lens,
                  rng: Optional[torch.Generator]) -> torch.Tensor:
    """Scan period ``sp`` of a train-mode forward under
    ``torch.utils.checkpoint``: nothing inside it is kept for the backward,
    which runs it again (the JAX package's ``jax.checkpoint`` of its scan
    body with ``nothing_saveable``). The whole period reruns (no early
    stop), so every forward kernel of it launches twice. Weight noise
    draws from ``rng``, whose state checkpointing does not keep: the rerun
    starts ``rng`` from the state the period started from, and gives back
    the state it found, so it draws the same noise and leaves ``rng`` as
    the rest of the step expects it."""
    start = rng.get_state() if rng is not None else None
    ran = []

    def period(x):
        rerun = bool(ran) and rng is not None
        ran.append(True)
        if rerun:
            found = rng.get_state()
            rng.set_state(start)
        try:
            for pos in range(scan_period(cfg)):
                plora = (layer_slice(lora["layers"][pos], sp)
                         if lora is not None else None)
                x, _ = _apply_position(
                    cfg, ec, pos, x, layer_slice(params["layers"][pos], sp),
                    plora, None, positions, "train", None, adapter_idx, None,
                    chunk_lens, rng)
        finally:
            if rerun:
                rng.set_state(found)
        return x

    # the model draws no random numbers but from ``rng``
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        return torch.utils.checkpoint.checkpoint(
            period, x, use_reentrant=False, preserve_rng_state=False)


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

    inputs: {"tokens": (B,T) int}. positions: (B,T) global token positions
    (default: arange, or the dense cache's length in decode). mode:
    "train" (no cache), "prefill" (emit a dense cache of
    ``prefill_cache_len``; RWKV state starts from zero), "decode" (update
    ``cache`` in place and return it: K/V are appended, lengths advance and
    RWKV state is overwritten; with ``paged`` the attention cache is the
    page pool, see ``attention.apply_attention_block``, and RWKV state is
    per slot row). ``last_idx`` (B,) keeps one row
    per sequence before the final norm and the unembed, so logits are
    (B,1,V): a serving step samples only that row. ``aux`` is empty: it
    carries MoE statistics in the JAX package, and MoE is not ported yet.
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

    x = layers.embed_tokens(cfg, params["embed"], inputs["tokens"],
                            ec.act_dtype)
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    if positions is None:
        ar = torch.arange(T, device=dev, dtype=torch.int32)[None]
        cur = cache_len(cache) if (mode == "decode" and cache is not None
                                   and paged is None) else None
        positions = (cur[:, None] + ar if cur is not None
                     else ar.expand(B, T))

    new_layers = [[] for _ in range(P)]
    for sp in range(n_sp):
        if remat:
            x = _remat_period(cfg, ec, sp, x, params, lora, positions,
                              adapter_idx, chunk_lens, rng)
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
            x, newc = _apply_position(cfg, ec, pos, x, pparams, plora, pcache,
                                      positions, mode, prefill_cache_len,
                                      adapter_idx, paged, chunk_lens, rng)
            new_layers[pos].append(newc)

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
    return logits, new_cache, {}


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
                       kv_lens) -> None:
    """Size the kernels' split workspaces on ``device`` for every
    decode-mode ``forward`` over ``rows`` rows with a chunk of each width
    in ``chunks``: the crossbar matmul of every quantized weight at M =
    rows * C (and at M = rows, the head's under ``last_idx``), and the
    flash kernel of the attention layers over each key length in
    ``kv_lens`` (a paged step's block-table widths times the page size, or
    a dense cache's length). A CUDA graph captured afterwards finds them
    large enough (``kernels.workspace``)."""
    weights = list(_quantized(params))
    if weights:
        cb_ops.reserve_workspace(device, weights,
                                 sorted({rows} | {rows * C for C in chunks}))
    attn = any(cfg.block_kind(pos) == "attn" for pos in range(scan_period(cfg)))
    if attn and exec_cfg.attn_impl == "auto":
        fa_ops.reserve_workspace(
            device, [(rows, C, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd)
                     for C in chunks for S in kv_lens])


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
