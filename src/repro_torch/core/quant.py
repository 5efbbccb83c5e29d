"""Crossbar-wise quantization (Atleus SS IV.D), PyTorch port of
``repro.core.quant``.

Frozen weights are quantized independently per 128x128 ReRAM crossbar with
one absmax scale each; the MVM runs on the codes and dequantizes **after**
accumulation. Here the weights live on the card as int8 codes (int4: two
per byte, packed along the second-to-last dim) plus one f32 scale per
block, and the hand-written CUDA ``crossbar_matmul`` kernel applies the
block scale to each K tile's f32 partial sum
(``repro_torch.kernels.crossbar_matmul``).

Blocks are taken over the *last two* dims; leading dims (layer stacking)
are batch dims. Non-multiple-of-128 dims are zero-padded in the codes and
sliced back at dequant. Codes match the JAX package bit for bit: both
round half to even and divide in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

INT_MAX = {8: 127, 4: 7, 2: 1}  # symmetric ranges; 2-bit == the cell resolution


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class QuantizedTensor:
    """Frozen crossbar-quantized weight. ``codes`` is int8 (4-bit values are
    stored two-per-byte as uint8, packed along the second-to-last dim);
    ``scales`` is f32 with one entry per (block x block) crossbar. A
    scan-stacked weight keeps its leading ``n_sp`` dim on codes, scales and
    ``orig_shape``; ``layer(i)`` slices one layer's 2-D weight out."""

    codes: torch.Tensor
    scales: torch.Tensor
    bits: int
    block: int
    orig_shape: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.orig_shape

    @property
    def ndim(self) -> int:
        return len(self.orig_shape)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def layer(self, i: int) -> "QuantizedTensor":
        """The i-th slice along the leading (scan-stacked) dim."""
        return QuantizedTensor(self.codes[i], self.scales[i], self.bits,
                               self.block, tuple(self.orig_shape[1:]))


def quantize(w: torch.Tensor, bits: int, block: int = 128) -> QuantizedTensor:
    """Symmetric absmax quantization per (block, block) crossbar."""
    if bits not in INT_MAX:
        raise ValueError(f"unsupported bit width {bits}")
    if w.ndim < 2:
        raise ValueError(f"quantize needs a matrix, got shape {tuple(w.shape)}")
    orig_shape = tuple(w.shape)
    *lead, di, dj = w.shape
    pi, pj = _ceil_to(di, block), _ceil_to(dj, block)
    w = w.to(torch.float32)
    if (pi, pj) != (di, dj):
        w = torch.nn.functional.pad(w, (0, pj - dj, 0, pi - di))
    nbi, nbj = pi // block, pj // block
    wb = w.reshape(*lead, nbi, block, nbj, block)
    absmax = wb.abs().amax(dim=(-3, -1), keepdim=True)
    qmax = INT_MAX[bits]
    scale = torch.clamp(absmax, min=1e-12) / qmax
    codes = torch.clamp(torch.round(wb / scale), -qmax, qmax).to(torch.int8)
    codes = codes.reshape(*lead, pi, pj)
    scales = scale.squeeze(-1).squeeze(-2).to(torch.float32).contiguous()
    if bits == 4:
        codes = _pack4(codes)
    return QuantizedTensor(codes=codes.contiguous(), scales=scales, bits=bits,
                           block=block, orig_shape=orig_shape)


def _pack4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int4 values two-per-byte along the second-to-last dim."""
    *lead, pi, pj = codes.shape
    assert pi % 2 == 0
    c = codes.reshape(*lead, pi // 2, 2, pj).to(torch.int32)
    lo = c[..., 0, :] & 0xF
    hi = (c[..., 1, :] & 0xF) << 4
    return (lo | hi).to(torch.uint8)


def _unpack4(packed: torch.Tensor) -> torch.Tensor:
    *lead, ph, pj = packed.shape
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    # sign-extend 4-bit two's complement
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-2)  # (*lead, ph, 2, pj)
    return out.reshape(*lead, ph * 2, pj).to(torch.int8)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    codes = _unpack4(qt.codes) if qt.bits == 4 else qt.codes
    *lead, pi, pj = codes.shape
    b = qt.block
    nbi, nbj = pi // b, pj // b
    cb = codes.reshape(*lead, nbi, b, nbj, b).to(torch.float32)
    w = cb * qt.scales[..., :, None, :, None]
    w = w.reshape(*lead, pi, pj)
    di, dj = qt.orig_shape[-2:]
    if (pi, pj) != (di, dj):
        w = w[..., :di, :dj]
    return w.to(dtype)


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


# ---------------------------------------------------------------------------
# MnFm application over a parameter tree
# ---------------------------------------------------------------------------

# weight-name -> quantization class ("mha" | "ff" | None), as in the JAX
# package. Embeddings / norms / LoRA are never quantized.
WEIGHT_CLASS = {
    "wq": "mha", "wk": "mha", "wv": "mha", "wo": "mha",
    "w1": "ff", "w2": "ff", "w3": "ff",
    "router": None,
    "in_proj": "mha", "out_proj": "mha", "x_proj": None, "dt_proj": None,
    "r_proj": "mha", "k_proj": "mha", "v_proj": "mha", "g_proj": "mha",
    "o_proj": "mha",
    "ck_proj": "ff", "cv_proj": "ff",
}


def quantize_slices(w: torch.Tensor, bits: int,
                    block: int = 128) -> QuantizedTensor:
    """``quantize(w, bits, block)``, one (di, dj) matrix along the leading
    dims at a time: the same codes and scales, with the temporaries of one
    matrix (an expert stack's f32 copies would not fit beside the codes)."""
    if w.ndim == 2:
        return quantize(w, bits, block)
    lead = tuple(w.shape[:-2])
    flat = w.reshape(-1, *w.shape[-2:])
    first = quantize(flat[0], bits, block)
    codes = first.codes.new_empty((flat.shape[0], *first.codes.shape))
    scales = first.scales.new_empty((flat.shape[0], *first.scales.shape))
    codes[0], scales[0] = first.codes, first.scales
    for i in range(1, flat.shape[0]):
        q = quantize(flat[i], bits, block)
        codes[i], scales[i] = q.codes, q.scales
    return QuantizedTensor(codes.reshape(*lead, *first.codes.shape),
                           scales.reshape(*lead, *first.scales.shape), bits,
                           block, tuple(w.shape))


def quantize_leaf(key: Optional[str], w, quant_cfg, *,
                  min_size: int = 1 << 16):
    """One leaf under MnFm: a tensor of at least two dims and ``min_size``
    elements whose key is in WEIGHT_CLASS gets its class' bit width (16 =
    left in original precision); anything else comes back as it is."""
    if (not isinstance(w, torch.Tensor) or w.ndim < 2
            or w.numel() < min_size):
        return w
    cls = WEIGHT_CLASS.get(key)
    bits = {"mha": quant_cfg.mha_bits, "ff": quant_cfg.ff_bits,
            None: 16}[cls]
    if bits >= 16:
        return w
    return quantize_slices(w, bits, quant_cfg.block)


def quantize_params(params, quant_cfg, *, min_size: int = 1 << 16):
    """Apply MnFm crossbar-wise quantization to a base parameter tree.

    Walks nested dicts / tuples / lists and quantizes each tensor leaf by
    its innermost dict key (``quantize_leaf``). Quantization runs on the
    leaf's own device."""

    def visit(node, key):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(visit(v, key) for v in node)
        return quantize_leaf(key, node, quant_cfg, min_size=min_size)

    return visit(params, None)


def dequantize_params(params, dtype=torch.float32):
    """Every QuantizedTensor leaf back to a dense tensor (plain reference)."""
    if is_quantized(params):
        return dequantize(params, dtype)
    if isinstance(params, dict):
        return {k: dequantize_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(dequantize_params(v, dtype) for v in params)
    return params
