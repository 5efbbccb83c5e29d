"""End-to-end latency/energy baselines (paper Figs. 11, 12, 14, 15):
Atleus vs HAIMA vs 3D-TPU vs GPU (V100), plus quantization trendlines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.perfmodel import atleus as hw, pipeline as pipe
from repro_torch.perfmodel.atleus import TransformerDims

# V100 [paper SSV.F: <50% utilization for fine-tuning]
GPU_PEAK = 125e12
GPU_UTIL_FT = 0.028   # small-batch FT FLOP efficiency [cal to Fig.11]
GPU_W = 120.0   # V100 draw at few-% utilization [cal]
GPU_DEQ_OVERHEAD = 0.30     # runtime overhead per quantized matmul
# 3D-TPU: 4 tiers x (2x2) cores of 128x128 @ SYS_CLOCK, same SRAM [SSV.A]
TPU3D_CORES = 16
TPU3D_PEAK = TPU3D_CORES * 128 * 128 * 2 * hw.SYS_CLOCK
TPU3D_UTIL = 0.0167         # "~2x faster than GPU" [SSV.F]
TPU3D_W = 160.0
ATLEUS_W = (48 * hw.TILES_PER_CORE * hw.RERAM_TILE_W / 3    # active tier mix
            + hw.SYS_CORES * hw.SYS_CORE_W)


def _layer_flops(d: TransformerDims, fine_tuning: bool) -> float:
    return 2.0 * (hw.mm_reram_ops(d) + hw.mm_systolic_ops(d, fine_tuning))


def atleus_time_energy(d: TransformerDims, *, n_batches: int = 1,
                       fine_tuning: bool = True, mha_bits: int = 16,
                       ff_bits: int = 16) -> Dict[str, float]:
    st = pipe.atleus_stages(d, fine_tuning=fine_tuning, mha_bits=mha_bits,
                            ff_bits=ff_bits)
    bwd = 2.2 if fine_tuning else 1.0   # backward through frozen base
    t = bwd * pipe.end_to_end_time(st, d.n_layers, n_batches)
    e_layer = pipe.atleus_layer_energy(d, mha_bits=mha_bits, ff_bits=ff_bits,
                                       fine_tuning=fine_tuning)
    # quantized weights use proportionally fewer cells -> pro-rated energy;
    # the extra dequant S&A stage costs ~1.5% power (SS IV.D)
    scale_mha = (mha_bits / 16.0) * 1.015 if mha_bits < 16 else 1.0
    scale_ff = (ff_bits / 16.0) * 1.015 if ff_bits < 16 else 1.0
    e_reram = e_layer["reram"] * (0.33 * scale_mha + 0.67 * scale_ff)
    e = bwd * d.n_layers * n_batches * (e_reram + e_layer["systolic"])
    e += hw.hbm_energy(2.0 * d.lora_k * d.d_model * d.lora_r * 4 * n_batches)
    return {"time": t, "energy": e + ATLEUS_W * 0.1 * t}  # +NoC/static


def haima_time_energy(d: TransformerDims, *, n_batches: int = 1,
                      fine_tuning: bool = True, quant_bits: int = 16
                      ) -> Dict[str, float]:
    st = pipe.haima_stages(d, fine_tuning=fine_tuning, quant_bits=quant_bits)
    bwd = 2.2 if fine_tuning else 1.0
    # HBM multiplexing prevents layer-level pipelining (SS V.F)
    t = bwd * sum(st.total(s) for s in st.compute) * d.n_layers * n_batches
    flops = _layer_flops(d, fine_tuning) * d.n_layers * n_batches * bwd
    e = hw.hbm_energy(flops / 4.0) + 60.0 * t   # PIM ~HBM-access-bound
    if quant_bits < 16:
        e *= 1.0 + 0.15                          # dequant in DRAM adds energy
    return {"time": t, "energy": e}


def gpu_time_energy(d: TransformerDims, *, n_batches: int = 1,
                    fine_tuning: bool = True, quant_bits: int = 16
                    ) -> Dict[str, float]:
    bwd = 3.0 if fine_tuning else 1.0
    flops = _layer_flops(d, fine_tuning) * d.n_layers * n_batches * bwd
    t = flops / (GPU_PEAK * GPU_UTIL_FT)
    if quant_bits < 16:
        t *= 1.0 + GPU_DEQ_OVERHEAD              # dequantize-then-compute
    return {"time": t, "energy": GPU_W * t}


def tpu3d_time_energy(d: TransformerDims, *, n_batches: int = 1,
                      fine_tuning: bool = True, quant_bits: int = 16
                      ) -> Dict[str, float]:
    bwd = 3.0 if fine_tuning else 1.0
    flops = _layer_flops(d, fine_tuning) * d.n_layers * n_batches * bwd
    t = flops / (TPU3D_PEAK * TPU3D_UTIL)
    if quant_bits < 16:
        t *= 1.0 + 0.2
    return {"time": t, "energy": TPU3D_W * t}


BASELINES = {"atleus": atleus_time_energy, "haima": haima_time_energy,
             "3d-tpu": tpu3d_time_energy, "gpu": gpu_time_energy}


def quant_energy_trend(d: TransformerDims, configs=None) -> Dict[str, Dict[str, float]]:
    """Figs. 12/14: energy per MnFm config normalized to 16-bit, per system."""
    configs = configs or {"M16F16": (16, 16), "M8F8": (8, 8),
                          "M8F4": (8, 4), "M4F8": (4, 8), "M4F4": (4, 4)}
    out: Dict[str, Dict[str, float]] = {}
    base_at = atleus_time_energy(d)["energy"]
    base_gpu = gpu_time_energy(d)["energy"]
    base_tpu = tpu3d_time_energy(d)["energy"]
    base_hai = haima_time_energy(d)["energy"]
    for tag, (mb, fb) in configs.items():
        qb = min(mb, fb)
        out[tag] = {
            "atleus": atleus_time_energy(d, mha_bits=mb, ff_bits=fb)["energy"] / base_at,
            "gpu": gpu_time_energy(d, quant_bits=qb)["energy"] / base_gpu,
            "3d-tpu": tpu3d_time_energy(d, quant_bits=qb)["energy"] / base_tpu,
            "haima": haima_time_energy(d, quant_bits=qb)["energy"] / base_hai,
        }
    return out
