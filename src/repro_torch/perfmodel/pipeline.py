"""Intra-layer 4-stage pipeline model (paper SS IV.A, SS V.F / Fig. 10)
and the HAIMA baseline's stage delays.

Atleus stages (resources 3:1 ReRAM:systolic, SS V.A):
  S1  MHA pre-trained projections (W_Q/K/V + W_O)    -> 16 ReRAM cores
  S2  Q.K^T, fused softmax, P.V, LoRA A/B            -> 16 systolic cores
  S3  FF-1 (d -> 4d)                                 -> 16 ReRAM cores
  S4  FF-2 (4d -> d)                                 -> 16 ReRAM cores

HAIMA (DAC'23): SRAM units for dynamic ops, DRAM(HBM)-PIM for the large
weight matmuls, a *host* for softmax over a shared 2.5D interposer —
many-to-one traffic + HBM bank-parallelism limits are what Fig. 10 shows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.perfmodel import atleus as hw
from repro_torch.perfmodel.atleus import TransformerDims

RERAM_CORES_PER_STAGE = 16
SYS_CORES_S2 = 16
NOC_BW = 64e9            # B/s per vertical/skip link group [cal]
INTERPOSER_BW = 32e9     # HAIMA shared interposer to host [cal]
HBM_BANK_PAR = 4         # HAIMA: concurrent HBM compute banks [58]
HOST_SOFTMAX_FLOPS = 2e12


@dataclass
class StageDelays:
    compute: Dict[str, float]
    comm: Dict[str, float]

    def total(self, s: str) -> float:
        return self.compute[s] + self.comm[s]

    @property
    def bottleneck(self) -> float:
        return max(self.total(s) for s in self.compute)


def atleus_stages(d: TransformerDims, *, fine_tuning: bool = True,
                  mha_bits: int = 16, ff_bits: int = 16) -> StageDelays:
    n, dm, ff = d.n, d.d_model, d.ff
    act = 2  # bf16 activation bytes
    dequant = mha_bits < 16 or ff_bits < 16

    s1 = hw.reram_matmul_time(dm, 4 * dm, n, weight_bits=mha_bits,
                              cores=RERAM_CORES_PER_STAGE,
                              layers_resident=d.n_layers, dequant=dequant)
    # S2: scores (n x dm x n) + PV (n x n x dm) + softmax + LoRA fwd/bwd
    t_sc = hw.systolic_matmul_time(n, dm, n, cores=SYS_CORES_S2)
    t_pv = hw.systolic_matmul_time(n, n, dm, cores=SYS_CORES_S2)
    t_sm = hw.softmax_time(n, n)
    t_lora = 0.0
    if fine_tuning:
        for _ in range(d.lora_k):
            t_lora += 2 * (hw.systolic_matmul_time(n, dm, d.lora_r,
                                                   cores=SYS_CORES_S2)
                           + hw.systolic_matmul_time(n, d.lora_r, dm,
                                                     cores=SYS_CORES_S2))
    s2 = t_sc + t_pv + t_sm + t_lora
    s3 = hw.reram_matmul_time(dm, ff, n, weight_bits=ff_bits,
                              cores=RERAM_CORES_PER_STAGE,
                              layers_resident=d.n_layers, dequant=dequant)
    s4 = hw.reram_matmul_time(ff, dm, n, weight_bits=ff_bits,
                              cores=RERAM_CORES_PER_STAGE,
                              layers_resident=d.n_layers, dequant=dequant)

    # comm: activations hop between stages over TSV/skip links (1-2 hops)
    c_act = n * dm * act / NOC_BW
    c_kv = 3 * n * dm * act / NOC_BW          # Q,K,V to systolic
    c_ff = n * ff * act / NOC_BW
    return StageDelays(
        compute={"S1": s1, "S2": s2, "S3": s3, "S4": s4},
        comm={"S1": c_act, "S2": c_kv, "S3": c_act, "S4": c_ff})


def haima_stages(d: TransformerDims, *, fine_tuning: bool = True,
                 quant_bits: int = 16) -> StageDelays:
    n, dm, ff = d.n, d.d_model, d.ff
    act = 2
    dequant_pre = 1.3 if quant_bits < 16 else 1.0  # dequant before compute

    # HBM-PIM matmuls: Newton-class AiM, bank-parallelism-limited [58]
    hbm_eff = 2.0e12
    s1 = dequant_pre * (2.0 * n * dm * 4 * dm) / hbm_eff
    # S2: K,Q on HBM, V on SRAM; scores shipped to the host for softmax
    t_sc = (2.0 * n * dm * n) / hbm_eff
    t_sm = 3.0 * n * n / HOST_SOFTMAX_FLOPS
    t_lora = 0.0
    if fine_tuning:
        t_lora = sum(2 * (2.0 * n * dm * d.lora_r + 2.0 * n * d.lora_r * dm)
                     for _ in range(d.lora_k)) / hbm_eff
    s2 = t_sc + t_sm + t_lora
    s3 = dequant_pre * (2.0 * n * dm * ff) / hbm_eff
    s4 = dequant_pre * (2.0 * n * ff * dm) / hbm_eff

    # comm: many-to-one over the shared interposer (host + SRAM exchange)
    c1 = 3 * n * dm * act / INTERPOSER_BW
    c2 = 2 * (n * n * 2 + n * dm) * act / INTERPOSER_BW  # scores out+back
    c3 = n * dm * act / INTERPOSER_BW
    c4 = n * ff * act / INTERPOSER_BW
    return StageDelays(
        compute={"S1": s1, "S2": s2, "S3": s3, "S4": s4},
        comm={"S1": c1, "S2": c2, "S3": c3, "S4": c4})


def end_to_end_time(stages: StageDelays, n_layers: int, n_batches: int
                    ) -> float:
    """Pipelined execution: fill (4 stages x layers) + steady state."""
    fill = sum(stages.total(s) for s in stages.compute)
    return fill * 1 + stages.bottleneck * max(0, n_layers * n_batches - 1)


def atleus_layer_energy(d: TransformerDims, *, mha_bits=16, ff_bits=16,
                        fine_tuning=True) -> Dict[str, float]:
    n, dm, ff = d.n, d.d_model, d.ff
    e_reram = (hw.reram_matmul_energy(dm, 4 * dm, n, weight_bits=mha_bits)
               + hw.reram_matmul_energy(dm, ff, n, weight_bits=ff_bits)
               + hw.reram_matmul_energy(ff, dm, n, weight_bits=ff_bits))
    e_sys = (hw.systolic_matmul_energy(n, dm, n)
             + hw.systolic_matmul_energy(n, n, dm))
    if fine_tuning:
        e_sys += sum(2 * (hw.systolic_matmul_energy(n, dm, d.lora_r)
                          + hw.systolic_matmul_energy(n, d.lora_r, dm))
                     for _ in range(d.lora_k))
    return {"reram": e_reram, "systolic": e_sys}
