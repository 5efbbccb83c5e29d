"""Analytical Atleus hardware model (paper Table IV + SS IV/V methodology).

The paper's own evaluation is deterministic-simulator-based (SCALE-Sim for
the systolic cores, NeuroSim for ReRAM tile peripherals, BookSim2 for the
NoC). This module rebuilds that deterministic model analytically so every
figure in the paper can be regenerated; constants marked [T4] come straight
from Table IV, constants marked [cal] are calibrated within the ranges the
cited tools report (ISAAC/NeuroSim-class ReRAM timing, HBM2 energy).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# hardware constants
# ---------------------------------------------------------------------------

XBAR = 128                  # crossbar rows/cols [T4]
CELL_BITS = 2               # bits per ReRAM cell [T4]
XBARS_PER_TILE = 96         # [T4]
TILES_PER_CORE = 16         # [T4]
RERAM_CORES = 16 * 3        # 3 ReRAM tiers x 16 cores [T4/SSV.A]
RERAM_TILE_W = 0.345        # W per tile [T4]
RERAM_TILE_AREA = 0.37      # mm^2 [T4]

SYS_ROWS, SYS_COLS = 128, 32    # PEs per systolic core [T4]
SYS_CORES = 16                  # 1 tier x 16 cores [SSV.A]
SYS_CLOCK = 800e6               # [T4]
SYS_CORE_W = 2.13               # W [T4]
SYS_CORE_AREA = 2.55            # mm^2 [T4]

HBM_BW = 256e9                  # B/s [T4]
HBM_PJ_PER_BYTE = 56.0          # ~7 pJ/bit HBM2 access energy [cal]

# ReRAM tile timing [cal: NeuroSim/ISAAC-class]:
#   one analog MVM pass = DAC streaming (1 bit/cycle) + ADC readout shared
#   across columns + shift&add; ~100 ns per 8-bit-input crossbar MVM.
T_XBAR_MVM_8B = 100e-9          # s per crossbar per 8-bit input vector [cal]
T_DEQUANT_STAGE = 10e-9         # extra S&A pipeline stage (SS IV.D) [cal]
E_XBAR_MVM = 2.4e-9             # J per crossbar MVM (incl. ADC) [cal]
E_SYS_MAC = 0.6e-12             # J per systolic MAC @10nm [cal]

NOC_NS_PER_HOP = 2.0            # router+link latency per hop [cal]
NOC_PJ_PER_BYTE_HOP = 1.0      # [cal]
TSV_NS = 0.5                    # vertical hop [T4-derived]


# ---------------------------------------------------------------------------
# workload description (paper Table II kernels)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TransformerDims:
    name: str
    n_layers: int
    d_model: int
    n: int                   # sequence length
    d_ff: Optional[int] = None
    lora_r: int = 32
    lora_k: int = 2          # LoRA on W_Q and W_V [SSV.A]
    weight_bits: int = 16

    @property
    def ff(self) -> int:
        return self.d_ff if self.d_ff else 4 * self.d_model


def mm_reram_ops(d: TransformerDims) -> float:
    """Eq. 2: MM_ReRAM = 12 * d_model^2 * n (per layer, MACs)."""
    return 12.0 * d.d_model * d.d_model * d.n


def mm_systolic_ops(d: TransformerDims, fine_tuning: bool = True) -> float:
    """Eq. 3: d_model*n^2 (MHA-2/3) + 2k*d_model*r*n (LoRA fwd+bwd) +
    3*d_model*n (nonlinear) — per layer, MACs."""
    ops = float(d.d_model) * d.n * d.n
    if fine_tuning:
        ops += 2.0 * d.lora_k * d.d_model * d.lora_r * d.n
    ops += 3.0 * d.d_model * d.n
    return ops


def reram_share(d: TransformerDims, fine_tuning: bool = True) -> float:
    r = mm_reram_ops(d)
    s = mm_systolic_ops(d, fine_tuning)
    return r / (r + s)


# ---------------------------------------------------------------------------
# engine latency/energy models
# ---------------------------------------------------------------------------

def reram_matmul_time(rows: int, cols: int, n_tokens: int, *,
                      weight_bits: int = 16, input_bits: int = 8,
                      cores: int = 1, layers_resident: int = 1,
                      dequant: bool = False) -> float:
    """Streaming n_tokens input vectors through a (rows x cols) weight on
    ReRAM. The pipelined design keeps EVERY layer's weights resident
    (PipeLayer-style, SS IV.A), so one layer's matmul owns
    cores/layers_resident worth of crossbars:

      * if the weight needs more crossbars than its share, passes are
        time-multiplexed (slowdown);
      * if it needs fewer (e.g. after crossbar-wise quantization halves the
        cells per weight), the weight is *duplicated* for token-parallel
        speedup — "reduced resource requirements or faster-pipelined
        execution with weight duplication" (SS IV.D).

    Throughput-pipelined over the xb_rows accumulation depth: time =
    (n_tokens * mux / dup + xb_rows) * t_pass."""
    cells_per_weight = max(1, weight_bits // CELL_BITS)
    xb_rows = math.ceil(rows / XBAR)
    xb_cols = math.ceil(cols * cells_per_weight / XBAR)
    n_xbar = xb_rows * xb_cols
    budget = cores * TILES_PER_CORE * XBARS_PER_TILE / max(layers_resident, 1)
    dup = max(1.0, budget / n_xbar)
    mux = max(1.0, n_xbar / budget)
    t_pass = T_XBAR_MVM_8B * (input_bits / 8.0)
    if dequant:
        t_pass += T_DEQUANT_STAGE
    return (n_tokens * mux / dup + xb_rows) * t_pass


def reram_matmul_energy(rows: int, cols: int, n_tokens: int, *,
                        weight_bits: int = 16) -> float:
    cells_per_weight = max(1, weight_bits // CELL_BITS)
    xb_rows = math.ceil(rows / XBAR)
    xb_cols = math.ceil(cols * cells_per_weight / XBAR)
    return n_tokens * xb_rows * xb_cols * E_XBAR_MVM


def systolic_matmul_time(M: int, K: int, N: int, *, rows: int = SYS_ROWS,
                         cols: int = SYS_COLS, cores: int = 1,
                         dataflow: str = "OS") -> float:
    """SCALE-Sim-style cycle model. OS keeps partial sums stationary: per
    (rows x cols) output tile the array streams K operands plus fill/drain."""
    m_t = math.ceil(M / rows)
    n_t = math.ceil(N / cols)
    if dataflow == "OS":
        cyc_tile = K + rows + cols - 2
    elif dataflow == "WS":
        cyc_tile = M + rows + cols - 2
        m_t = math.ceil(K / rows)   # weights stationary: K mapped on rows
        n_t = math.ceil(N / cols)
    else:  # IS
        cyc_tile = N + rows + cols - 2
        m_t = math.ceil(K / rows)
        n_t = math.ceil(M / cols)
    tiles = max(1, m_t * n_t)
    cycles = math.ceil(tiles / cores) * cyc_tile
    return cycles / SYS_CLOCK


def systolic_matmul_energy(M: int, K: int, N: int) -> float:
    return 2.0 * M * K * N / 2.0 * E_SYS_MAC  # MACs * E/MAC


def systolic_utilization(M: int, K: int, N: int, rows: int, cols: int,
                         cores: int = 16, dataflow: str = "OS") -> float:
    t = systolic_matmul_time(M, K, N, rows=rows, cols=cols, cores=cores,
                             dataflow=dataflow)
    macs = M * K * N
    peak = rows * cols * SYS_CLOCK * cores
    return macs / (t * peak)


def softmax_time(n_rows: int, n_cols: int) -> float:
    """Fused row-wise score+softmax on the systolic core's vector path."""
    return 3.0 * n_rows * n_cols / (SYS_COLS * SYS_ROWS) / SYS_CLOCK


def hbm_time(bytes_moved: float) -> float:
    return bytes_moved / HBM_BW


def hbm_energy(bytes_moved: float) -> float:
    return bytes_moved * HBM_PJ_PER_BYTE * 1e-12
